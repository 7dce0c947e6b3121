#!/usr/bin/env python3
"""chip_smoke.py's ``core_stream`` alone (about 2 minutes on one H100,
with the kernels' build and the witness).

Run from the repo root on a machine with a card: ``python3
tools/core_stream_phases.py``. It builds the kernels, prints the Python,
torch and CUDA versions and the card's name and power limit, runs
``serve_witness`` (the serve phases' Llama-3-8B at SERVE_LAYERS layers in
this process: its tokens for the slice's prompts, its decode tick and
prefill times), then ``core_stream`` on it: a card task stopped with
``cancel(force=True)``, then the StreamingLlama actor's four streams, its
backpressure, close, cancel and deadline arms, each held to the witness
(``chip_smoke.phase_core_stream``). Each phase prints one JSON line; the
script exits non-zero where one fails, and prints the K1 launches the
phase counted in its actor last.
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main() -> int:
    chip_smoke.keep_bytecode()
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("core_stream_phases: no CUDA card", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.perf_counter()
    fa.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg, params, prompts, outs, eng, tick_s, prefill_ms = (
        chip_smoke.phase_serve_witness(dev))
    n = chip_smoke.phase_core_stream(cfg, prompts, outs, tick_s, prefill_ms)
    print(f"core_stream K1 launches {n}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
