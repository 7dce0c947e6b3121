#!/usr/bin/env python3
"""chip_smoke.py's serve phases alone, on the visible cards.

Run from the repo root on a machine with a card: ``python3
tools/serve_phases.py``. It builds the kernels, runs chip_smoke's
``slice`` (the in-process engine on card 0: the witness, and the tick
time) and ``prefill_time``, then ``serve_stream``, ``serve_batch`` and
``serve_disagg`` (Llama-3-8B in bf16 on replica processes, one card a
replica; ``serve_disagg`` needs two cards or more), each printing its
JSON line, and last the replicas' K1 launches. It exits non-zero where a
phase fails.

``--disagg-on-one-card`` rehearses ``serve_disagg`` on a one-card
machine: for that phase this process reads two cards, and the replicas
(which run this file again) take card 0 for either, so the prefill and
decode pools share the card (the cards its line prints are the
controller's).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

ONE_CARD = "--disagg-on-one-card" in sys.argv
if ONE_CARD:
    import torch

    _set_device = torch.cuda.set_device
    torch.cuda.set_device = lambda device: _set_device(0)


def main() -> int:
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fa.build()
    print(chip_smoke.card_line(), flush=True)
    cfg, params, prompts, outs, _, eng, tick_s = chip_smoke.phase_slice(
        device)
    prefill_ms = chip_smoke.phase_prefill_time(cfg, params, prompts, device)
    try:
        launches = chip_smoke.phase_serve_stream(cfg, prompts, outs, tick_s,
                                                 prefill_ms)
        launches += chip_smoke.phase_serve_batch(cfg, params, device)
        count = torch.cuda.device_count
        if ONE_CARD:
            torch.cuda.device_count = lambda: 2
        try:
            launches += chip_smoke.phase_serve_disagg(cfg, prompts, outs,
                                                      prefill_ms)
        finally:
            torch.cuda.device_count = count
    finally:
        serve.shutdown()
    print(json.dumps({"serve_deploy_k1_launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
