#!/usr/bin/env python3
"""chip_smoke.py's ``mpmd_pipe`` alone, and its four-card arm.

Run from the repo root on a machine with a card: ``python3
tools/mpmd_phases.py``. It builds the kernels and prints the card's name
and power limit, then runs the arms asked for, each printing one JSON
line (``chip_smoke.mpmd_run``'s measurements and failures), and exits
non-zero where one fails:

- ``--one-card`` (the default): ``mpmd_pipe`` as chip_smoke.py runs it.
  Llama-3-8B at SERVE_LAYERS (8) layers in bf16, 4 stage processes of 2
  layers on card 0 (``num_gpus=0``, built one after another), 16
  microbatches of (2, 512) tokens, 4 in flight, held bit for bit to the
  same stage functions run in this process on the same seeded params;
- ``--sized-slots``: the one-card arm four times in turns, with the
  default channel slot (128 KiB: a hop's 8 MiB goes through a sidecar
  segment made for it), then with ``RTPU_DAG_SLOT_BYTES`` at 9 MiB (the
  hop in the ring's own, reused slot) twice, then the default again
  (``mpmd_pipe_slot_<bytes>`` lines);
- ``--four-cards``: the same pipeline at full depth, 32 layers, 8 a stage,
  one card a stage (``num_gpus=1``), 32 microbatches, held to the same
  four stage functions run in order on card 0. It needs four visible
  cards on one host and says so, and fails, where fewer are.

Each arm's line has the steady gap between completions (mean, p50) beside
each stage's own step (``stage_ms``: recv, compute, send, and the host
copies' decode and encode, ms a microbatch) and their sum: the overlap
``parallel/mpmd.py`` promises is the gap near the slowest stage, not the
sum. And the meter's busy fractions and bottleneck, the bytes a hop,
each stage's spawn-to-ready seconds, card and peak memory. The lines also
go to ``chiprun_out/mpmd_phases.jsonl``.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# A channel slot that holds one hop of the one-card arm (the 8 MiB bf16
# hidden state and its pickle's frame) in the ring itself.
SIZED_SLOT = 9 * 1024 * 1024


def _line(out_path, phase, out, **extra):
    failures = out.pop("failures")
    rec = {"phase": phase, "ok": not failures, "failures": failures,
           **extra, **out}
    print(json.dumps(rec), flush=True)
    with open(out_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return not failures


def main() -> int:
    chip_smoke.keep_bytecode()
    import torch

    from ray_tpu_torch.models.configs import llama3_8b
    from ray_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("mpmd_phases: no CUDA card", file=sys.stderr)
        return 2
    four = "--four-cards" in sys.argv
    sized = "--sized-slots" in sys.argv
    one = "--one-card" in sys.argv or not (four or sized)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "mpmd_phases.jsonl")
    torch.cuda.set_device(0)
    fa.build()
    card = chip_smoke.card_line()
    print(card, flush=True)
    ok = True
    if one:
        cfg = chip_smoke.serve_cfg()
        params = chip_smoke.SeededParams(cfg)()
        out = chip_smoke.mpmd_run(cfg, params, chip_smoke.MPMD_STAGES,
                                  chip_smoke.MPMD_MICRO, 0,
                                  chip_smoke.MPMD_IN_FLIGHT)
        ok &= _line(out_path, "mpmd_pipe", out, card=card,
                    n_layers=cfg.n_layers)
        del params
        chip_smoke.gc_collect()
    if sized:
        cfg = chip_smoke.serve_cfg()
        params = chip_smoke.SeededParams(cfg)()
        for slot in (None, SIZED_SLOT, SIZED_SLOT, None):
            if slot is None:
                os.environ.pop("RTPU_DAG_SLOT_BYTES", None)
            else:
                os.environ["RTPU_DAG_SLOT_BYTES"] = str(slot)
            out = chip_smoke.mpmd_run(cfg, params, chip_smoke.MPMD_STAGES,
                                      chip_smoke.MPMD_MICRO, 0,
                                      chip_smoke.MPMD_IN_FLIGHT)
            slot_bytes = slot or 128 * 1024
            ok &= _line(out_path, f"mpmd_pipe_slot_{slot_bytes}", out,
                        card=card, n_layers=cfg.n_layers,
                        slot_bytes=slot_bytes)
        os.environ.pop("RTPU_DAG_SLOT_BYTES", None)
        del params
        chip_smoke.gc_collect()
    if four:
        n = torch.cuda.device_count()
        if n < 4:
            rec = {"phase": "mpmd_four_cards", "ok": False,
                   "failures": [f"needs 4 visible cards, this machine "
                                f"has {n}"], "card": card}
            print(json.dumps(rec), flush=True)
            return 1
        cfg = llama3_8b(param_dtype=torch.bfloat16)
        params = chip_smoke.SeededParams(cfg)()
        out = chip_smoke.mpmd_run(cfg, params, 4, 32, 1,
                                  chip_smoke.MPMD_IN_FLIGHT)
        ok &= _line(out_path, "mpmd_four_cards", out, card=card,
                    n_layers=cfg.n_layers, cards=n)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
