#!/usr/bin/env python3
"""chip_smoke.py's serve phases alone, on the visible cards.

Run from the repo root on a machine with a card: ``python3
tools/serve_phases.py``. It builds the kernels, runs chip_smoke's
``serve_witness`` (the in-process engine on card 0 at the serve phases'
depth: the witness, the tick time and the prefill times), then
``serve_stream`` (with ``serve_http``, ``serve_grpc`` and
``serve_trace`` on its replica), ``serve_batch``, ``serve_disagg``,
``serve_multiplex`` and ``serve_autoscale`` (Llama-3-8B in bf16 at
SERVE_LAYERS layers on replica processes, one card a replica; ``serve_disagg`` needs two cards
or more, ``serve_autoscale`` drains a second replica only with two),
each printing its JSON line, and last the replicas' K1 launches. It
exits non-zero where a phase fails.

On a one-card machine, two options rehearse the two-card paths: for the
phase they name this process reads two cards, and the replicas (which
run this file again) take card 0 whatever card they are given, so two
replicas share the card (the cards the phase's line prints are the
controller's):

- ``--disagg-on-one-card``: ``serve_disagg``'s prefill and decode pools;
- ``--autoscale-on-one-card``: ``serve_autoscale``'s second replica, its
  spawn, the streams on both, and the drain.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

DISAGG_ONE_CARD = "--disagg-on-one-card" in sys.argv
AUTOSCALE_ONE_CARD = "--autoscale-on-one-card" in sys.argv
if DISAGG_ONE_CARD or AUTOSCALE_ONE_CARD:
    import torch

    _set_device = torch.cuda.set_device
    torch.cuda.set_device = lambda device: _set_device(0)


def two_cards(phase, one_card, *args):
    """``phase(*args)``, reading two cards where ``one_card`` says so."""
    import torch

    count = torch.cuda.device_count
    if one_card:
        torch.cuda.device_count = lambda: 2
    try:
        return phase(*args)
    finally:
        torch.cuda.device_count = count


def main() -> int:
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fa.build()
    print(chip_smoke.card_line(), flush=True)
    cfg, params, prompts, outs, eng, tick_s, prefill_ms = (
        chip_smoke.phase_serve_witness(device))
    try:
        launches = chip_smoke.phase_serve_stream(cfg, prompts, outs, tick_s,
                                                 prefill_ms, eng)
        launches += chip_smoke.phase_serve_batch(cfg, params, device)
        launches += two_cards(chip_smoke.phase_serve_disagg, DISAGG_ONE_CARD,
                              cfg, prompts, outs, prefill_ms)
        launches += chip_smoke.phase_serve_multiplex(cfg, params)
        launches += two_cards(chip_smoke.phase_serve_autoscale,
                              AUTOSCALE_ONE_CARD, cfg, prompts, outs)
    finally:
        serve.shutdown()
    print(json.dumps({"serve_deploy_k1_launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
