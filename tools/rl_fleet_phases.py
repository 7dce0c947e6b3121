#!/usr/bin/env python3
"""``chip_smoke.py``'s RL phases alone on one card: ``ppo_train`` (PPO in
one process), then ``ppo_remote`` (the same batch from 4 CPU runner
processes and the learner process on the card, beside ``ppo_train``'s
numbers) and ``impala_async``; each prints its JSON line. Run from the
repo root on a card:

    python3 tools/rl_fleet_phases.py > fleet.txt 2>&1
"""
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.card_line(), flush=True)
    in_process = cs.phase_ppo_train(dev)
    cs.gc_collect()
    cs.phase_ppo_remote(dev, in_process)
    cs.gc_collect()
    cs.phase_impala_async(dev)
