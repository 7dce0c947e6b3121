#!/usr/bin/env python3
"""``chip_smoke.py``'s Tune phase alone, on every visible card up to 4:
the kernels' build, then ``tune_train`` (GPT-2 125M function trials under
ASHA, ``TorchTrainer`` trials and PPO as a Trainable, each trial a
process on the cards the controller gives it; the GPT-2 losses held to
the same steps in this process). On four cards arm A's four trials run
at once, a card each, and arm B's two trials on two cards. Prints the
phase's JSON line; the exit code is 1 if it failed. Run from the repo
root:

    python3 tools/tune_phases.py > tune.txt 2>&1
"""
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    cs.keep_bytecode()
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    fa.build()
    cs.emit("build", ok=True, seconds=time.perf_counter() - t0,
            cards=torch.cuda.device_count())
    print(cs.card_line(), flush=True)
    fn, trainer = cs.phase_tune_train(dev)
    print(f"tune_train launches: trials {fn}, workers {trainer}", flush=True)
