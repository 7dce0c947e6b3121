"""The spread of ``chip_smoke.py``'s PPO learner check over many batches.

``ppo_train`` holds 3 learner updates on the card against the same on the
CPU, replaying the CPU's ReLU decisions on the card
(``chip_smoke.shared_relu_masks``). This script reads that check on
``--batches`` fresh on-policy batches after the smoke's own warm-up and
timed iterations, each batch twice: as the smoke does, and with each side
taking its own ReLU decisions. Each line of output is one batch's JSON:
the card-vs-CPU readings (worst relative L2 per leaf of the change Adam
applied, the same with TF32 allowed, the stored parameters' change) and
the ReLU decisions on which the card's f32 run differed from the CPU's.

    python3 tools/ppo_learner_check_spread.py --batches 24
"""
import argparse
import functools
import json
import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig  # noqa: E402
from ray_tpu_torch.rllib.env.vector_env import (  # noqa: E402
    CnnRolloutBenchEnv)


def readings(check):
    return dict(zip(("applied", "tf32", "stored", "relu_flips"), check))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    batch = cs.PPO_ENVS * cs.PPO_FRAGMENT
    algo = (PPOConfig()
            .environment(env_creator=cs.batched_creator(CnnRolloutBenchEnv))
            .env_runners(num_envs_per_env_runner=cs.PPO_ENVS,
                         rollout_fragment_length=cs.PPO_FRAGMENT)
            .training(train_batch_size=batch,
                      minibatch_size=cs.PPO_MINIBATCH,
                      num_epochs=cs.PPO_EPOCHS)
            .debugging(seed=cs.SEED).build())
    try:
        learner = algo.learner_group.learner
        for _ in range(1 + cs.PPO_TIMED_ITERS):
            algo.train()
        group = algo.env_runner_group
        sample = group.sample_fragments
        for i in range(args.batches):
            frags = sample(cs.PPO_FRAGMENT)
            with mock.patch.object(group, "sample_fragments",
                                   lambda n: frags):
                shared = cs._ppo_learner_check(algo, learner, device)
                with mock.patch.object(cs, "shared_relu_masks",
                                       functools.partial(
                                           cs.shared_relu_masks,
                                           replay=False)):
                    own = cs._ppo_learner_check(algo, learner, device)
            print(json.dumps({"batch": i, "shared": readings(shared),
                              "own": readings(own)}), flush=True)
    finally:
        algo.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
