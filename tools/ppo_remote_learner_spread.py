#!/usr/bin/env python3
"""How far PPO's learner process lies from the learner in the calling
process on fresh batches, at ``chip_smoke.py``'s ``ppo_remote`` shape.

Builds PPO on ``CnnRolloutBenchEnv`` with 4 CPU runner processes of 64
envs and the learner process on card 0 (``num_learners=1``), trains one
iteration, then runs ``chip_smoke._remote_learner_check`` on ``N`` fresh
on-policy batches, each with cuDNN's deterministic algorithms (the smoke's
check) and with its defaults: per batch and setting one JSON line with the
worst relative L2 per leaf of the parameter change and the largest
relative difference of an update metric, from a fresh learner process's
update to the nearest of 3 in-process updates, between those in-process
updates, and from an in-process update that skips the last minibatch.
Run from the repo root on a card:

    python3 tools/ppo_remote_learner_spread.py 12
"""
import json
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.env.vector_env import CnnRolloutBenchEnv

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.card_line(), flush=True)
    batch = cs.PPO_RUNNERS * cs.PPO_RUNNER_ENVS * cs.PPO_FRAGMENT
    algo = (PPOConfig()
            .environment(env_creator=cs.batched_creator(CnnRolloutBenchEnv))
            .env_runners(num_env_runners=cs.PPO_RUNNERS,
                         num_envs_per_env_runner=cs.PPO_RUNNER_ENVS,
                         rollout_fragment_length=cs.PPO_FRAGMENT)
            .learners(num_learners=1)
            .training(train_batch_size=batch,
                      minibatch_size=cs.PPO_MINIBATCH,
                      num_epochs=cs.PPO_EPOCHS)
            .debugging(seed=cs.SEED).build())
    try:
        algo.train()
        for k in range(int(sys.argv[1]) if len(sys.argv) > 1 else 12):
            for det in (True, False):
                change, metrics = cs._remote_learner_check(
                    algo, dev, deterministic=det)
                print(json.dumps({
                    "batch": k,
                    "cudnn": "deterministic" if det else "default",
                    "change_rel_l2": change, "metrics_rel": metrics}),
                    flush=True)
    finally:
        algo.stop()
