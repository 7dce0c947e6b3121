"""RLlib's algorithms as Tune trials (``ray_tpu_torch.tune``) on the CPU:
PPO through ``Tuner`` with a plain dict of overrides, its results bit for
bit ``PPO(config).train()``. The trainable is at module level (a trial
process imports this module again); its top imports no jax.
"""
import json
import multiprocessing
import os

import pytest
import torch

from ray_tpu_torch import tune
from ray_tpu_torch.rllib.algorithms.ppo import PPO
from ray_tpu_torch.rllib.env.vector_env import (BatchedCreator,
                                                CartPoleBatchedEnv)
from ray_tpu_torch.train import RunConfig
from ray_tpu_torch.util import procs


@pytest.fixture(scope="module", autouse=True)
def _stop_fork_server():
    """Algorithm trials fork from the preloaded fork server: stopped at
    the end."""
    yield
    procs.stop_fork_server()


class CartPolePPO(PPO):
    """PPO on the batched CartPole, the learner and runner on the CPU, one
    torch thread (a thread count changes the products' sums)."""

    @classmethod
    def get_default_config(cls):
        cfg = super().get_default_config()
        cfg.env_creator = BatchedCreator(CartPoleBatchedEnv, seed=1)
        cfg.device = "cpu"
        return cfg

    def setup(self, config):
        torch.set_num_threads(1)
        super().setup(config)


PPO_SPACE = {"num_envs_per_env_runner": 8, "rollout_fragment_length": 16,
             "train_batch_size": 128, "minibatch_size": 32, "num_epochs": 2,
             "seed": 1}
PPO_KEYS = ("total_loss", "policy_loss", "vf_loss", "entropy", "approx_kl",
            "grad_norm", "timesteps_total", "training_iteration")


def test_ppo_through_tune_matches_ppo_train(tmp_path):
    """Tuner(PPO) with a plain dict of overrides and a stop at iteration
    2: the trial's two results are PPO(config).train()'s, bit for bit;
    the class API's checkpoint at the end reads back into a new PPO."""
    assert issubclass(PPO, tune.Trainable)
    threads = torch.get_num_threads()
    try:
        algo = CartPolePPO(dict(PPO_SPACE))
        want = [algo.train() for _ in range(2)]
        algo.stop()
    finally:
        torch.set_num_threads(threads)
    grid = tune.Tuner(
        CartPolePPO, param_space=dict(PPO_SPACE),
        run_config=RunConfig(name="ppo", storage_path=str(tmp_path),
                             stop={"training_iteration": 2}),
    ).fit()
    assert multiprocessing.active_children() == []
    assert not grid.errors
    (r,) = grid
    with open(os.path.join(r.path, "result.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert len(rows) == 2
    for got, exp in zip(rows, want):
        assert {k: got[k] for k in PPO_KEYS} == {k: exp[k] for k in PPO_KEYS}
    assert r.checkpoint is not None
    try:
        other = CartPolePPO(dict(PPO_SPACE))
        other.restore(r.checkpoint.path)
        assert other.train()["training_iteration"] == 3
        other.stop()
    finally:
        torch.set_num_threads(threads)
