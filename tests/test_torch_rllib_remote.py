"""The port's RL fleet (env runner processes, the learner process, the
fault-tolerant manager, IMPALA/APPO's asynchronous sampling) on the CPU.

The runner fleet is held to the JAX package's runners built in this process
(no cluster): CartPoleBatchedEnv, two runner processes of 4 envs,
fragments of 40, the policy's logits scaled by 1e8 so both samplers take
the greedy action whatever their noise (as
``tests/test_torch_rllib.py::test_fragment_layout_matches_the_jax_runner``):
the env columns exact, the value columns within FWD_TOL. A remote CPU
runner against a local CPU runner, and the learner process against the
learner in this process, are held bit for bit (same worker index, weights,
seeds and torch thread count). The rest mirrors ``tests/test_rllib.py``'s
fleet cases. What travels to a runner or learner process is the port's own
classes (``BatchedCreator``, ``functools.partial`` of a module class,
``LearnerFactory``) and this module's top-level probe class, which makes a
process import this module again: its top imports no jax.
"""
import functools
import multiprocessing
import os
import signal

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.algorithm import LearnerFactory
from ray_tpu_torch.rllib.algorithms import appo as tappo
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.core import rl_module as trl
from ray_tpu_torch.rllib.core.learner import tree_leaves, tree_map
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.env import vector_env as tvec
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.utils.actor_manager import ActorError

torch.set_num_threads(2)

FWD_TOL = 1e-5
EXACT = ("obs", "actions", "rewards", "dones", "truncs", "valid",
         "episode_returns")


def _mlp_factory():
    return functools.partial(trl.MLPModule, 4, 2)


def _np_params(seed=0, scale_pi=1.0):
    params = tree_map(lambda t: t.numpy(), trl.MLPModule(4, 2).init(
        torch.Generator().manual_seed(seed)))
    params["pi"][-1] = {k: v * scale_pi for k, v in params["pi"][-1].items()}
    return params


def _no_children():
    kids = multiprocessing.active_children()
    assert kids == [], kids


# ------------------------------------------------------------ (a) runners

def test_fleet_fragments_match_the_jax_runners():
    """sample_fragments(40) of two runner processes, runner by runner,
    against the JAX package's SingleAgentEnvRunner(worker_index=1) and
    (worker_index=2) in this process, on the JAX module's params; then an
    unscaled fragment of each runner process against a local port runner
    with the same worker index and history, bit for bit."""
    import jax

    from ray_tpu.rllib.core import rl_module as jrl
    from ray_tpu.rllib.env import env_runner as jrunner
    from ray_tpu.rllib.env import vector_env as jvec

    def jcreator(n):
        return jvec.CartPoleBatchedEnv(n, seed=3)
    jcreator.makes_batched_env = True

    params = jax.tree.map(np.asarray,
                          jrl.MLPModule(4, 2).init(jax.random.key(1)))
    unscaled = jax.tree.map(np.copy, params)
    params["pi"][-1] = {k: v * 1e8 for k, v in params["pi"][-1].items()}
    jax_runners = [jrunner.SingleAgentEnvRunner(
        jcreator, lambda: jrl.MLPModule(4, 2), num_envs=4, seed=2,
        worker_index=w, device="cpu") for w in (1, 2)]
    for r in jax_runners:
        r.set_weights(params)
    fleet = EnvRunnerGroup(tvec.BatchedCreator(tvec.CartPoleBatchedEnv,
                                               seed=3),
                           _mlp_factory(), num_runners=2,
                           num_envs_per_runner=4, seed=2)
    try:
        _check_fleet(fleet, jax_runners, params, unscaled)
    finally:
        fleet.stop()
    _no_children()


def _check_fleet(fleet, jax_runners, params, unscaled):
    fleet.sync_weights(params)
    for _ in range(2):
        got = fleet.sample_fragments(40)
        assert len(got) == 2
        for frag, jr in zip(got, jax_runners):
            want = jr.sample_fragment(40)
            assert sorted(frag) == sorted(want)
            for k in EXACT:
                np.testing.assert_array_equal(np.asarray(frag[k]),
                                              np.asarray(want[k]), err_msg=k)
                assert np.asarray(frag[k]).dtype == np.asarray(want[k]).dtype
            for k in ("vf", "bootstrap"):
                np.testing.assert_allclose(frag[k], want[k], atol=FWD_TOL,
                                           rtol=FWD_TOL, err_msg=k)
    # The two runners' envs differ (seed * 65537 + worker_index).
    assert not np.array_equal(got[0]["obs"], got[1]["obs"])

    # A remote CPU runner against a local CPU runner (one torch thread,
    # as the runner process), the same history, then unscaled weights.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        local = [SingleAgentEnvRunner(
            tvec.BatchedCreator(tvec.CartPoleBatchedEnv, seed=3),
            _mlp_factory(), num_envs=4, seed=2, worker_index=w,
            device="cpu") for w in (1, 2)]
        for r in local:
            r.set_weights(params)
            r.sample_fragment(40)
            r.sample_fragment(40)
            r.set_weights(unscaled)
        fleet.sync_weights(unscaled)
        got = fleet.sample_fragments(40)
        for frag, r in zip(got, local):
            want = r.sample_fragment(40)
            assert np.abs(frag["logp"]).min() > 0.05  # the policy samples
            for k in want:
                np.testing.assert_array_equal(np.asarray(frag[k]),
                                              np.asarray(want[k]), err_msg=k)
    finally:
        torch.set_num_threads(threads)
    info = dict(fleet.manager.foreach_actor("process_info"))
    assert sorted(info) == [0, 1]
    for i in info.values():
        assert (i["device"], i["num_threads"], i["cuda_initialized"]) == (
            "cpu", 1, False)


# ------------------------------------------------------------- (b) PPO

def test_ppo_remote_env_runners():
    """tests/test_rllib.py::test_ppo_remote_env_runners: gymnasium's
    CartPole-v1 by id on 2 runner processes of 2 envs, 2 iterations."""
    algo = (tppo.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2)
            .training(train_batch_size=400, num_epochs=1, max_episode_len=128)
            .resources(device="cpu").build())
    try:
        for _ in range(2):
            result = algo.train()
        assert result["env_steps_this_iter"] >= 400
        assert np.isfinite(result["total_loss"])
    finally:
        algo.stop()
    _no_children()


# ------------------------------------------------- (c), (d) runner deaths

def _cartpole_group(max_restarts):
    return EnvRunnerGroup(tvec.BatchedCreator(tvec.CartPoleBatchedEnv),
                          _mlp_factory(), num_runners=2,
                          num_envs_per_runner=1, seed=7,
                          max_restarts=max_restarts)


def test_env_runner_group_survives_runner_death():
    """tests/test_rllib.py::test_env_runner_group_survives_actor_death:
    SIGKILL runner 0; the next sample skips it, the manager restores it,
    and sampling continues with both."""
    group = _cartpole_group(max_restarts=3)
    try:
        params = _np_params()
        group.sync_weights(params)
        assert group.sample(100)
        os.kill(group.manager.actor(0).pid, signal.SIGKILL)
        assert group.sample(100)  # failed runner skipped, then restored
        assert len(group.manager.healthy_actor_ids()) == 2
        assert group.manager.num_restarts(0) == 1
        group.sync_weights(params)
        eps = group.sample(100)
        assert eps and len(group.manager.healthy_actor_ids()) == 2
    finally:
        group.stop()
    _no_children()


def test_restart_budget_leaves_a_runner_down():
    """With max_restarts=1 the same runner killed twice stays unhealthy;
    sampling goes on with the other runner."""
    group = _cartpole_group(max_restarts=1)
    try:
        params = _np_params()
        group.sync_weights(params)
        for _ in range(2):
            os.kill(group.manager.actor(0).pid, signal.SIGKILL)
            group.manager.actor(0).proc.join(10)
            group.sync_weights(params)
            assert group.sample(50)
        assert group.manager.healthy_actor_ids() == [1]
        assert group.manager.num_restarts(0) == 1
        assert group.sample(50)
        assert group.sample_fragments(10) and len(
            group.sample_fragments(10)) == 1
    finally:
        group.stop()
    _no_children()


# --------------------------------------------------- (e) learner process

class FailingModuleFactory:
    def __call__(self):
        raise ValueError("this module factory fails on purpose")


def _ppo_batch(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "logp": (-0.7 + 0.1 * rng.standard_normal(n)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32),
            "mask": np.ones(n, np.float32)}


def _ppo_learner_factory():
    return LearnerFactory(tppo.PPOLearner, _mlp_factory(), tppo.PPOConfig(),
                          seed=5, device="cpu")


def test_learner_process_update_and_state_match_in_process():
    """A PPO update in the learner process equals the in-process
    learner's bit for bit (metrics and weights, shuffled minibatches),
    and get_state/set_state round-trip through the process."""
    group = LearnerGroup(_ppo_learner_factory(), num_learners=1,
                         device="cpu")
    try:
        local = _ppo_learner_factory()()
        for seed in range(2):
            batch = _ppo_batch(seed=seed)
            got = group.update(batch, minibatch_size=64, num_epochs=2)
            want = local.update(batch, minibatch_size=64, num_epochs=2)
            assert got == want
        for a, b in zip(tree_leaves(group.get_weights()),
                        tree_leaves(local.get_weights())):
            np.testing.assert_array_equal(a, b)
        state = local.get_state()
        assert state["opt_state"]["count"] == 16
        other = _ppo_learner_factory()().get_state()
        group.set_state(other)
        for a, b in zip(tree_leaves(group.get_state()), tree_leaves(other)):
            np.testing.assert_array_equal(a, b)
        group.set_state(state)
        for a, b in zip(tree_leaves(group.get_state()), tree_leaves(state)):
            np.testing.assert_array_equal(a, b)
        info = group.actor.call("process_info")
        assert (info["device"], info["num_threads"]) == (
            "cpu", torch.get_num_threads())
    finally:
        group.shutdown()
    _no_children()


def test_dqn_learner_calls_through_the_process():
    """DQN's update_td, take_td_errors and sync_target through the
    learner process equal the in-process learner's."""
    cfg = tdqn.DQNConfig()
    factory = LearnerFactory(tdqn.DQNLearner,
                             functools.partial(tdqn.DQNModule, 4, 2),
                             cfg, seed=3, device="cpu")
    group = LearnerGroup(factory, num_learners=1, device="cpu")
    try:
        local = factory()
        rng = np.random.default_rng(0)
        for step in range(3):
            n = 32
            batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                     "actions": rng.integers(0, 2, n),
                     "rewards": rng.standard_normal(n).astype(np.float32),
                     "next_obs": rng.standard_normal((n, 4)).astype(
                         np.float32),
                     "dones": (rng.random(n) < 0.1).astype(np.float32),
                     "weights": np.ones(n, np.float32)}
            assert group.call("update_td", batch) == local.update_td(batch)
            np.testing.assert_array_equal(group.call("take_td_errors"),
                                          local.take_td_errors())
            if step == 1:
                group.call("sync_target")
                local.sync_target()
        for a, b in zip(tree_leaves(group.get_weights()),
                        tree_leaves(local.get_weights())):
            np.testing.assert_array_equal(a, b)
    finally:
        group.shutdown()
    _no_children()


def test_learner_that_fails_to_build_raises_with_its_traceback():
    factory = LearnerFactory(tppo.PPOLearner, FailingModuleFactory(),
                             tppo.PPOConfig(), device="cpu")
    with pytest.raises(ActorError, match="fails on purpose"):
        LearnerGroup(factory, num_learners=1, device="cpu")
    _no_children()


# ---------------------------------------------------- (f) IMPALA, APPO

@pytest.mark.parametrize("name", ["impala", "appo"])
def test_async_sampling_on_runner_processes(name):
    """IMPALA and APPO on 2 CPU runner processes, 3 training steps:
    updates_per_step updates a step; after each step (broadcast_interval
    1) every healthy runner holds the learner's weights; a runner killed
    with its sample in flight is restored and re-armed by the step after
    (at the latest);
    APPO's kl finite and mean ratio in (0.2, 5) (tests/test_rllib.py's
    APPO bounds); no process left."""
    cfg = {"impala": timpala.IMPALAConfig(), "appo": tappo.APPOConfig()}[name]
    algo = (cfg.environment(env_creator=tvec.BatchedCreator(
        tvec.CartPoleBatchedEnv))
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=25)
        .training(updates_per_step=3, max_episode_len=128)
        .resources(device="cpu").debugging(seed=4).build())
    manager = algo.env_runner_group.manager
    try:
        for step in range(3):
            if step == 1:
                assert 0 in {t.actor_id for t in algo._inflight}
                os.kill(manager.actor(0).pid, signal.SIGKILL)
            result = algo.train()
            assert result["num_updates"] == 3
            assert result["max_runner_lag"] <= cfg.broadcast_interval
            assert result["env_steps_this_iter"] >= 3 * 4 * 25
            assert np.isfinite(result["total_loss"])
            want = tree_leaves(algo.learner_group.get_weights())
            held = manager.foreach_actor("get_weights")
            assert [i for i, _ in held] == manager.healthy_actor_ids()
            for _, w in held:
                for a, b in zip(tree_leaves(w), want):
                    np.testing.assert_array_equal(a, b)
        assert manager.num_restarts(0) == 1
        assert manager.healthy_actor_ids() == [0, 1]
        assert {t.actor_id for t in algo._inflight} == {0, 1}
        if name == "appo":
            assert np.isfinite(result["kl"])
            assert 0.2 < result["mean_ratio"] < 5.0
    finally:
        algo.stop()
    _no_children()
