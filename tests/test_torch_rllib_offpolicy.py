"""The port's off-policy RL (ray_tpu_torch/rllib: DQN, SAC, CQL, the env
runner's episode path) against the JAX package's, on the CPU.

The same params (the JAX module's init, as numpy, through
``set_weights``) and the same seeded numpy inputs go through both sides.
Where the reference draws noise from a key, the test rebuilds its draws
from that key, following the loss's own split sequence, and hands them to
the port's explicit ``noise`` argument. Tolerances: sampled actions and
their logp within 1e-6; losses, metrics and |TD errors| within 1e-5; the
parameter change of one update within 1e-4 relative L2 per leaf; the
runner's actions and rewards within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JRunner
from ray_tpu.rllib.offline import cql as jcql
from ray_tpu.rllib.utils import episodes as jeps
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.core.learner import tree_leaves, tree_map
from ray_tpu_torch.rllib.core.rl_module import MLPModule
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.multi_agent_env import make_multi_agent_creator
from ray_tpu_torch.rllib.env.vector_env import CartPoleBatchedEnv
from ray_tpu_torch.rllib.offline import cql as tcql
from ray_tpu_torch.rllib.utils import episodes as teps

torch.set_num_threads(2)

SAMPLE_TOL = 1e-6
LOSS_TOL = 1e-5
DELTA_REL_L2 = 1e-4
RUNNER_TOL = 1e-5


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(a, b):
    nb = np.linalg.norm(b)
    if nb == 0:
        return 0.0 if np.linalg.norm(a) == 0 else np.inf
    return float(np.linalg.norm(a - b) / nb)


def _assert_changes(start, jl, tl):
    """The parameter change of the same update(s), per leaf."""
    for s, j, t in zip(jax.tree.leaves(start), jax.tree.leaves(
            jl.get_weights()), tree_leaves(tl.get_weights())):
        assert _rel_l2(t - np.asarray(s), np.asarray(j) - s) < DELTA_REL_L2


def _assert_metrics(got, want, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(np.asarray(got[k].detach() if isinstance(
            got[k], torch.Tensor) else got[k]), np.asarray(want[k]),
            rtol=LOSS_TOL, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ the runner

class _JBoxModule:
    """A deterministic Box policy: 2 tanh(obs w + b), no noise."""

    def init(self, rng):
        return {}

    def forward(self, params, obs):
        return {"logits": obs @ params["w"],
                "vf": jnp.zeros(obs.shape[0], jnp.float32)}

    def forward_exploration(self, params, obs, rng):
        act = 2.0 * jnp.tanh(obs.astype(jnp.float32) @ params["w"]
                             + params["b"])
        zero = jnp.zeros(obs.shape[0], jnp.float32)
        return act, zero, zero


class _TBoxModule:
    """The same policy in torch; its value (never 0) marks bootstraps."""

    def forward(self, params, obs):
        return {"logits": obs.float() @ params["w"],
                "vf": obs.float().sum(-1) + 10.0}

    def forward_exploration(self, params, obs, generator):
        act = 2.0 * torch.tanh(obs.float() @ params["w"] + params["b"])
        return (act, torch.zeros(obs.shape[0], device=obs.device),
                self.forward(params, obs)["vf"])


def _box_params():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 1)).astype(np.float32),
            "b": np.array([0.3], np.float32)}


def test_c5_box_actions_leave_the_runner_as_floats_of_the_modules_shape():
    """C5: the runner cast every action to an integer (and its stack of
    [N, 1] actions beside [N] logp raised). Both runners on gymnasium's
    Pendulum-v1 from the same weights and env seed, through sample():
    the same chunks, actions and rewards."""
    import gymnasium as gym

    def creator():
        return gym.make("Pendulum-v1")

    jr = JRunner(creator, _JBoxModule, num_envs=2, seed=4, device="cpu")
    tr = SingleAgentEnvRunner(creator, _TBoxModule, num_envs=2, seed=4,
                              device="cpu")
    jr.set_weights(_box_params())
    tr.set_weights(_box_params())
    for _ in range(2):  # 225 steps an env: a truncation, then a cut
        want, got = jr.sample(450), tr.sample(450)
        assert [len(e) for e in got] == [len(e) for e in want]
        for g, w in zip(got, want):
            assert (g.terminated, g.truncated) == (w.terminated, w.truncated)
            a = np.stack(g.actions)
            assert a.dtype == np.float32 and a.shape == (len(g), 1)
            np.testing.assert_allclose(a, np.stack(w.actions),
                                       atol=RUNNER_TOL, rtol=RUNNER_TOL)
            np.testing.assert_allclose(g.rewards, w.rewards,
                                       atol=RUNNER_TOL, rtol=RUNNER_TOL)
    frag = tr.sample_fragment(5)
    assert frag["actions"].shape == (5, 2, 1)
    assert frag["actions"].dtype == np.float32
    jr.stop()
    tr.stop()


def _layout(chunks):
    return [(len(e), e.terminated, e.truncated, e.bootstrap_value != 0.0,
             len(e.observations) - len(e)) for e in chunks]


def test_episode_path_over_a_batched_env_has_the_gym_paths_layout():
    """sample() over a BatchedEnv. Next-step autoreset (the smoke's
    PendulumBatchedEnv against gymnasium's Pendulum-v1, the same
    deterministic policy): the same chunks, truncated at 200 with a
    bootstrap and their final observation, the rest cut with a bootstrap.
    Same-step autoreset (CartPoleBatchedEnv against gymnasium's
    CartPole-v1, a greedy policy): lengths summing to the steps taken,
    terminated chunks without a bootstrap, cut ones with one; a done
    chunk has no final observation (the env returned the next episode's
    first one)."""
    import gymnasium as gym

    def run(creator, module, params, n, steps, seed=1):
        r = SingleAgentEnvRunner(creator, module, num_envs=n, seed=seed,
                                 device="cpu")
        r.set_weights(params)
        out = [r.sample(steps) for _ in range(2)]
        r.stop()
        return out

    gym_p = run(lambda: gym.make("Pendulum-v1"), _TBoxModule, _box_params(),
                2, 450)
    nat_p = run(chip_smoke.batched_creator(chip_smoke.PendulumBatchedEnv),
                _TBoxModule, _box_params(), 2, 450)
    assert [_layout(c) for c in nat_p] == [_layout(c) for c in gym_p]
    assert _layout(gym_p[0])[0] == (200, False, True, True, 1)

    params = MLPModule(4, 2).init(torch.Generator().manual_seed(1))
    params["pi"][-1] = {k: v * 1e8 for k, v in params["pi"][-1].items()}
    for creator, final_obs in (
            (lambda: gym.make("CartPole-v1"), 1),
            (chip_smoke.batched_creator(CartPoleBatchedEnv), 0)):
        for chunks in run(creator, lambda: MLPModule(4, 2), params, 4, 300):
            assert 300 <= sum(len(e) for e in chunks) < 304
            done = [e for e in chunks if e.terminated]
            assert done and not any(e.truncated for e in chunks)
            for e in chunks:
                assert (e.bootstrap_value != 0.0) == (not e.terminated)
                assert len(e.observations) - len(e) == (
                    final_obs if e.terminated else 1)


class _Balance:
    """A CartPole controller that holds the pole up past the 500-step
    limit: a linear state feedback, the sign of ``obs @ k``. Its value
    (never 0)
    marks bootstraps."""

    def forward(self, params, obs):
        return {"logits": obs.float(), "vf": obs.float().sum(-1) + 10.0}

    def forward_exploration(self, params, obs, generator):
        act = (obs.float() @ params["k"] > 0).long()
        return (act, torch.zeros(obs.shape[0], device=obs.device),
                self.forward(params, obs)["vf"])


def test_same_step_time_limit_stores_no_transition_without_its_next_obs():
    """CartPoleBatchedEnv (same-step autoreset) run past its 500-step
    limit: each env's first chunk ends truncated at 500 without its final
    observation (the env returned the next episode's first one) and
    without a bootstrap. The replay buffer keeps its first 499 steps,
    each with the observation that followed it, and drops the last one,
    whose next observation the env never returned; DQN counts that step
    among its env steps all the same."""
    from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

    r = SingleAgentEnvRunner(chip_smoke.batched_creator(CartPoleBatchedEnv),
                             _Balance, num_envs=4, seed=0, device="cpu")
    r.set_weights({"k": np.array([1.0, 1.0, 10.0, 3.0], np.float32)})
    chunks = r.sample(4 * 520)
    r.stop()
    truncated = [e for e in chunks if e.truncated]
    assert len(truncated) == 4 and not any(e.terminated for e in chunks)
    for e in truncated:
        assert len(e) == len(e.observations) == 500
        assert e.bootstrap_value == 0.0
    buf = ReplayBuffer(4096, (4,))
    added = buf.add_episodes(chunks)
    steps = sum(len(e) for e in chunks)
    assert added == len(buf) == steps - 4
    assert not buf.dones[:added].any()
    # Every stored next observation is the one that followed its step
    # (a CartPole state never repeats across one step).
    assert (np.abs(buf.next_obs[:added] - buf.obs[:added]).max(-1) > 0).all()
    want = np.concatenate([np.stack(e.observations[1:len(e) + 1])
                           if len(e.observations) > len(e)
                           else np.stack(e.observations[1:])
                           for e in chunks])
    np.testing.assert_array_equal(buf.next_obs[:added], want)


def test_episode_path_skips_dead_multi_agent_columns():
    """Over MultiAgentBatchedEnv (same-step): agent a's chunks end
    terminated after 8 steps, agent b's truncated after 5; its 3 dead
    steps record nothing."""
    creator = make_multi_agent_creator(chip_smoke.TwoAgentEnv)
    r = SingleAgentEnvRunner(creator, lambda: MLPModule(3, 2), num_envs=4,
                             seed=0, device="cpu")
    r.set_weights(MLPModule(3, 2).init(torch.Generator().manual_seed(0)))
    chunks = r.sample(8 * 2 + 5 * 2)  # one whole episode of both
    done = sorted((len(e), e.terminated, e.truncated) for e in chunks
                  if e.is_done)
    assert done == [(5, False, True)] * 2 + [(8, True, False)] * 2
    assert sum(len(e) for e in chunks) == 26
    r.stop()


# ------------------------------------------------------------------- DQN

def _dqn_pair(**cfg_kw):
    jl = jdqn.DQNLearner(jdqn.DQNModule(4, 2),
                         jdqn.DQNConfig().training(**cfg_kw))
    tl = tdqn.DQNLearner(tdqn.DQNModule(4, 2),
                         tdqn.DQNConfig().training(**cfg_kw), device="cpu")
    tl.set_weights(jl.get_weights())
    # A target net apart from the online one.
    target = _np(jdqn.DQNModule(4, 2).init(jax.random.key(9)))
    jl._target_params = jax.tree.map(jnp.asarray, target)
    tl._target_params = _to_torch(target)
    return jl, tl


def _td_batch(rng, n=32, weights=False):
    b = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
         "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
         "actions": rng.integers(0, 2, n).astype(np.int32),
         "rewards": rng.standard_normal(n).astype(np.float32),
         "dones": (rng.random(n) < 0.2).astype(np.float32)}
    if weights:
        b["weights"] = rng.random(n).astype(np.float32)
    return b


@pytest.mark.parametrize("weights", [False, True])
def test_dqn_loss_td_errors_and_update_match_jax(weights):
    jl, tl = _dqn_pair(lr=1e-3, grad_clip=0.5)
    batch = _td_batch(np.random.default_rng(1), weights=weights)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jmet = jl.loss(jl.params, {**jb, "target_params":
                                      jl._target_params}, jax.random.key(0))
    tloss, tmet = tl.loss(tl.params, {k: torch.from_numpy(v) for k, v in
                                      batch.items()}, torch.Generator())
    assert sorted(tmet) == sorted(jmet)
    _assert_metrics(tmet, jmet)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(tl.td_errors(batch), jl.td_errors(batch),
                               rtol=LOSS_TOL, atol=1e-6)
    start = jl.get_weights()
    want, got = jl.update_td(batch), tl.update_td(batch)
    assert sorted(got) == sorted(want)
    _assert_metrics(got, want)
    np.testing.assert_allclose(tl.take_td_errors(), jl.take_td_errors(),
                               rtol=LOSS_TOL, atol=1e-6)
    _assert_changes(start, jl, tl)
    # Epsilon is a leaf no loss reaches: Adam leaves it as it is.
    assert tl.params["epsilon"].item() == float(start["epsilon"]) == 1.0
    tl.sync_target()
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tl._target_params), tree_leaves(tl.params)))
    assert all(a is not b for a, b in zip(
        tree_leaves(tl._target_params), tree_leaves(tl.params)))


def test_dqn_module_explores_with_epsilon_from_its_params():
    m = tdqn.DQNModule(4, 3)
    params = m.init(torch.Generator().manual_seed(0))
    obs = torch.randn(4000, 4, generator=torch.Generator().manual_seed(1))
    greedy = m.forward(params, obs)["logits"].argmax(-1)
    for eps, share in ((0.0, 0.0), (0.6, 0.6 * 2 / 3), (1.0, 2 / 3)):
        params["epsilon"] = torch.tensor(eps)
        a, logp, vf = m.forward_exploration(params, obs,
                                            torch.Generator().manual_seed(2))
        assert a.dtype == torch.int64 and torch.all(logp == 0)
        np.testing.assert_allclose(float((a != greedy).float().mean()),
                                   share, atol=0.03)


def _scripted_episodes(mod, it):
    rng = np.random.default_rng(100 + it)
    out = []
    for i in range(4):
        T = int(rng.integers(5, 20))
        ep = mod.SingleAgentEpisode()
        ep.observations = [rng.standard_normal(4).astype(np.float32)
                           for _ in range(T + 1)]
        ep.actions = [int(a) for a in rng.integers(0, 2, T)]
        ep.rewards = [1.0] * T
        ep.logp = [0.0] * T
        ep.vf_preds = [0.0] * T
        ep.terminated = i % 2 == 0
        out.append(ep)
    return out


def test_dqn_epsilon_schedule_and_target_sync_cadence_match_jax():
    """Both DQNs' training_step over the same scripted episodes (the
    runners' sample replaced): epsilon in the weights each iteration, the
    buffer, the TD updates' start and the target syncs, identical."""
    def config(mod):
        cfg = (mod.DQNConfig().environment("CartPole-v1")
               .training(train_batch_size=40, minibatch_size=16))
        cfg.learning_starts = 60
        cfg.target_network_update_freq = 70
        cfg.epsilon_timesteps = 200
        cfg.num_td_updates_per_iter = 2
        return cfg

    runs = []
    for mod, eps_mod, device in ((jdqn, jeps, None), (tdqn, teps, "cpu")):
        cfg = config(mod)
        if device:
            cfg.resources(device=device)
        algo = cfg.build()
        it = iter(range(100))
        algo.env_runner_group.sample = (
            lambda n, m=eps_mod: _scripted_episodes(m, next(it)))
        learner = algo.learner_group._learner
        syncs = []
        sync = learner.sync_target
        learner.sync_target = lambda: (syncs.append(algo._iteration),
                                       sync())[1]
        seen = []
        for _ in range(8):
            r = algo.train()
            seen.append((r["epsilon"], r["buffer_size"],
                         r["env_steps_this_iter"], "td_loss" in r,
                         float(np.asarray(algo.learner_group.get_weights()
                                          ["epsilon"]))))
        runs.append((seen, syncs))
        algo.stop()
    assert runs[1] == runs[0]
    assert len(runs[0][1]) >= 3  # the setup's sync, then two or more


# ------------------------------------------------------------ SAC, CQL

SAC_OBS, SAC_ACT = 3, 2
LOW = np.array([-2.0, -1.0], np.float32)
HIGH = np.array([2.0, 3.0], np.float32)


def _sac_pair(jmod, tmod, learner, config, **cfg_kw):
    jm = jsac.SACModule(SAC_OBS, SAC_ACT, LOW, HIGH, hiddens=(16, 16))
    tm = tsac.SACModule(SAC_OBS, SAC_ACT, LOW, HIGH, hiddens=(16, 16))
    jl = getattr(jmod, learner)(jm, getattr(jmod, config)().training(
        **cfg_kw))
    tl = getattr(tmod, learner)(tm, getattr(tmod, config)().training(
        **cfg_kw), device="cpu")
    tl.set_weights(jl.get_weights())
    # Targets apart from the critics.
    other = _np(jm.init(jax.random.key(5)))
    jl._target_q = {k: jax.tree.map(jnp.asarray, other[k])
                    for k in ("q1", "q2")}
    tl._target_q = {k: _to_torch(other[k]) for k in ("q1", "q2")}
    return jl, tl


def _sac_batch(rng, n=24):
    return {"obs": rng.standard_normal((n, SAC_OBS)).astype(np.float32),
            "next_obs": rng.standard_normal((n, SAC_OBS)).astype(np.float32),
            "actions": rng.uniform(LOW, HIGH, (n, SAC_ACT)).astype(
                np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": (rng.random(n) < 0.2).astype(np.float32)}


def _noise(key, n, cql_n=None):
    """The reference's draws from ``key``: SAC's ``split(rng)``, then CQL's
    ``split(fold_in(rng, 7))``."""
    r_next, r_pi = jax.random.split(key)
    out = {"next": jax.random.normal(r_next, (n, SAC_ACT)),
           "pi": jax.random.normal(r_pi, (n, SAC_ACT))}
    if cql_n:
        r_unif, r_pi2 = jax.random.split(jax.random.fold_in(key, 7))
        out["cql_unif"] = jax.random.uniform(r_unif, (n * cql_n, SAC_ACT),
                                             minval=-1.0, maxval=1.0)
        out["cql_pi"] = jax.random.normal(r_pi2, (n * cql_n, SAC_ACT))
    return {k: np.array(v) for k, v in out.items()}


def test_sac_sample_action_with_given_noise_matches_jax():
    jm = jsac.SACModule(SAC_OBS, SAC_ACT, LOW, HIGH, hiddens=(16, 16))
    tm = tsac.SACModule(SAC_OBS, SAC_ACT, LOW, HIGH, hiddens=(16, 16))
    params = _np(jm.init(jax.random.key(0)))
    # A wider policy than the init's (out_scale 0.01), so that the squash
    # correction matters.
    params["actor"][-1]["w"] = params["actor"][-1]["w"] * 300
    obs = np.random.default_rng(2).standard_normal((10, SAC_OBS)).astype(
        np.float32)
    key = jax.random.key(3)
    want_a, want_logp = jm.sample_action(params, jnp.asarray(obs), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (10,
                                                              SAC_ACT))))
    got_a, got_logp = tm.sample_action(_to_torch(params),
                                       torch.from_numpy(obs), None, noise)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                               atol=SAMPLE_TOL, rtol=SAMPLE_TOL)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp),
                               atol=SAMPLE_TOL, rtol=SAMPLE_TOL)
    # forward (the runner's value and greedy mean) and the env mapping
    want, got = jm.forward(params, obs), tm.forward(_to_torch(params),
                                                    torch.from_numpy(obs))
    for k in ("logits", "vf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(tm.to_env(got_a).numpy(),
                               np.asarray(jm.to_env(want_a)),
                               atol=SAMPLE_TOL, rtol=SAMPLE_TOL)


CASES = {
    # name -> (JAX module, port module, learner, config, CQL proposals)
    "sac": (jsac, tsac, "SACLearner", "SACConfig", None),
    "cql": (jcql, tcql, "CQLLearner", "CQLConfig", 4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sac_and_cql_losses_match_jax(name):
    jmod, tmod, learner, config, cql_n = CASES[name]
    jl, tl = _sac_pair(jmod, tmod, learner, config)
    batch = _sac_batch(np.random.default_rng(4))
    batch["weights"] = np.random.default_rng(5).random(24).astype(np.float32)
    key = jax.random.key(6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb.update(target_q1=jl._target_q["q1"], target_q2=jl._target_q["q2"])
    jloss, jmet = jl.loss(jl.params, jb, key)
    tloss, tmet = tl.loss(tl.params, {k: torch.from_numpy(v) for k, v in
                                      batch.items()}, None,
                          noise=_to_torch(_noise(key, 24, cql_n)))
    assert sorted(tmet) == sorted(jmet)
    _assert_metrics(tmet, jmet)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_TOL)
    assert float(jmet["entropy"]) != 0.0
    if cql_n:
        assert float(jmet["cql_penalty"]) > 0.1


@pytest.mark.parametrize("name", list(CASES))
def test_sac_and_cql_update_and_polyak_targets_match_jax(name):
    """One update_sac from the reference's next key, its draws handed to
    the port: the parameter change, the metrics and the targets' change
    (tau 0.5, so the change stands above f32's rounding of the targets;
    both compute (1 - tau) t + tau s); then the optimizer state in the
    reference's tree order."""
    jmod, tmod, learner, config, cql_n = CASES[name]
    jl, tl = _sac_pair(jmod, tmod, learner, config, lr=1e-3, grad_clip=1.0,
                       tau=0.5)
    batch = _sac_batch(np.random.default_rng(7))
    start = jl.get_weights()
    jt0 = _np(jl._target_q)
    _, key = jax.random.split(jl._rng)  # what update_sac will consume
    want = jl.update_sac(batch)
    got = tl.update_sac(batch, noise=_noise(key, 24, cql_n))
    assert want["grad_norm"] > 1.0  # the clip is active
    _assert_metrics(got, want)
    np.testing.assert_allclose(tl.take_td_errors(), jl.take_td_errors(),
                               rtol=LOSS_TOL, atol=1e-6)
    _assert_changes(start, jl, tl)
    for t0, j, t in zip(jax.tree.leaves(jt0), jax.tree.leaves(jl._target_q),
                        tree_leaves(tl._target_q)):
        t = t.numpy()
        assert _rel_l2(t - t0, np.asarray(j) - t0) < DELTA_REL_L2
    # The tree order of the reference: actor, log_alpha, q1, q2.
    jstate = jl.get_state()["opt_state"]
    adam = jstate[1][0]
    tstate = tl.get_state()
    assert tstate["opt_state"]["count"] == int(adam.count) == 1
    assert [a.shape for a in tree_leaves(tstate["params"])] == [
        np.shape(a) for a in jax.tree.leaves(jl.get_weights())]
    for j, t in zip(jax.tree.leaves(adam.mu),
                    tree_leaves(tstate["opt_state"]["mu"])):
        assert _rel_l2(t, np.asarray(j)) < DELTA_REL_L2


# ---------------------------------------------------- Pendulum, training

def test_smoke_pendulum_steps_as_gymnasium():
    """chip_smoke.py's numpy Pendulum against gymnasium's Pendulum-v1
    from the same state, 200 steps of a fixed action sequence: the
    observations and rewards within 1e-5, the truncation at 200."""
    import gymnasium as gym

    env = chip_smoke.PendulumBatchedEnv(1, seed=3)
    obs = env.reset()
    ref = gym.make("Pendulum-v1")
    ref.reset(seed=0)
    ref.unwrapped.state = env.state[0].copy()
    np.testing.assert_allclose(obs[0], ref.unwrapped._get_obs(), atol=1e-6)
    actions = np.random.default_rng(4).uniform(-3, 3, (200, 1)).astype(
        np.float32)
    for t in range(200):
        want = ref.step(actions[t])
        got = env.step(actions[t][None])
        np.testing.assert_allclose(got[0][0], want[0], atol=RUNNER_TOL,
                                   rtol=RUNNER_TOL)
        np.testing.assert_allclose(got[1][0], want[1], atol=RUNNER_TOL,
                                   rtol=RUNNER_TOL)
        assert (bool(got[2][0]), bool(got[3][0])) == (want[2], want[3])
    assert want[3] and got[3][0]
    # Next-step autoreset: the action is ignored, the reward is 0.
    obs, rew, term, trunc = env.step(np.zeros((1, 1), np.float32))
    assert rew[0] == 0.0 and not term[0] and not trunc[0]
    assert env._t[0] == 0


def test_smoke_applied_change_is_the_stored_change_before_rounding():
    """chip_smoke.applied_change over 3 DQN updates (Adam from a state with
    moments): each component within the f32 rounding of its three stored
    steps of the stored parameters' change, and not all equal to it."""
    _, tl = _dqn_pair(lr=1e-3)
    rng = np.random.default_rng(5)
    tl.update_td(_td_batch(rng))
    start = [w.copy() for w in tree_leaves(tl.get_weights())]
    applied = chip_smoke.applied_change(tl)
    for _ in range(3):
        tl.update_td(_td_batch(rng))
    end = tree_leaves(tl.get_weights())
    exact = True
    for a, s, e in zip(applied, start, end):
        stored = torch.as_tensor(np.asarray(e, np.float64) - s)
        ulp = torch.as_tensor(np.spacing(np.maximum(np.abs(s), np.abs(e))))
        assert torch.all((stored - a).abs() <= 3 * ulp + 1e-6 * a.abs())
        exact &= torch.equal(stored, a)
    assert not exact


def test_smoke_shared_relu_masks_replay_the_recorded_decisions():
    """chip_smoke.shared_relu_masks: the first block records each
    torch.relu call's decisions and computes relu; a later block takes
    them in order, whatever its own inputs say (its own with replay off),
    and counts where they differ."""
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
    masks = []
    with chip_smoke.shared_relu_masks(masks) as flips:
        a, b = torch.relu(x), torch.relu(-x)
    assert torch.equal(a, x.clamp_min(0)) and torch.equal(b, (-x).clamp_min(0))
    assert len(masks) == 2 and flips == []
    y = x.clone().requires_grad_()
    with chip_smoke.shared_relu_masks(masks) as flips:
        out = torch.relu(y + 0.5)
    out.sum().backward()
    moved = int(((x + 0.5 > 0) != (x > 0)).sum())
    assert moved > 0 and [int(f) for f in flips] == [moved]
    assert torch.equal(out.detach(), (x + 0.5) * masks[0])
    assert torch.equal(y.grad, masks[0].float())
    with chip_smoke.shared_relu_masks(masks, replay=False) as flips:
        own = torch.relu(x + 0.5)
    assert [int(f) for f in flips] == [moved]
    assert torch.equal(own, (x + 0.5).clamp_min(0))
    assert torch.relu(x).equal(x.clamp_min(0))  # restored


@pytest.mark.parametrize("algo", ["dqn", "sac"])
def test_short_training_run_on_the_cpu(algo):
    """DQN on CartPoleBatchedEnv, SAC on the smoke's Pendulum (prioritized
    replay), through XConfig().build() and train() with a small
    learning_starts: finite losses, changed weights, every env step in
    the buffer."""
    if algo == "dqn":
        cfg = tdqn.DQNConfig().environment(
            env_creator=chip_smoke.batched_creator(CartPoleBatchedEnv))
        cfg.training(learning_starts=100, num_td_updates_per_iter=4,
                     target_network_update_freq=100)
        keys = ("td_loss", "mean_q")
    else:
        cfg = tsac.SACConfig().environment(
            env_creator=chip_smoke.batched_creator(
                chip_smoke.PendulumBatchedEnv))
        cfg.training(learning_starts=100, num_updates_per_iter=4,
                     replay_buffer_config={"type": "prioritized"},
                     model={"fcnet_hiddens": (32, 32)})
        keys = ("critic_loss", "actor_loss", "alpha_loss")
    cfg.env_runners(num_envs_per_env_runner=4).training(
        train_batch_size=128, minibatch_size=32).resources(device="cpu")
    a = cfg.build()
    before = a.learner_group.get_weights()
    results = [a.train() for _ in range(3)]
    for r in results:
        assert all(np.isfinite(r[k]) for k in keys)
    assert a._buffer.size == sum(r["env_steps_this_iter"] for r in results)
    assert any(not np.array_equal(x, y) for x, y in zip(
        tree_leaves(before), tree_leaves(a.learner_group.get_weights())))
    if algo == "sac":
        acts = a._buffer.actions[:a._buffer.size]
        assert acts.dtype == np.float32 and np.abs(acts).max() <= 2.0
        vals = a._buffer._tree.values[:a._buffer.size]
        assert vals.min() < a._buffer._max_priority ** a._buffer.alpha
    a.stop()
