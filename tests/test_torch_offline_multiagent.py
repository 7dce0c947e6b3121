"""The port's offline RL (ray_tpu_torch/rllib/offline: IO, BC, MARWIL) and
multi-agent env against the JAX package's, on the CPU.

Shards, batches and Monte-Carlo returns are compared exactly; the
learners' losses and metrics within 1e-5 on the same params and batch, and
the parameter change of one update within 1e-4 relative L2 per leaf; the
multi-agent env's columns, rewards, flags and dead mask exactly.
"""
import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.env import multi_agent_env as jma
from ray_tpu.rllib.offline import bc as jbc
from ray_tpu.rllib.offline import io as jio
from ray_tpu.rllib.offline import marwil as jmarwil
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
from ray_tpu_torch.rllib.core import rl_module as trl
from ray_tpu_torch.rllib.core.learner import tree_leaves
from ray_tpu_torch.rllib.env import multi_agent_env as tma
from ray_tpu_torch.rllib.env.vector_env import CartPoleBatchedEnv
from ray_tpu_torch.rllib.offline import bc as tbc
from ray_tpu_torch.rllib.offline import io as tio
from ray_tpu_torch.rllib.offline import marwil as tmarwil

torch.set_num_threads(2)

LOSS_TOL = 1e-5
DELTA_REL_L2 = 1e-4


def _fragment(rng, T=16, N=4):
    valid = np.ones((T, N), np.float32)
    valid[rng.random((T, N)) < 0.1] = 0.0
    return {"obs": rng.standard_normal((T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)),
            "logp": -rng.random((T, N)).astype(np.float32),
            "vf": np.zeros((T, N), np.float32),
            "rewards": rng.standard_normal((T, N)).astype(np.float32),
            "dones": rng.random((T, N)) < 0.1,
            "truncs": np.zeros((T, N), bool), "valid": valid,
            "bootstrap": np.zeros(N, np.float32), "episode_returns": []}


def _transitions(rng, n=40):
    return {"obs": rng.standard_normal((n, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, 3)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


def _assert_columns(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def _write(io, tmp, seed):
    rng = np.random.default_rng(seed)
    io.write_fragments([_fragment(rng), _fragment(rng)], str(tmp / "frags"))
    io.write_transitions(_transitions(rng), str(tmp / "trans"))
    return tmp


def _manifest(path):
    """The manifest's entries without their (time- and uuid-named)
    files."""
    entries = [json.loads(line) for line in
               (path / "manifest.jsonl").read_text().splitlines()]
    return [{k: v for k, v in e.items() if k != "file"} for e in entries]


def test_shards_written_by_jax_read_by_the_port(tmp_path):
    """The JAX writer's fragments (invalid rows dropped) and transitions,
    read by the port's load_columns: the columns the writer was given."""
    _write(jio, tmp_path, 0)
    rng = np.random.default_rng(0)
    frags = [_fragment(rng), _fragment(rng)]
    trans = _transitions(rng)
    got = tio.load_columns(str(tmp_path / "frags"))
    valid = np.concatenate([f["valid"].reshape(-1) > 0 for f in frags])
    for k in ("obs", "actions", "rewards", "dones", "logp"):
        want = np.concatenate([f[k].reshape(64, *f[k].shape[2:])
                               for f in frags])[valid]
        np.testing.assert_array_equal(got[k], want, err_msg=k)
        assert got[k].dtype == want.dtype
    _assert_columns(tio.load_columns(str(tmp_path / "trans")), trans)


def test_shards_written_by_the_port_read_by_jax(tmp_path, ray_start_regular):
    """The reverse: the port's shards and manifest through the JAX
    package's reader (a Dataset of the shards), equal to what the JAX
    writer writes from the same inputs."""
    _write(tio, tmp_path / "port", 0)
    _write(jio, tmp_path / "jax", 0)
    for sub in ("frags", "trans"):
        got = jio.load_columns(str(tmp_path / "port" / sub))
        _assert_columns(got, jio.load_columns(str(tmp_path / "jax" / sub)))
        _assert_columns(tio.load_columns(str(tmp_path / "port" / sub)), got)
        assert _manifest(tmp_path / "port" / sub) == _manifest(
            tmp_path / "jax" / sub)
    with pytest.raises(ValueError, match="ragged"):
        tio.write_transitions({"obs": np.zeros((2, 1)),
                               "actions": np.zeros(3)}, str(tmp_path / "x"))
    ds = tio.read_experiences(str(tmp_path / "port" / "trans"))
    assert ds.count() == len(got["actions"])


def test_read_experiences_dataset_matches_the_jax_package(
        tmp_path, ray_start_regular):
    """Three shards in one directory: the port's read_experiences Dataset
    gives the JAX package's rows (a block a shard, sorted by file name),
    and load_columns, which reads through it, the JAX package's
    columns."""
    rng = np.random.default_rng(3)
    for n in (7, 300, 21):
        tio.write_transitions(_transitions(rng, n), str(tmp_path))
    ds, jds = (io.read_experiences(str(tmp_path)) for io in (tio, jio))
    got, want = ds.take_all(), jds.take_all()
    assert len(got) == len(want) == 328
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    _assert_columns(tio.load_columns(str(tmp_path)),
                    jio.load_columns(str(tmp_path)))


@pytest.mark.parametrize("n,batch", [(40, 8), (40, 12), (5, 8)])
def test_iter_offline_batches_gives_the_same_rows(n, batch):
    """A tail that does not fill a batch is dropped; a corpus smaller than
    one batch yields it whole once."""
    cols = _transitions(np.random.default_rng(1), n)
    want = list(jio.iter_offline_batches(cols, batch, epochs=2, seed=3))
    got = list(tio.iter_offline_batches(cols, batch, epochs=2, seed=3))
    assert len(got) == len(want) == 2 * max(n // batch, 1)
    for g, w in zip(got, want):
        _assert_columns(g, w)


@pytest.mark.parametrize("gamma", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_monte_carlo_returns_exact(gamma):
    """Short episodes (the vectorized path) and, at gamma 0.5, episodes
    longer than its scaled-cumsum horizon (the chunked path); a trailing
    partial episode."""
    rng = np.random.default_rng(2)
    rewards = rng.standard_normal(500).astype(np.float32)
    dones = (rng.random(500) < 0.02).astype(np.float32)
    dones[-1] = 0.0
    got = tmarwil.monte_carlo_returns(rewards, dones, gamma)
    np.testing.assert_array_equal(
        got, jmarwil.monte_carlo_returns(rewards, dones, gamma))
    assert got.dtype == np.float32


def _offline_batch(rng, n=32):
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "returns": (3 * rng.standard_normal(n)).astype(np.float32)}


LEARNERS = {
    "bc": (lambda mod: mod.BCLearner, {}),
    "marwil": (lambda mod: mod.MARWILLearner,
               {"beta": 1.0, "vf_coeff": 0.5, "max_weight": 5.0}),
}


@pytest.mark.parametrize("name", list(LEARNERS))
def test_bc_and_marwil_losses_and_update_match_jax(name):
    cls, kw = LEARNERS[name]
    jmod, tmod = (jbc, tbc) if name == "bc" else (jmarwil, tmarwil)
    jl = cls(jmod)(jrl.MLPModule(4, 2), lr=1e-3, grad_clip=0.5, **kw)
    tl = cls(tmod)(trl.MLPModule(4, 2), lr=1e-3, grad_clip=0.5,
                   device="cpu", **kw)
    tl.set_weights(jl.get_weights())
    batch = _offline_batch(np.random.default_rng(4))
    jloss, jmet = jl.loss(jl.params, {k: jax.numpy.asarray(v)
                                      for k, v in batch.items()},
                          jax.random.key(0))
    tloss, tmet = tl.loss(tl.params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, None)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_TOL)
    start = jl.get_weights()
    want = jl.update(batch, shuffle=False)
    got = tl.update(batch, shuffle=False)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)
    for s, j, t in zip(jax.tree.leaves(start), jax.tree.leaves(
            jl.get_weights()), tree_leaves(tl.get_weights())):
        d = np.asarray(j) - s
        if np.linalg.norm(d) == 0:  # BC leaves the value head alone
            assert np.array_equal(t, s)
        else:
            assert np.linalg.norm((t - s) - d) / np.linalg.norm(d) \
                < DELTA_REL_L2


def test_offline_algorithms_train_from_shards(tmp_path):
    """BC and MARWIL through XConfig().offline_data(...).build() on the
    CPU: no env steps, the configured SGD steps, changed weights."""
    rng = np.random.default_rng(5)
    tio.write_fragments([_fragment(rng, T=32, N=8)], str(tmp_path))
    creator = chip_smoke.batched_creator(CartPoleBatchedEnv)
    for cfg, key in ((tbc.BCConfig(), "bc_nll"),
                     (tmarwil.MARWILConfig().marwil(beta=0.5), "vf_loss")):
        algo = (cfg.environment(env_creator=creator)
                .offline_data(input_path=str(tmp_path),
                              steps_per_iteration=3)
                .training(minibatch_size=32).resources(device="cpu")
                .build())
        before = algo.learner_group.get_weights()
        r = algo.train()
        assert r["env_steps_this_iter"] == 0 and r["sgd_steps_this_iter"] == 3
        assert np.isfinite(r[key])
        assert any(not np.array_equal(a, b) for a, b in zip(
            tree_leaves(before), tree_leaves(
                algo.learner_group.get_weights())))
        algo.stop()


# ------------------------------------------------------------ multi-agent

def test_multi_agent_batched_env_matches_jax():
    """Columns, rewards, flags and the dead mask over scripted actions
    through two whole episodes of three instances (agent b truncated
    after 5 steps of 8, dead for the rest)."""
    jenv = jma.MultiAgentBatchedEnv(chip_smoke.TwoAgentEnv, 3, seed=2)
    tenv = tma.MultiAgentBatchedEnv(chip_smoke.TwoAgentEnv, 3, seed=2)
    assert tenv.num_envs == jenv.num_envs == 6
    assert tenv.autoreset_mode == jenv.autoreset_mode == "same_step"
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    actions = np.random.default_rng(3).integers(0, 2, (17, 6))
    dead_seen = 0
    for a in actions:
        want, got = jenv.step(a), tenv.step(a)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(tenv.dead_mask(), jenv.dead_mask())
        dead_seen += int(tenv.dead_mask().sum())
    assert dead_seen == 3 * 3 * 2  # b's 3 dead steps, 2 episodes, 3 envs
    creator = tma.make_multi_agent_creator(chip_smoke.TwoAgentEnv)
    assert creator.makes_batched_env and creator(5).num_envs == 6


def test_ppo_iteration_on_a_multi_agent_env():
    """Shared-policy PPO over 4 instances' columns, one iteration: each
    live column's steps counted (b's dead steps masked)."""
    algo = (PPOConfig()
            .environment(env_creator=tma.make_multi_agent_creator(
                chip_smoke.TwoAgentEnv))
            .env_runners(num_envs_per_env_runner=8,
                         rollout_fragment_length=16)
            .training(minibatch_size=32, num_epochs=1)
            .resources(device="cpu").build())
    r = algo.train()
    assert r["env_steps_this_iter"] == 4 * (16 + 10)
    assert np.isfinite(r["total_loss"]) and r["grad_norm"] > 0
    algo.stop()
