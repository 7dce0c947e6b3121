"""The port's off-policy and offline learners (DQN, SAC, CQL, BC, MARWIL)
on a learner mesh of two gloo ranks (data=2) against the same learner on
one device, on the CPU.

Each rank takes half of every minibatch and the gradients and metrics are
summed over the ranks, so each loss must divide its sums by the whole
minibatch's row count: a mean of per-rank means would report losses and a
gradient norm twice the one device's. The minibatches carry importance
weights (DQN, SAC, CQL) whose halves differ, and SAC/CQL draw their noise
for the whole minibatch from the same seed on every rank, so both sides
make the same draws. Tolerances: the metrics (losses, the global norm
before the clip, SAC's alpha) within 1e-5, the |TD errors| gathered from
both ranks within 1e-5, and the parameter change of two updates within
1e-4 relative L2 per leaf.

No module here imports jax: the ranks re-import this one.
"""
import multiprocessing
import traceback

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.core import rl_module as trl
from ray_tpu_torch.rllib.core.learner import tree_leaves
from ray_tpu_torch.rllib.offline import bc as tbc
from ray_tpu_torch.rllib.offline import cql as tcql
from ray_tpu_torch.rllib.offline import marwil as tmarwil

torch.set_num_threads(2)

LOSS_TOL = 1e-5
DELTA_REL_L2 = 1e-4
ROWS = 16
CLIP = 0.1  # below every first gradient norm here: the clip bites
OBS, ACT = 3, 2
LOW = np.array([-2.0, -1.0], np.float32)
HIGH = np.array([2.0, 3.0], np.float32)


def _batch(name, rng):
    n = ROWS
    if name in ("bc", "marwil"):
        return {"obs": rng.standard_normal((2 * n, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, 2 * n),
                "returns": (3 * rng.standard_normal(2 * n)).astype(
                    np.float32)}
    obs_dim = 4 if name == "dqn" else OBS
    b = {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
         "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
         "rewards": rng.standard_normal(n).astype(np.float32),
         "dones": (rng.random(n) < 0.2).astype(np.float32),
         # Rank 0's half weighs far more than rank 1's.
         "weights": np.concatenate([rng.uniform(0.5, 1.0, n // 2),
                                    rng.uniform(0.0, 0.1, n // 2)]).astype(
                                        np.float32)}
    b["actions"] = (rng.integers(0, 2, n).astype(np.int32) if name == "dqn"
                    else rng.uniform(LOW, HIGH, (n, ACT)).astype(np.float32))
    return b


def _learner(name, mesh=None):
    place = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    if name == "dqn":
        cfg = tdqn.DQNConfig().training(lr=1e-3, grad_clip=CLIP)
        return tdqn.DQNLearner(tdqn.DQNModule(4, 2), cfg, **place)
    if name in ("sac", "cql"):
        cls, cfg = ((tsac.SACLearner, tsac.SACConfig()) if name == "sac"
                    else (tcql.CQLLearner, tcql.CQLConfig()))
        cfg.training(lr=1e-3, grad_clip=CLIP, tau=0.5)
        return cls(tsac.SACModule(OBS, ACT, LOW, HIGH, hiddens=(16, 16)),
                   cfg, seed=3, **place)
    if name == "bc":
        return tbc.BCLearner(trl.MLPModule(4, 2), lr=1e-3, grad_clip=CLIP,
                             **place)
    return tmarwil.MARWILLearner(trl.MLPModule(4, 2), beta=1.0,
                                 vf_coeff=0.5, max_weight=5.0, lr=1e-3,
                                 grad_clip=CLIP, **place)


NAMES = ("dqn", "sac", "cql", "bc", "marwil")


def _run(name, learner):
    """Two updates; (metrics, |TD errors|, the weights before and after,
    targets). Each side's change is taken from its own init: the init's
    orthogonal factors round with the thread count."""
    batch = _batch(name, np.random.default_rng(NAMES.index(name)))
    start = tree_leaves(learner.get_weights())
    metrics, td = [], None
    for _ in range(2):
        if name == "dqn":
            metrics.append(learner.update_td(batch))
        elif name in ("sac", "cql"):
            metrics.append(learner.update_sac(batch))
        else:
            metrics.append(learner.update(batch, minibatch_size=ROWS,
                                          shuffle=False))
        if name in ("dqn", "sac", "cql"):
            td = learner.take_td_errors()
    targets = ([t.numpy().copy() for t in tree_leaves(learner._target_q)]
               if name in ("sac", "cql") else [])
    return metrics, td, (start, tree_leaves(learner.get_weights())), targets


def _mesh_rank(rank, init, results):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from ray_tpu_torch.parallel import MeshBootstrap, MeshSpec, make_mesh

        MeshBootstrap(init, 2, rank, device_type="cpu").initialize()
        mesh = make_mesh(MeshSpec(data=2), "cpu")
        out = {name: _run(name, _learner(name, mesh)) for name in NAMES}
        dist.destroy_process_group()
        results.put(("ok", rank, out))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every learner's run on both ranks (started once for the module)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{tmp_path_factory.mktemp('pg')}/rendezvous"
    procs = [ctx.Process(target=_mesh_rank, args=(r, init, results),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = [results.get(timeout=180) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    errors = [g for g in got if g[0] == "error"]
    assert not errors, errors[0][2]
    return [g[2] for g in got]


@pytest.mark.parametrize("name", NAMES)
def test_learner_on_two_gloo_ranks_matches_one_device(two_ranks, name):
    want_m, want_td, (want_s, want_w), want_t = _run(name, _learner(name))
    assert want_m[0]["grad_norm"] > CLIP
    for rank in two_ranks:
        got_m, got_td, (got_s, got_w), got_t = rank[name]
        for g, w in zip(got_m, want_m):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_TOL,
                                           atol=1e-7, err_msg=k)
        if want_td is not None:
            assert got_td.shape == want_td.shape == (ROWS,)
            np.testing.assert_allclose(got_td, want_td, rtol=LOSS_TOL,
                                       atol=1e-6)
        for gs, g, ws, w in zip(got_s, got_w, want_s, want_w):
            d = w - ws
            if np.linalg.norm(d) == 0:  # a head no loss reaches
                assert np.array_equal(g, gs)
            else:
                assert np.linalg.norm((g - gs) - d) / np.linalg.norm(d) \
                    < DELTA_REL_L2
        for g, w in zip(got_t, want_t):
            np.testing.assert_allclose(g, w, rtol=LOSS_TOL, atol=1e-7)
