"""The port's RL stack (ray_tpu_torch/rllib) against the JAX package's.

The same params (the JAX module's init, as numpy) and the same seeded
numpy inputs go through both sides, on the CPU. Tolerances: module
forwards within 1e-5 (f32; the CNN at 44x44x4, which keeps every layer of
NATURE_CONV and leaves a 2x2x64 map, so the flatten order shows); GAE and
v-trace within 1e-6; batch building equal (the GAE-derived columns within
1e-6); the learners' loss and metrics within 1e-5 relative on one batch,
and the parameter change after 3 updates (shuffle off, the gradient clip
active, Adam's bias correction at steps 1-12) within 1e-4 relative L2 per
leaf. Sampling draws from torch generators, not jax.random, so the
runners are compared with greedy or near-deterministic policies.

The JAX modules are imported inside the ``J`` fixture: the gloo ranks of
the mesh-learner test re-import this module and need none of them.
"""
import multiprocessing
import pickle
import traceback
import types

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import spaces
from ray_tpu_torch.rllib.algorithms import appo as tappo
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.core import catalog as tcatalog
from ray_tpu_torch.rllib.core import rl_module as trl
from ray_tpu_torch.rllib.core.learner import tree_leaves, tree_map
from ray_tpu_torch.rllib.env import vector_env as tvec
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.utils import episodes as teps
from ray_tpu_torch.rllib.utils import gae as tgae
from ray_tpu_torch.rllib.utils import rollout as troll

torch.set_num_threads(2)

FWD_TOL = 1e-5
GAE_TOL = 1e-6
METRIC_RTOL = 1e-5
DELTA_REL_L2 = 1e-4
CNN_OBS = (44, 44, 4)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules under test."""
    import jax

    from ray_tpu.rllib.algorithms import appo, impala, ppo
    from ray_tpu.rllib.core import catalog, rl_module
    from ray_tpu.rllib.env import env_runner, vector_env
    from ray_tpu.rllib.utils import episodes, gae, rollout

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, appo=appo, impala=impala, ppo=ppo,
        catalog=catalog, rl=rl_module, runner=env_runner, vec=vector_env,
        episodes=episodes, gae=gae, rollout=rollout)


def _modules(J, kind):
    if kind == "mlp":
        return J.rl.MLPModule(4, 2), trl.MLPModule(4, 2)
    return (J.catalog.CNNModule(CNN_OBS, 6),
            tcatalog.CNNModule(CNN_OBS, 6))


def _np_params(J, module, seed=0):
    return J.jax.tree.map(np.asarray, module.init(J.jax.random.key(seed)))


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _obs(kind, n, rng, dtype=np.float32):
    if kind == "mlp":
        return rng.standard_normal((n, 4)).astype(np.float32)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, *CNN_OBS), dtype=np.uint8)
    return rng.random((n, *CNN_OBS)).astype(np.float32)


# --------------------------------------------------------------- modules

@pytest.mark.parametrize("kind,dtype", [("mlp", np.float32),
                                        ("cnn", np.uint8),
                                        ("cnn", np.float32)])
def test_module_forward_matches_jax(J, kind, dtype):
    """uint8 pixels are scaled by 1/255, f32 ones are not; the conv stack
    flattens in (H, W, C) order."""
    jm, tm = _modules(J, kind)
    params = _np_params(J, jm)
    obs = _obs(kind, 5, np.random.default_rng(1), dtype)
    want = jm.forward(params, J.jnp.asarray(obs))
    got = tm.forward(_to_torch(params), torch.from_numpy(obs))
    for key in ("logits", "vf"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=FWD_TOL, rtol=FWD_TOL)
    greedy = tm.forward_inference(_to_torch(params), torch.from_numpy(obs))
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jm.forward_inference(params,
                                                        J.jnp.asarray(obs))))


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_module_init_has_the_reference_tree(J, kind):
    """Names, shapes and layouts (HWIO convs) of the JAX init; the dense
    weights orthogonal up to their scale."""
    jm, tm = _modules(J, kind)
    want = _np_params(J, jm)
    got = tm.init(torch.Generator().manual_seed(0))
    shapes = lambda t: tree_map(lambda a: tuple(a.shape), t)
    assert shapes(got) == shapes(want)
    w = (got["pi"][0] if kind == "mlp" else got["trunk"])["w"]
    # Scale sqrt(2); the shorter side's rows or columns are orthonormal.
    gram = (w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T) / 2.0
    np.testing.assert_allclose(gram.numpy(), np.eye(min(w.shape)),
                               atol=1e-4)


def test_categorical_logp_entropy_and_sampling(J):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    actions = rng.integers(0, 5, 6)
    jd = J.rl.CategoricalDist(J.jnp.asarray(logits))
    td = trl.CategoricalDist(torch.from_numpy(logits))
    np.testing.assert_allclose(td.logp(torch.from_numpy(actions)).numpy(),
                               np.asarray(jd.logp(J.jnp.asarray(actions))),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()),
                               atol=FWD_TOL, rtol=FWD_TOL)
    # Gumbel-max from a torch generator: the softmax's frequencies.
    one = trl.CategoricalDist(torch.tensor([[0.0, 1.0, -1.0]]).expand(
        40000, 3))
    draws = one.sample(torch.Generator().manual_seed(0))
    freq = np.bincount(draws.numpy(), minlength=3) / 40000
    np.testing.assert_allclose(freq, torch.softmax(
        torch.tensor([0.0, 1.0, -1.0]), 0).numpy(), atol=0.01)


def test_module_for_space_takes_the_ports_and_gymnasiums_spaces():
    import gymnasium as gym

    for box, disc in ((spaces.Box(-1, 1, (4,)), spaces.Discrete(2)),
                      (gym.spaces.Box(-1, 1, (4,)), gym.spaces.Discrete(2))):
        m = tcatalog.module_for_space(box, disc, {})
        assert isinstance(m, trl.MLPModule) and m.num_actions == 2
    m = tcatalog.module_for_space(spaces.Box(0, 255, CNN_OBS, np.uint8),
                                  gym.spaces.Discrete(6), {})
    assert isinstance(m, tcatalog.CNNModule) and m.obs_shape == CNN_OBS
    with pytest.raises(NotImplementedError):
        tcatalog.module_for_space(spaces.Box(-1, 1, (4,)),
                                  spaces.Box(-1, 1, (2,)), {})


# ---------------------------------------------------------- GAE, v-trace

def _gae_inputs(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            (rng.random(shape) < 0.2).astype(np.float32))


@pytest.mark.parametrize("shape", [(13,), (3, 9)])
def test_compute_gae_matches_jax(J, shape):
    rng = np.random.default_rng(3)
    r, v, d = _gae_inputs(rng, shape)
    boot = rng.standard_normal(shape[:-1]).astype(np.float32)
    want = J.gae.compute_gae(r, v, d, boot, gamma=0.97, lam=0.9)
    got = tgae.compute_gae(r, v, d, boot, gamma=0.97, lam=0.9)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == shape
        np.testing.assert_allclose(g, np.asarray(w), atol=GAE_TOL,
                                   rtol=GAE_TOL)
    # Tensors in, tensors out, on their device.
    got_t = tgae.compute_gae(*(torch.from_numpy(np.asarray(x))
                               for x in (r, v, d, boot)),
                             gamma=0.97, lam=0.9)
    assert isinstance(got_t[0], torch.Tensor)
    np.testing.assert_allclose(got_t[0].numpy(), got[0], rtol=0, atol=0)


def test_vtrace_matches_jax(J):
    rng = np.random.default_rng(4)
    r, v, d = _gae_inputs(rng, (3, 9))
    blogp = -rng.random((3, 9)).astype(np.float32)
    tlogp = -rng.random((3, 9)).astype(np.float32)
    boot = rng.standard_normal(3).astype(np.float32)
    want = J.gae.vtrace(blogp, tlogp, r, v, d, boot, gamma=0.95,
                        clip_rho=0.9, clip_c=1.1)
    got = tgae.vtrace(blogp, tlogp, r, v, d, boot, gamma=0.95,
                      clip_rho=0.9, clip_c=1.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GAE_TOL,
                                   rtol=GAE_TOL)


# ------------------------------------------------------- batch building

def _episodes(eps_mod, rng, n=5):
    out = []
    for i in range(n):
        T = int(rng.integers(2, 9))
        ep = eps_mod.SingleAgentEpisode()
        ep.observations = [rng.standard_normal(4).astype(np.float32)
                           for _ in range(T + 1)]
        ep.actions = [int(a) for a in rng.integers(0, 2, T)]
        ep.rewards = [float(x) for x in rng.standard_normal(T)]
        ep.logp = [float(x) for x in -rng.random(T)]
        ep.vf_preds = [float(x) for x in rng.standard_normal(T)]
        ep.terminated = i % 3 == 0
        ep.truncated = i % 3 == 1
        ep.bootstrap_value = float(rng.standard_normal())
        out.append(ep)
    return out


def _assert_batches(got, want, derived=()):
    assert sorted(got) == sorted(want)
    for k in want:
        if k in derived:
            np.testing.assert_allclose(got[k], want[k], atol=GAE_TOL,
                                       rtol=GAE_TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_episode_batches_match_jax(J):
    """episodes_to_batch (with and without the bootstrap fold, clipped at
    max_t), pad_batch_to_buckets and postprocess_episodes."""
    for gamma, max_t in ((None, 8), (0.9, 6)):
        args = dict(max_t=max_t, gamma=gamma)
        want = J.episodes.episodes_to_batch(
            _episodes(J.episodes, np.random.default_rng(5)), **args)
        got = teps.episodes_to_batch(
            _episodes(teps, np.random.default_rng(5)), **args)
        _assert_batches(got, want)
        _assert_batches(teps.pad_batch_to_buckets(got),
                        J.episodes.pad_batch_to_buckets(want))
    want = J.ppo.postprocess_episodes(
        _episodes(J.episodes, np.random.default_rng(6)), gamma=0.9, lam=0.8,
        max_t=7)
    got = tppo.postprocess_episodes(
        _episodes(teps, np.random.default_rng(6)), gamma=0.9, lam=0.8,
        max_t=7)
    _assert_batches(got, want, derived=("advantages", "value_targets"))


def _fragment(rng, T=7, N=3):
    return {
        "obs": rng.standard_normal((T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, N)),
        "logp": -rng.random((T, N)).astype(np.float32),
        "vf": rng.standard_normal((T, N)).astype(np.float32),
        "rewards": rng.standard_normal((T, N)).astype(np.float32),
        "dones": rng.random((T, N)) < 0.2,
        "truncs": rng.random((T, N)) < 0.1,
        "valid": (rng.random((T, N)) > 0.1).astype(np.float32),
        "bootstrap": rng.standard_normal(N).astype(np.float32),
    }


def test_fragments_to_ppo_batch_matches_jax(J):
    rng = np.random.default_rng(7)
    frags = [_fragment(rng), _fragment(rng)]
    want = J.rollout.fragments_to_ppo_batch(frags, gamma=0.95, lam=0.9)
    got = troll.fragments_to_ppo_batch(frags, gamma=0.95, lam=0.9)
    _assert_batches(got, want, derived=("advantages", "value_targets"))


def test_connector_shapes():
    """As tests/test_rllib.py::test_connector_shapes, on the port's copy."""
    from ray_tpu_torch.rllib.connectors import (ConnectorPipeline,
                                                FlattenObs, FrameStack,
                                                NormalizeObs)

    pipe = ConnectorPipeline([FrameStack(k=3), FlattenObs()])
    obs = np.ones((2, 4), np.float32)
    out = pipe(obs)
    assert out.shape == (2, 12)
    assert pipe.output_shape((4,)) == (12,)
    norm = NormalizeObs()
    x = np.random.default_rng(0).standard_normal((64, 4)).astype(
        np.float32) * 5
    y = norm(x)
    assert y.shape == x.shape and np.isfinite(y).all()


# -------------------------------------------------------------- learners

def _ppo_batch(kind, n, rng):
    mask = np.ones(n, np.float32)
    mask[rng.random(n) < 0.25] = 0.0
    return {"obs": _obs(kind, n, rng, np.uint8 if kind == "cnn"
                        else np.float32),
            "actions": rng.integers(0, 2, n),
            "logp": (-0.7 + 0.3 * rng.standard_normal(n)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": (3 * rng.standard_normal(n)).astype(np.float32),
            "mask": mask}


def _vtrace_batch(B, T, rng):
    mask = np.ones((B, T), np.float32)
    mask[:, T - 2:] = 0.0
    return {"obs": rng.standard_normal((B, T, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (B, T)),
            "logp": (-0.7 + 0.3 * rng.standard_normal((B, T))).astype(
                np.float32),
            "rewards": rng.standard_normal((B, T)).astype(np.float32),
            "dones": (rng.random((B, T)) < 0.15).astype(np.float32),
            "mask": mask,
            "bootstrap_value": rng.standard_normal(B).astype(np.float32)}


LEARNERS = {
    # name -> (module kind, JAX learner / config, port's, batch, minibatch)
    "ppo_mlp": ("mlp", "ppo", "PPOLearner", "PPOConfig", "ppo", 16),
    "ppo_cnn": ("cnn", "ppo", "PPOLearner", "PPOConfig", "ppo", 8),
    "impala": ("mlp", "impala", "IMPALALearner", "IMPALAConfig", "vtrace",
               None),
    "appo": ("mlp", "appo", "APPOLearner", "APPOConfig", "vtrace", None),
}
_PORT = {"ppo": tppo, "impala": timpala, "appo": tappo}


def _learner_pair(J, name, **cfg_kw):
    kind, mod, learner, config, _, _ = LEARNERS[name]
    jm, tm = _modules(J, kind)
    jcfg = getattr(getattr(J, mod), config)().training(**cfg_kw)
    tcfg = getattr(_PORT[mod], config)().training(**cfg_kw)
    jl = getattr(getattr(J, mod), learner)(jm, jcfg)
    tl = getattr(_PORT[mod], learner)(tm, tcfg, device="cpu")
    tl.set_weights(jl.get_weights())
    return jl, tl


def _batch_for(name, rng):
    kind, _, _, _, batch, _ = LEARNERS[name]
    return _ppo_batch(kind, 32, rng) if batch == "ppo" else _vtrace_batch(
        4, 6, rng)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(LEARNERS))
def test_learner_updates_match_jax(J, name):
    """One batch, 3 updates (PPO: 2 or 4 minibatches each, so 6 or 12 Adam
    steps), shuffle off, a gradient clip below every gradient norm."""
    # lr 1e-4: at 1e-3 the CNN's six steps carry rows across PPO's ratio
    # clip, whose kink turns one summation order's rounding into a few
    # per cent of the change (3-5e-2 per leaf at 1e-3, 1e-5 at 1e-4).
    jl, tl = _learner_pair(J, name, lr=1e-4, grad_clip=0.05,
                           entropy_coeff=0.01)
    start = jl.get_weights()
    batch = _batch_for(name, np.random.default_rng(8))
    # The loss and its metrics on the batch, at the same params.
    jloss, jmet = jl.loss(jl.params, {k: J.jnp.asarray(v)
                                      for k, v in batch.items()},
                          J.jax.random.key(0))
    tloss, tmet = tl.loss(tl.params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                          torch.Generator())
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=METRIC_RTOL)
    mb = LEARNERS[name][5]
    for i in range(3):
        want = jl.update(batch, minibatch_size=mb, shuffle=False)
        got = tl.update(batch, minibatch_size=mb, shuffle=False)
        assert sorted(got) == sorted(want)
        assert want["grad_norm"] > 0.05  # the clip is active
        if i == 0:
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-4)
    leaves = lambda t: J.jax.tree.leaves(t)
    for s, j, t in zip(leaves(start), leaves(jl.get_weights()),
                       leaves(tl.get_weights())):
        assert _rel_l2(t - s, j - s) < DELTA_REL_L2
    # The optimizer state carries across in optax's names (count, mu, nu).
    jstate = jl.get_state()["opt_state"]
    adam = jstate[1][0]
    tstate = tl.get_state()["opt_state"]
    assert tstate["count"] == int(adam.count) == 3 * (32 // mb if mb else 1)
    for j, t in zip(leaves(adam.mu), leaves(tstate["mu"])):
        assert _rel_l2(t, j) < DELTA_REL_L2


def test_learner_state_round_trips(J):
    jl, tl = _learner_pair(J, "ppo_mlp")
    batch = _batch_for("ppo_mlp", np.random.default_rng(9))
    tl.update(batch, minibatch_size=16, shuffle=True)
    state = tl.get_state()
    _, other = _learner_pair(J, "ppo_mlp")
    other.set_state(pickle.loads(pickle.dumps(state)))
    again = other.get_state()
    for a, b in zip(J.jax.tree.leaves(state), J.jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    # Both take the same next step.
    m1 = tl.update(batch, shuffle=False)
    m2 = other.update(batch, shuffle=False)
    assert m1 == m2


def test_set_state_leaves_the_callers_arrays_alone(J):
    """A state loaded into two learners gives both the same update: the
    moments are copied in, not shared with the caller's arrays (a CPU
    tensor made from numpy shares its memory, and Adam updates in
    place)."""
    _, tl = _learner_pair(J, "ppo_mlp")
    batch = _batch_for("ppo_mlp", np.random.default_rng(11))
    tl.update(batch, minibatch_size=16, shuffle=False)
    state = tl.get_state()
    kept = pickle.loads(pickle.dumps(state))
    weights = []
    for _ in range(2):
        _, other = _learner_pair(J, "ppo_mlp")
        other.set_state(state)
        other.update(batch, minibatch_size=16, shuffle=False)
        weights.append(other.get_weights())
    for a, b in zip(J.jax.tree.leaves(state), J.jax.tree.leaves(kept)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(*(J.jax.tree.leaves(w) for w in weights)):
        np.testing.assert_array_equal(a, b)


class _TF32Probe(torch.autograd.Function):
    """The identity, noting cuDNN's TF32 flag where autograd runs it."""
    seen: list = []

    @staticmethod
    def forward(ctx, x):
        _TF32Probe.seen.append(("forward", torch.backends.cudnn.allow_tf32))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _TF32Probe.seen.append(("backward", torch.backends.cudnn.allow_tf32))
        return g


def test_learner_backward_runs_with_tf32_off():
    """cuDNN computes a convolution's gradients under the flag in force
    when the backward runs, not the one of its forward: the learner runs
    its loss and backward with TF32 off (the reference's convs are f32),
    and leaves the flag as it found it."""
    class Probed(tcatalog.CNNModule):
        def forward(self, params, obs):
            out = super().forward(params, obs)
            return {**out, "logits": _TF32Probe.apply(out["logits"])}

    learner = tppo.PPOLearner(Probed(CNN_OBS, 2), tppo.PPOConfig(),
                              device="cpu")
    _TF32Probe.seen.clear()
    assert torch.backends.cudnn.allow_tf32  # torch's default
    learner.update(_ppo_batch("cnn", 8, np.random.default_rng(12)),
                   shuffle=False)
    assert _TF32Probe.seen == [("forward", False), ("backward", False)]
    assert torch.backends.cudnn.allow_tf32


# --------------------------------------------------- learner on 2 ranks

def _mesh_rank(rank, init, params, batch, results):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from ray_tpu_torch.parallel import MeshBootstrap, MeshSpec, make_mesh

        MeshBootstrap(init, 2, rank, device_type="cpu").initialize()
        mesh = make_mesh(MeshSpec(data=2), "cpu")
        learner = tppo.PPOLearner(trl.MLPModule(4, 2), tppo.PPOConfig(),
                                  mesh=mesh)
        learner.set_weights(params)
        metrics = [learner.update(batch, minibatch_size=16, shuffle=False)
                   for _ in range(2)]
        dist.destroy_process_group()
        results.put(("ok", rank, (metrics, learner.get_weights())))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))


def test_learner_on_two_gloo_ranks_matches_one_process(J, tmp_path):
    """data=2: each rank takes half of every minibatch; the mask sums of
    the halves differ (rank 0's rows all valid, rank 1's mostly masked),
    so a mean of per-rank means would not be the global mean."""
    rng = np.random.default_rng(10)
    batch = _ppo_batch("mlp", 32, rng)
    batch["mask"] = np.ones(32, np.float32)
    for start in (8, 24):  # the second half of each minibatch of 16
        batch["mask"][start:start + 8] = (rng.random(8) < 0.25)
    params = _np_params(J, J.rl.MLPModule(4, 2))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, f"file://{tmp_path}/rendezvous", params,
                               batch, results), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    one = tppo.PPOLearner(trl.MLPModule(4, 2), tppo.PPOConfig(),
                          device="cpu")
    one.set_weights(params)
    want = [one.update(batch, minibatch_size=16, shuffle=False)
            for _ in range(2)]
    try:
        got = [results.get(timeout=120) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    errors = [g for g in got if g[0] == "error"]
    assert not errors, errors[0][2]
    for _, _, (metrics, weights) in got:
        for m, w in zip(metrics, want):
            for k in w:
                np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)
        for a, b in zip(J.jax.tree.leaves(weights),
                        J.jax.tree.leaves(one.get_weights())):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------- env runners

def _batched(cls):
    def creator(n):
        return cls(n, seed=3)
    creator.makes_batched_env = True
    return creator


def test_fragment_layout_matches_the_jax_runner(J):
    """CartPoleBatchedEnv, 4 envs, two fragments of 40 steps: the policy's
    logits scaled so far apart that both samplers pick the greedy action
    whatever their noise, so the two runners walk the same episodes."""
    params = _np_params(J, J.rl.MLPModule(4, 2), seed=1)
    params["pi"][-1] = {k: v * 1e8 for k, v in params["pi"][-1].items()}
    jr = J.runner.SingleAgentEnvRunner(
        _batched(J.vec.CartPoleBatchedEnv), lambda: J.rl.MLPModule(4, 2),
        num_envs=4, seed=2, device="cpu")
    tr = SingleAgentEnvRunner(
        _batched(tvec.CartPoleBatchedEnv), lambda: trl.MLPModule(4, 2),
        num_envs=4, seed=2, device="cpu")
    jr.set_weights(params)
    tr.set_weights(params)
    for _ in range(2):
        want, got = jr.sample_fragment(40), tr.sample_fragment(40)
        assert sorted(got) == sorted(want)
        for k in ("obs", "actions", "rewards", "dones", "truncs", "valid",
                  "episode_returns"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        for k in ("vf", "bootstrap"):
            np.testing.assert_allclose(got[k], want[k], atol=FWD_TOL,
                                       rtol=FWD_TOL, err_msg=k)
    assert got["obs"].shape == (40, 4, 4) and got["bootstrap"].shape == (4,)
    # Under the scaled policy every logp is about 0 on both sides and the
    # actions carry the comparison. The logp column is held on the
    # unscaled policy: the port's runner samples a fragment, and its logp
    # is the JAX CategoricalDist's of the actions it took at the
    # observations it saw.
    unscaled = _np_params(J, J.rl.MLPModule(4, 2), seed=1)
    tr.set_weights(unscaled)
    got = tr.sample_fragment(40)
    logits = jr.module.forward(unscaled, J.jnp.asarray(
        got["obs"].reshape(-1, 4)))["logits"]
    want = J.rl.CategoricalDist(logits).logp(
        J.jnp.asarray(got["actions"].reshape(-1)))
    assert 0.05 < np.abs(got["logp"]).min()  # no longer about 0
    np.testing.assert_allclose(got["logp"].reshape(-1), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_greedy_episodes_match_the_jax_runner(J):
    """sample_episode_greedy on gymnasium's CartPole-v1, its reset seeded
    in the creator, and sample()'s episode chunks."""
    import gymnasium as gym

    def creator():
        env = gym.make("CartPole-v1")
        env.reset(seed=11)
        return env

    params = _np_params(J, J.rl.MLPModule(4, 2), seed=3)
    jr = J.runner.SingleAgentEnvRunner(creator, lambda: J.rl.MLPModule(4, 2),
                                       num_envs=2, seed=4, device="cpu")
    tr = SingleAgentEnvRunner(creator, lambda: trl.MLPModule(4, 2),
                              num_envs=2, seed=4, device="cpu")
    jr.set_weights(params)
    tr.set_weights(params)
    assert tr.sample_episode_greedy() == jr.sample_episode_greedy()
    chunks = tr.sample(50)
    assert sum(len(e) for e in chunks) >= 50
    assert all(len(e.observations) == len(e) + 1 for e in chunks)
    jr.stop()
    tr.stop()


# ------------------------------------------------------------ algorithms

def test_ppo_builds_trains_and_restores(tmp_path):
    """A local PPOConfig().build() on CartPoleBatchedEnv: 2 iterations,
    then save and restore into a new algorithm: the same learner state
    (params and Adam's count and moments), and its next iteration is the
    third."""
    def config():
        return (tppo.PPOConfig()
                .environment(env_creator=_batched(tvec.CartPoleBatchedEnv))
                .env_runners(num_envs_per_env_runner=8,
                             rollout_fragment_length=16)
                .training(minibatch_size=32, num_epochs=2)
                .resources(device="cpu").debugging(seed=1))

    algo = config().build()
    results = [algo.train() for _ in range(2)]
    assert [r["training_iteration"] for r in results] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and r["env_steps_this_iter"] == 128
               for r in results)
    path = algo.save(str(tmp_path / "ckpt"))
    other = config().build()
    other.restore(path)
    a, b = (x.learner_group.get_state() for x in (algo, other))
    # 2 iterations of 2 epochs over 4 minibatches of 32.
    assert a["opt_state"]["count"] == 2 * 2 * 4
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert other.train()["training_iteration"] == 3
    algo.stop()
    other.stop()


def test_ppo_cnn_iteration_on_pixels():
    """The chip's configuration at CPU size: the default CNNModule on
    CnnRolloutBenchEnv's uint8 frames (44x44x4 here), one iteration."""
    def creator(n):
        return tvec.CnnRolloutBenchEnv(n, obs_shape=CNN_OBS)
    creator.makes_batched_env = True
    algo = (tppo.PPOConfig().environment(env_creator=creator)
            .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=8)
            .training(minibatch_size=16, num_epochs=1)
            .resources(device="cpu").build())
    before = algo.learner_group.get_weights()
    result = algo.train()
    assert np.isfinite(result["total_loss"]) and result["grad_norm"] > 0
    assert result["env_steps_this_iter"] == 32
    after = algo.learner_group.get_weights()
    assert any(not np.array_equal(x, y)
               for x, y in zip(tree_leaves(before), tree_leaves(after)))
    algo.stop()


@pytest.mark.parametrize("algo_name", ["ppo_episodes", "impala", "appo"])
def test_episode_paths_train_on_gym_cartpole(algo_name):
    """PPO's episode path and IMPALA's and APPO's synchronous local branch,
    one iteration each on gymnasium's CartPole-v1."""
    cfg = {"ppo_episodes": tppo.PPOConfig().env_runners(use_fragments=False),
           "impala": timpala.IMPALAConfig(),
           "appo": tappo.APPOConfig()}[algo_name]
    cfg = (cfg.environment("CartPole-v1")
           .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
           .training(train_batch_size=64, minibatch_size=32, num_epochs=1,
                     max_episode_len=64)
           .resources(device="cpu"))
    if algo_name != "ppo_episodes":
        cfg.training(updates_per_step=2)
    algo = cfg.build()
    result = algo.train()
    assert np.isfinite(result["total_loss"])
    assert result["timesteps_total"] > 0
    algo.stop()
