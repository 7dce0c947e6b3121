"""The port's training path (ray_tpu_torch/models/transformer.py loss and
remat, ray_tpu_torch/ops/fused_ce.py, ray_tpu_torch/train/step.py) against
the JAX package's.

The same params (JAX ``init_params`` -> numpy -> ``params_from_numpy``) and
the same seeded tokens go through both sides with ``dtype=float32``.
Tolerances: loss within 1e-5 relative; gradients within atol/rtol 1e-4
(f32, another summation order over up to 2 x 24 tokens and a 512 vocab);
after three AdamW steps, each leaf's update (param after minus param
before) within 1e-3 relative L2 of optax's. Not per element: where a
gradient is near 0, Adam's m / sqrt(v) turns its last-digit differences
into up to a full step of lr (measured: one element of w_down off by
9.7e-5, a third of a step).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import configs as jconfigs
from ray_tpu.models import transformer as jtfm
from ray_tpu.ops import fused_ce as jfce
from ray_tpu_torch import convert
from ray_tpu_torch.models import configs as tconfigs
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import fused_ce as tfce
from ray_tpu_torch.train import step as tstep

torch.set_num_threads(2)

ATOL = RTOL = 1e-4


def _pair(name, **kw):
    jcfg = getattr(jconfigs, name)(dtype=jnp.float32, **kw)
    tcfg = getattr(tconfigs, name)(dtype=torch.float32, **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jparams = jtfm.init_params(jax.random.key(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, convert.params_from_numpy(tree, tcfg, "cpu")


def _batch(vocab, B, S, seed, mask=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if mask:
        b["mask"] = (rng.random((B, S)) > 0.2).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


def _named_leaves(tree):
    """(name, leaf) of a param tree, the same order on both sides."""
    out = [(k, v) for k, v in sorted(tree.items()) if k != "layers"]
    return out + [("layers." + k, v)
                  for k, v in sorted(tree["layers"].items())]


def _torch_grads(params, loss):
    names, leaves = zip(*_named_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(loss(params), leaves)
    for t in leaves:
        t.requires_grad_(False)
    return dict(zip(names, grads))


def _assert_grads_match(tgrads, jgrads):
    jnamed = dict(_named_leaves(jgrads))
    assert sorted(tgrads) == sorted(jnamed)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jnamed[name]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("name", ["llama_tiny", "gpt2_tiny"])
def test_loss_and_grads_match_jax(name, shift):
    jcfg, tcfg = _pair(name)
    jparams, tparams = _params(jcfg, tcfg)
    jb, tb = _batch(tcfg.vocab_size, 2, 25 if shift else 24, 7)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jb, jcfg, shift_inputs=shift)))(jparams)
    loss = ttfm.loss_fn(tparams, tb, tcfg, shift_inputs=shift)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    tgrads = _torch_grads(tparams, lambda p: ttfm.loss_fn(
        p, tb, tcfg, shift_inputs=shift))
    _assert_grads_match(tgrads, jgrads)


def test_fused_ce_loss_fn_matches_jax():
    """The cfg.fused_ce branch of loss_fn, shift convention, masked."""
    jcfg, tcfg = _pair("llama_tiny", fused_ce=True)
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    jb, tb = _batch(tcfg.vocab_size, 2, 17, 3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jb, jcfg, shift_inputs=True)))(jparams)
    tgrads = _torch_grads(tparams, lambda p: ttfm.loss_fn(
        p, tb, tcfg, shift_inputs=True))
    loss = ttfm.loss_fn(tparams, tb, tcfg, shift_inputs=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads_match(tgrads, jgrads)


def _jax_fwd_kernel_calls(jaxpr) -> int:
    """Pallas forward calls (3 operands: q, k, v; the backward kernels take
    6) in a jaxpr and every sub-jaxpr, each scan body counted once."""
    from jax.extend import core as jcore

    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call" and len(eqn.invars) == 3:
            n += 1
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    n += _jax_fwd_kernel_calls(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    n += _jax_fwd_kernel_calls(sub)
    return n


POLICIES = [None, "full", "dots", "dots_attn", "min", "half_dots",
            "half_full"]


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_grads_and_forward_calls(policy, monkeypatch):
    """Every policy gives the no-remat gradients, and launches the flash
    forward as often per step as the JAX package's gradient program runs
    its Pallas forward: once per layer, plus once per layer the policy
    recomputes it in the backward. With L = 4: L for none and "min", 2L
    for "full", "dots" and "dots_attn" (the JAX "dots_attn" saves the
    attention output but still re-runs the kernel for its unnamed lse),
    L + L/2 for "half_*". The JAX count is read from its jaxpr, where each
    scan body appears once: times L, or L/2 for the two halves of
    half_*."""
    monkeypatch.setenv("RTPU_ATTN_IMPL", "flash")
    L = 4
    remat = dict(remat=policy is not None, remat_policy=policy or "dots")
    jcfg, tcfg = _pair("llama_tiny", n_layers=L, **remat)
    _, tparams = _params(jcfg, tcfg, seed=2)
    jb, tb = _batch(tcfg.vocab_size, 1, 17, 5, mask=False)
    jparams = jax.eval_shape(
        lambda: jtfm.init_params(jax.random.key(0), jcfg))
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda p: jtfm.loss_fn(p, jb, jcfg, shift_inputs=True)))(jparams)
    per_scan = L // 2 if policy and policy.startswith("half") else L
    want = _jax_fwd_kernel_calls(jaxpr.jaxpr) * per_scan

    calls = []
    fwd = tfa.flash_attention_fwd

    def counted(*args):
        calls.append(1)
        return fwd(*args)

    monkeypatch.setattr(tfa, "flash_attention_fwd", counted)
    loss = functools.partial(ttfm.loss_fn, batch=tb, shift_inputs=True)
    grads = _torch_grads(tparams, lambda p: loss(p, cfg=tcfg))
    assert len(calls) == want == {
        None: L, "min": L, "full": 2 * L, "dots": 2 * L,
        "dots_attn": 2 * L}.get(policy, L + L // 2)
    if policy is not None:
        plain = tconfigs.llama_tiny(dtype=torch.float32, n_layers=L)
        ref = _torch_grads(tparams, lambda p: loss(p, cfg=plain))
        for name, g in grads.items():
            torch.testing.assert_close(g, ref[name], msg=name)


@pytest.mark.parametrize("policy", [None, "full", "dots", "dots_attn"])
def test_dots_keeps_projections_from_the_forward(policy, monkeypatch):
    """Under "dots" the backward's recompute takes the projections' outputs
    from the forward (5 a layer for llama_tiny's GQA: wq, wkv, wo,
    w_gate_up, w_down) and runs only the work between them; "full" runs
    them again."""
    L = 2
    cfg = tconfigs.llama_tiny(dtype=torch.float32, n_layers=L,
                              remat=policy is not None,
                              remat_policy=policy or "dots")
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 9), dtype=torch.long)
    calls = []
    matmul = ttfm._matmul
    monkeypatch.setattr(ttfm, "_matmul",
                        lambda h, w: calls.append(1) or matmul(h, w))
    _torch_grads(params, lambda p: ttfm.loss_fn(
        p, {"tokens": tokens}, cfg, shift_inputs=True))
    assert len(calls) == 5 * L * (2 if policy == "full" else 1)


def test_unknown_remat_policy_raises():
    cfg = tconfigs.llama_tiny(dtype=torch.float32, remat=True,
                              remat_policy="dotz")
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="dotz"):
        ttfm.loss_fn(params, {"tokens": tokens}, cfg)


@pytest.mark.parametrize("chunk", [0, 16, 64])
def test_fused_ce_matches_jax_and_unfused(chunk):
    rng = np.random.default_rng(chunk)
    M, d, V = 48, 32, 256
    x = rng.standard_normal((M, d)).astype(np.float32)
    head = (rng.standard_normal((d, V)) * 0.1).astype(np.float32)
    targets = rng.integers(0, V, M).astype(np.int32)
    valid = (rng.random(M) > 0.2).astype(np.float32)
    jloss, (jdx, jdh) = jax.value_and_grad(jfce.fused_ce, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(targets),
        jnp.asarray(valid), chunk)
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, head))
    tt, tv = torch.from_numpy(targets).long(), torch.from_numpy(valid)
    loss = tfce.fused_ce(tx, th, tt, tv, chunk)
    dx, dh = torch.autograd.grad(loss, (tx, th))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-6,
                               rtol=1e-4)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=1e-6,
                               rtol=1e-4)
    # The unfused path: logits, then token_cross_entropy.
    ref = ttfm.token_cross_entropy((tx @ th)[None], tt[None], tv[None])
    rdx, rdh = torch.autograd.grad(ref, (tx, th))
    torch.testing.assert_close(loss, ref, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(dx, rdx, atol=1e-6, rtol=1e-4)
    torch.testing.assert_close(dh, rdh, atol=1e-6, rtol=1e-4)


def test_pick_chunk_matches_jax_and_bad_chunk_raises():
    for V in (32000, 50257, 128256, 512, 97, 4096, 8191):
        assert tfce._pick_chunk(V) == jfce._pick_chunk(V), V
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="divide"):
        tfce.fused_ce(x, torch.zeros(8, 100), torch.zeros(4).long(),
                      torch.ones(4), 48)


def test_three_adamw_steps_track_optax():
    """TrainStep's default optimizer against optax.adamw(3e-4,
    weight_decay=0.0) over three steps of the same batch: the loss of each
    step and every param after the last."""
    jcfg, tcfg = _pair("gpt2_tiny")
    jparams, tparams = _params(jcfg, tcfg, seed=4)
    start = {k: v.numpy().copy() for k, v in _named_leaves(tparams)}
    jb, tb = _batch(tcfg.vocab_size, 2, 17, 9, mask=False)
    opt = optax.adamw(3e-4, weight_decay=0.0)
    jstate = opt.init(jparams)
    @jax.jit
    def jstep(params, state):
        loss, g = jax.value_and_grad(
            lambda p: jtfm.loss_fn(p, jb, jcfg, shift_inputs=True))(params)
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state, loss

    ts = tstep.transformer_train_step(tcfg, device="cpu", shift_inputs=True)
    topt = ts.init_opt_state(tparams)
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate)
        tparams, topt, loss = ts.step(tparams, topt, tb)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jnamed = dict(_named_leaves(jparams))
    for name, t in _named_leaves(tparams):
        moved = t.detach().numpy() - start[name]
        ref = np.asarray(jnamed[name]) - start[name]
        rel = np.linalg.norm(moved - ref) / np.linalg.norm(ref)
        assert rel <= 1e-3, (name, rel)
    group = topt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 0.0)


def test_train_step_init_and_eval_on_cpu():
    cfg = tconfigs.llama_tiny(dtype=torch.float32)
    ts = tstep.transformer_train_step(cfg, device="cpu")
    params, opt = ts.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    before = float(ts.eval_loss(params, {"tokens": tokens}))
    assert abs(before - np.log(cfg.vocab_size)) < 0.5
    for _ in range(3):
        params, opt, loss = ts.step(params, opt, {"tokens": tokens})
        assert not loss.requires_grad
    assert float(ts.eval_loss(params, {"tokens": tokens})) < before


def test_train_step_without_device_raises_when_cuda_is_absent(monkeypatch):
    cfg = tconfigs.llama_tiny(dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.transformer_train_step(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        tstep.transformer_train_step(cfg, device="cpu",
                                     pipeline_microbatches=2)
    ts = tstep.transformer_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        ts.init_opt_state({"embed": torch.empty(2, device="meta"),
                           "layers": {}})
