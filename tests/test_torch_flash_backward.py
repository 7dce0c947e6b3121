"""The port's flash-attention backward (K2 and K3's plain versions, the
autograd path) against the JAX package's Pallas backward, run in interpret
mode on the CPU as tests/test_flash_attention.py runs it.

The same seeded numpy inputs go through both sides in f32. Tolerance:
atol/rtol 1e-4 for gradients (f32 sums over up to 192 keys or rows, in
another order and tiling than the Pallas grid), 2e-5 for the forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu.ops.flash_attention import flash_bwd_core as jax_bwd_core
from ray_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

ATOL = RTOL = 1e-4


def _arrays(seed, B, S, H, KVH, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KVH, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KVH, D), dtype=np.float32)
    do = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, do


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bhsd(a):
    return jnp.asarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("S,block,H,KVH", [(96, 64, 2, 2), (100, 64, 4, 2),
                                           (192, 128, 4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_with_external_stats(causal, H, KVH,
                                                           S, block):
    """K2/K3's plain versions against the Pallas kernels, fed the same
    lse and delta from outside: the forward's lse plus noise and a random
    delta, as a ring step passes statistics that are not its own."""
    B, D = 1, 32
    q, k, v, do = _arrays(S + 10 * H + KVH, B, S, H, KVH, D)
    scale = D ** -0.5
    rng = np.random.default_rng(S)
    _, lse = tfa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), scale,
                                           causal)
    lse = lse.numpy() + 0.1 * rng.standard_normal(lse.shape).astype(
        np.float32)
    delta = rng.standard_normal((B, H, S, 1)).astype(np.float32)
    jdq, jdk, jdv = jax_bwd_core(
        _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do), jnp.asarray(lse),
        jnp.asarray(delta), scale=scale, causal=causal, block_q=block,
        block_k=block)
    dq, dk, dv = tfa.flash_bwd_core(_t(q), _t(k), _t(v), _t(do), _t(lse),
                                    _t(delta), scale=scale, causal=causal)
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref).transpose(0, 2, 1, 3),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H,KVH,causal", [(2, 2, True), (4, 2, False),
                                          (2, 1, True)])
def test_flash_attention_grads_match_jax_grad(H, KVH, causal):
    """The autograd path (K1 forward, K2/K3 backward) against the VJP of
    the JAX flash_attention (custom VJP over the Pallas kernels)."""
    B, S, D = 1, 80, 32
    q, k, v, do = _arrays(H + KVH, B, S, H, KVH, D)

    jo, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, block_q=64,
                                  block_k=64),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=2e-5, rtol=2e-5)
    tg = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for got, ref in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL)


def test_backward_of_strided_views_matches_contiguous():
    """q/k/v as views of one fused [B, S, 3, H, D] projection, as the
    model hands them over: the same gradients as contiguous copies."""
    B, S, H, D = 1, 48, 2, 32
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, 3, H, D), dtype=np.float32)).requires_grad_(True)
    do = torch.randn(B, S, H, D, generator=torch.Generator().manual_seed(1))
    o = tfa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    (g_view,) = torch.autograd.grad(o, qkv, do)
    parts = [qkv[:, :, i].detach().clone().requires_grad_(True)
             for i in range(3)]
    o2 = tfa.flash_attention(*parts)
    g_parts = torch.autograd.grad(o2, parts, do)
    torch.testing.assert_close(g_view, torch.stack(g_parts, dim=2))


def test_delta_is_rowsum_of_do_times_o():
    do = torch.randn(2, 5, 3, 8)
    o = torch.randn(2, 5, 3, 8)
    delta = tfa.attention_delta(do.bfloat16(), o)
    assert delta.shape == (2, 3, 5, 1) and delta.dtype == torch.float32
    ref = (do.bfloat16().float() * o).sum(-1).transpose(1, 2)[..., None]
    torch.testing.assert_close(delta, ref)


def test_cpu_backward_launches_nothing():
    from ray_tpu_torch.ops import _build

    q, k, v, do = (_t(a).requires_grad_(True)
                   for a in _arrays(1, 1, 16, 2, 2, 32))
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    tfa.flash_attention(q, k, v).backward(do)
    assert q.grad is not None and k.grad is not None
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) \
        == before == (0, 0)
    assert not _build._libs


def test_backward_wrappers_refuse_what_they_do_not_take():
    q = torch.empty(1, 16, 2, 32, device="meta")
    lse = torch.empty(1, 2, 16, 1, device="meta")
    for fn in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="no kernel"):
            fn(q, q, q, q, lse, lse, 0.1, True)
    q = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match=r"\[B, H, S, 1\]"):
        tfa.flash_bwd_core(q, q, q, q, torch.zeros(1, 16, 2),
                           torch.zeros(1, 2, 16, 1), scale=0.1, causal=True)
    with pytest.raises(ValueError, match="one device"):
        tfa.flash_bwd_dq(q, q, q, q, torch.zeros(1, 2, 16, 1),
                         torch.zeros(1, 2, 16, 1, device="meta"), 0.1, True)


def test_kernel_library_name_hashes_every_source_and_header(tmp_path):
    """The library's file name carries a hash of every file under
    ``ops/csrc/``: an edited header (included by both kernel sources) must
    name a new library, or a stale build would be loaded. Needs no nvcc."""
    import shutil

    from ray_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert _build.source_digest(csrc) == _build.source_digest()
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    base = _build.source_digest(csrc)
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    edited = _build.source_digest(csrc)
    assert edited != base
    (csrc / "extra.cuh").write_text("// new header\n")
    assert _build.source_digest(csrc) not in (base, edited)
