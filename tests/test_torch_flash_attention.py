"""The port's flash-attention forward (ray_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas forward, run in interpret mode on the CPU
as tests/test_flash_attention.py runs it.

On the CPU the port's wrapper takes its plain version; the same seeded
numpy inputs go through both sides in f32. Tolerance 2e-5 (f32, another
summation order), as the JAX package's own flash-vs-reference test uses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _flash_fwd
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops import flash_attention as tfa

ATOL = RTOL = 2e-5


def _qkv(seed, B, S, H, KVH, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KVH, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KVH, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("S,block", [(256, 128), (192, 128), (96, 64)])
@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_lse_match_pallas(causal, H, KVH, S, block):
    B, D = 1, 32
    q, k, v = _qkv(S + H + KVH, B, S, H, KVH, D)
    scale = D ** -0.5
    # JAX _flash_fwd works in [B, H, S, D] and returns lse [B, H, S, 1].
    jo, jlse = _flash_fwd(jnp.asarray(q.transpose(0, 2, 1, 3)),
                          jnp.asarray(k.transpose(0, 2, 1, 3)),
                          jnp.asarray(v.transpose(0, 2, 1, 3)),
                          scale, causal, block, block)
    o, lse = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale, causal)
    assert o.shape == (B, S, H, D) and lse.shape == (B, H, S, 1)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               atol=ATOL, rtol=RTOL)


def test_public_entry_matches_jax_flash_attention():
    q, k, v = _qkv(7, 2, 192, 4, 2, 64)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, block_q=128, block_k=128)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_gqa_reads_kv_head_h_div_group():
    """Query head h reads kv head h // (H/KVH) (repeat_interleave), not
    h % KVH: give every kv head a distinct constant value row."""
    B, S, H, KVH, D = 1, 8, 4, 2, 32
    q = torch.zeros(B, S, H, D)
    k = torch.zeros(B, S, KVH, D)
    v = torch.stack([torch.full((B, S, D), float(j)) for j in range(KVH)],
                    dim=2)
    o = tfa.flash_attention(q, k, v, causal=True)
    for h in range(H):
        assert torch.all(o[:, :, h] == float(h // (H // KVH)))


def test_cpu_call_launches_nothing():
    """A CPU call neither launches nor builds: the module imports and runs
    here with no nvcc and no triton."""
    from ray_tpu_torch.ops import _build

    before = tfa.flash_attention_fwd.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 2, 2, 32))
    tfa.flash_attention(q, k, v)
    assert tfa.flash_attention_fwd.launches == before == 0
    assert not _build._libs


def test_no_silent_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA gets an error, not
    the plain version."""
    q = torch.empty(1, 16, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_fwd(q, q, q, 0.1, True)


def test_bad_shapes_raise():
    q = torch.zeros(1, 16, 3, 32)
    k = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :8], k[:, :8])


def test_causal_first_row_reads_only_key_zero():
    """Masked scores use -1e30, so every output stays finite, and causal
    row 0 returns v[0] exactly."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 64, 2, 1, 32))
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, 0.1, True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    # Row 0 attends only key 0: its output is v[0] exactly.
    torch.testing.assert_close(o[0, 0, 0], v[0, 0, 0])


def test_attention_dispatch_follows_flag(monkeypatch):
    called = {}

    def fake_flash(q, k, v, **kw):
        called["flash"] = True
        return tatt.reference_attention(q, k, v, causal=kw["causal"])

    monkeypatch.setattr(tatt, "flash_attention", fake_flash)
    q = torch.ones(1, 16, 2, 8)
    monkeypatch.setenv("RTPU_ATTN_IMPL", "flash")
    tatt.attention(q, q, q, causal=True)
    assert called.pop("flash", False)
    monkeypatch.setenv("RTPU_ATTN_IMPL", "xla")
    tatt.attention(q, q, q, causal=True)
    assert "flash" not in called
    # auto: the kernel only for CUDA tensors; CPU tensors take the reference.
    monkeypatch.setenv("RTPU_ATTN_IMPL", "auto")
    tatt.attention(q, q, q, causal=True)
    assert "flash" not in called


def test_attention_flag_bad_value_warns(monkeypatch):
    import warnings

    monkeypatch.setenv("RTPU_ATTN_IMPL", "falsh")
    monkeypatch.setattr(tatt, "_warned_bad_impl", False)
    q = torch.ones(1, 8, 2, 8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tatt.attention(q, q, q, causal=True)
    assert any("RTPU_ATTN_IMPL" in str(x.message) for x in w)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    from ray_tpu.ops.attention import reference_attention as jax_ref

    q, k, v = _qkv(11, 2, 24, 4, 2, 16)
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal)
    got = tatt.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
