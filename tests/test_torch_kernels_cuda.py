"""The port's hand-written kernels against their plain versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. The file imports no JAX, so it runs on a machine that has
only PyTorch; there, run it without the repo's conftest (which sets up the
JAX package's CPU mesh):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(seed, B, S, H, KVH, D, device):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device, torch.bfloat16)
        for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))


@pytest.mark.parametrize("S,H,KVH,D", [(96, 16, 16, 64), (192, 32, 8, 128),
                                       (100, 4, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_kernel_matches_plain(causal, S, H, KVH, D):
    """bf16. Tolerance: o within 2e-2 (p is rounded to bf16 before p.v, as
    on the TPU), lse within 1e-3 (f32 statistics)."""
    q, k, v = _qkv(S + D, 2, S, H, KVH, D, _card())
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)


def test_flash_forward_kernel_reads_strided_kv():
    """k and v as views into the fused [B, S, 2, KVH, D] projection, as the
    model hands them over: the kernel reads them by strides."""
    dev = _card()
    B, S, H, KVH, D = 1, 130, 8, 2, 64
    q, _, _ = _qkv(1, B, S, H, KVH, D, dev)
    kv = torch.randn(B, S, 2, KVH, D, device=dev, dtype=torch.bfloat16,
                     generator=torch.Generator(device=dev).manual_seed(0))
    k, v = kv[:, :, 0], kv[:, :, 1]
    o, lse = tfa.flash_attention_fwd(q, k, v, D ** -0.5, True)
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, D ** -0.5, True)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)


def test_flash_forward_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q = torch.zeros(1, 16, 2, 64, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention_fwd(q, q, q, 0.1, True)  # f32: no plain fallback
    q = torch.zeros(1, 16, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, q, 0.1, True)
