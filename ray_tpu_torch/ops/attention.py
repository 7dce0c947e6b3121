"""Attention ops: the plain reference implementation and the dispatch point
the models call.

Counterpart of the JAX package's ``ray_tpu/ops/attention.py``. ``attention``
picks by ``RTPU_ATTN_IMPL``: ``flash`` goes to :func:`flash_attention`
(the Hopper kernel for CUDA tensors, its plain version on the CPU), ``xla``
to :func:`reference_attention`, and ``auto`` to the kernel for CUDA tensors
and the reference elsewhere. On CUDA the kernel runs or the call raises;
nothing falls back. The sequence-parallel branch waits for the distributed
slice of the port.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from .. import flags
from .flash_attention import flash_attention


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention with GQA head-broadcast, [B,S,H,D] in and out.
    Computes in f32 for numerical stability, returns q.dtype."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if H % KVH:
        raise ValueError(f"heads {H} not divisible by kv_heads {KVH}")
    group = H // KVH
    scale = scale if scale is not None else D ** -0.5
    qg = (q.float() * scale).reshape(B, S, KVH, group, D)
    kf = k.float()
    vf = v.float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, kf)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vf)
    return out.reshape(B, S, H, D).to(q.dtype)


_warned_bad_impl = False


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Dispatching attention entry point used by all models."""
    global _warned_bad_impl
    impl = flags.get("RTPU_ATTN_IMPL")
    if impl not in ("auto", "flash", "xla"):
        if not _warned_bad_impl:
            warnings.warn(
                f"RTPU_ATTN_IMPL={impl!r} is not one of auto|flash|xla; "
                "treating as 'auto'", stacklevel=2)
            _warned_bad_impl = True
        impl = "auto"
    if impl == "flash" or (impl == "auto" and q.device.type == "cuda"):
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return reference_attention(q, k, v, causal=causal, scale=scale)
