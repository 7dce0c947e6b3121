"""Attention ops: the plain reference implementation and the dispatch point
the models call.

Counterpart of the JAX package's ``ray_tpu/ops/attention.py``. ``attention``
picks by ``RTPU_ATTN_IMPL``: ``flash`` goes to :func:`flash_attention`
(the Hopper kernel for CUDA tensors, its plain version on the CPU), ``xla``
to :func:`reference_attention`, and ``auto`` to the kernel for CUDA tensors
and the reference elsewhere. On CUDA the kernel runs or the call raises;
nothing falls back.

Under a sharding context (a training step on a mesh) q, k and v are
DTensors, and the chosen function runs through ``local_map`` on each rank's
local shards: [B/(data*fsdp), S, H/tensor, D] for q, KVH/tensor heads for k
and v. The kernels and their autograd Function see plain tensors. The
sequence-parallel branch (a ``seq`` axis > 1: ring and Ulysses attention)
waits for ROADMAP A4.
"""
from __future__ import annotations

import functools
import math
import warnings
from typing import Optional

import torch
from torch.distributed.tensor.experimental import local_map

from .. import flags
from ..parallel.mesh import mesh_shape
from ..parallel.sharding import (current_sharding_ctx, dtensor_mesh,
                                 entry_axes, logical_to_mesh_spec,
                                 placements)
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
        fn = flash_attention
    else:
        fn = reference_attention
    ctx = current_sharding_ctx()
    if ctx is None:
        return fn(q, k, v, causal=causal, scale=scale)
    return _on_local_shards(fn, q, k, v, *ctx, causal=causal, scale=scale)


_Q_SPEC = ("batch", "seq_act", "heads", None)
_KV_SPEC = ("batch", "seq_act", "kv_heads", None)


def _on_local_shards(fn, q, k, v, mesh, rules, *, causal, scale):
    """``fn`` on each rank's shards: batch split over the batch axes, heads
    over the axes ``heads`` maps to. A rank's query heads must read only
    its own kv heads, so both head names must map to the same axes and
    their count must divide the kv heads."""
    shape = mesh_shape(mesh)
    if shape["seq"] > 1:
        raise NotImplementedError(
            "sequence-parallel attention (a seq mesh axis > 1: ring and "
            "Ulysses) is not ported yet (ROADMAP A4)")
    q_axes = logical_to_mesh_spec(_Q_SPEC, rules, mesh)[2]
    kv_axes = logical_to_mesh_spec(_KV_SPEC, rules, mesh)[2]
    if q_axes != kv_axes:
        raise ValueError(f"heads map to mesh axes {q_axes} and kv_heads to "
                         f"{kv_axes}; a rank's query heads would read "
                         f"another rank's kv heads")
    split = math.prod(shape[a] for a in entry_axes(q_axes))
    if k.shape[2] % split:
        raise ValueError(f"{k.shape[2]} kv heads do not split over "
                         f"{split} ranks of mesh axes {q_axes}")
    qp = placements(_Q_SPEC, rules, mesh)
    kvp = placements(_KV_SPEC, rules, mesh)
    body = functools.partial(fn, causal=causal, scale=scale)
    return local_map(body, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp),
                     device_mesh=dtensor_mesh(mesh),
                     redistribute_inputs=True)(q, k, v)
