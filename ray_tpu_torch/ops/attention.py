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
and v. The kernels and their autograd Function see plain tensors. With a
``seq`` axis > 1 whose ranks split the activations' sequence (the rules
map ``seq_act`` onto ``seq``), the local shards go to ring or Ulysses
attention (``RTPU_SP_MODE``) over the ``seq`` process group; otherwise,
and always under ``RTPU_ATTN_IMPL=xla``, attention is dense over the whole
sequence on each rank, as in the JAX package.
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
from .ring_attention import ring_attention
from .ulysses_attention import ulysses_attention


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
    mesh, rules = ctx
    # impl=xla asks for no kernel: the ring and Ulysses run flash kernels
    # on their chunks, so they are bypassed, as in the JAX package.
    if impl != "xla" and mesh_shape(mesh)["seq"] > 1:
        out = _seq_parallel_attention(q, k, v, mesh, rules, causal=causal,
                                      scale=scale)
        if out is not None:
            return out
    return _on_local_shards(fn, q, k, v, mesh, rules, causal=causal,
                            scale=scale)


# Dense attention takes the whole sequence on every rank; the
# sequence-parallel schemes take the chunk the rules give the rank.
_Q_SPEC = ("batch", None, "heads", None)
_KV_SPEC = ("batch", None, "kv_heads", None)
_SEQ_Q_SPEC = ("batch", "seq_act", "heads", None)
_SEQ_KV_SPEC = ("batch", "seq_act", "kv_heads", None)


def _head_split(q_spec, kv_spec, mesh, k) -> int:
    """Ranks the heads split over. A rank's query heads must read only its
    own kv heads, so both head names must map to the same axes and their
    count must divide the kv heads."""
    q_axes, kv_axes = q_spec[2], kv_spec[2]
    if q_axes != kv_axes:
        raise ValueError(f"heads map to mesh axes {q_axes} and kv_heads to "
                         f"{kv_axes}; a rank's query heads would read "
                         f"another rank's kv heads")
    shape = mesh_shape(mesh)
    split = math.prod(shape[a] for a in entry_axes(q_axes))
    if k.shape[2] % split:
        raise ValueError(f"{k.shape[2]} kv heads do not split over "
                         f"{split} ranks of mesh axes {q_axes}")
    return split


def _run_local(body, q, k, v, mesh, rules, q_logical, kv_logical):
    qp = placements(q_logical, rules, mesh)
    kvp = placements(kv_logical, rules, mesh)
    return local_map(body, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp),
                     device_mesh=dtensor_mesh(mesh),
                     redistribute_inputs=True)(q, k, v)


def _on_local_shards(fn, q, k, v, mesh, rules, *, causal, scale):
    """``fn`` on each rank's shards: batch split over the batch axes, heads
    over the axes ``heads`` maps to, the whole sequence."""
    _head_split(logical_to_mesh_spec(_Q_SPEC, rules, mesh),
                logical_to_mesh_spec(_KV_SPEC, rules, mesh), mesh, k)
    body = functools.partial(fn, causal=causal, scale=scale)
    return _run_local(body, q, k, v, mesh, rules, _Q_SPEC, _KV_SPEC)


def _seq_parallel_attention(q, k, v, mesh, rules, *, causal, scale):
    """Ring or Ulysses attention on each rank's sequence chunk, or None
    where the rules do not split the activations' sequence over ``seq``
    (a ring over whole-sequence "chunks" would count every key sp times).
    ``RTPU_SP_MODE``: ring | ulysses | auto (Ulysses where the heads a
    rank holds divide the axis, else the ring); an explicit ulysses that
    cannot divide runs the ring."""
    q_spec = logical_to_mesh_spec(_SEQ_Q_SPEC, rules, mesh)
    kv_spec = logical_to_mesh_spec(_SEQ_KV_SPEC, rules, mesh)
    if q_spec[1] != "seq":
        return None
    split = _head_split(q_spec, kv_spec, mesh, k)
    sp = mesh_shape(mesh)["seq"]
    # Divisibility is per device: the heads may also be split over tensor.
    divisible = (q.shape[2] // split) % sp == 0 and (
        k.shape[2] // split) % sp == 0
    scheme = ring_attention
    if flags.get("RTPU_SP_MODE") in ("ulysses", "auto") and divisible:
        scheme = ulysses_attention
    body = functools.partial(scheme, group=mesh.get_group("seq"),
                             causal=causal, scale=scale)
    return _run_local(body, q, k, v, mesh, rules, _SEQ_Q_SPEC, _SEQ_KV_SPEC)
