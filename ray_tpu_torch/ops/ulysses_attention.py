"""Ulysses sequence parallelism: all-to-all head scattering.

The counterpart of the JAX package's ``ray_tpu/ops/ulysses_attention.py``.
Where the ring rotates k/v chunks around the ``seq`` axis, Ulysses
re-partitions once per attention call,

    [B, S/P, H, D]  --all-to-all-->  [B, S, H/P, D],

runs ordinary flash attention over the whole sequence for its heads, and
all-to-alls the output back to the sequence split. Head counts (query and
kv) must divide P. ``dist.all_to_all_single`` is not differentiable, so
each direction is an autograd Function whose backward is the other
direction.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .flash_attention import flash_attention


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [P, ...]: block i goes to rank i; block i of the result came from
    rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/P, H, D] -> [B, S, H/P, D]: scatter heads, gather sequence."""
    P = dist.get_world_size(group)
    B, S, H, D = x.shape
    send = x.reshape(B, S, P, H // P, D).permute(2, 0, 1, 3, 4)
    recv = _all_to_all(send, group)        # [P (seq chunk), B, S, H/P, D]
    return recv.permute(1, 0, 2, 3, 4).reshape(B, P * S, H // P, D)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S, H/P, D] -> [B, S/P, H, D]: scatter sequence, gather heads."""
    P = dist.get_world_size(group)
    B, SP, Hl, D = x.shape
    S = SP // P
    send = x.reshape(B, P, S, Hl, D).permute(1, 0, 2, 3, 4)
    recv = _all_to_all(send, group)        # [P (head chunk), B, S, H/P, D]
    return recv.permute(1, 2, 0, 3, 4).reshape(B, S, P * Hl, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, *, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over the whole sequence, split in order over the
    ranks of ``group``; takes and returns this rank's [B, S_local, H|KVH,
    D] chunks."""
    P = dist.get_world_size(group)
    H, KVH = q.shape[2], k.shape[2]
    if H % P or KVH % P:
        raise ValueError(
            f"ulysses attention needs head counts divisible by the seq "
            f"axis: H={H}, KVH={KVH}, axis={P} (use ring attention)")
    qg = _SeqToHeads.apply(q, group)
    kg = _SeqToHeads.apply(k, group)
    vg = _SeqToHeads.apply(v, group)
    o = flash_attention(qg, kg, vg, causal=causal, scale=scale)
    return _HeadsToSeq.apply(o, group)
