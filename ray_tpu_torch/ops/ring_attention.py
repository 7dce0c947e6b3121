"""Ring attention: exact attention over a sequence split on the ``seq`` mesh
axis.

The counterpart of the JAX package's ``ray_tpu/ops/ring_attention.py``.
Each rank holds a contiguous chunk of q/k/v. The k/v chunks rotate around
the ring (rank r sends to r+1 and receives from r-1, through
``batch_isend_irecv`` on the ``seq`` process group); at every step a rank
runs the flash forward (K1) between its q chunk and the visiting k/v chunk
and folds the result into running (o, lse) statistics in f32, so the S x S
score matrix never exists.

Causality at chunk granularity is a plain branch on the ranks: a chunk
from the future is skipped and launches nothing, the rank's own chunk runs
causal, a chunk from the past runs non-causal. The backward runs the ring
again with the *global* lse and delta of the forward, through
``flash_bwd_core`` (K2 and K3), rotating (k, v, dk, dv) together: dk/dv
make a full revolution (sp hops) and arrive home, k/v skip their last hop.

The schedule is written once over the ranks a process holds
(:func:`ring_fwd`, :func:`ring_bwd`), with the hop passed in: on a mesh a
process holds one rank and the hop is the P2P exchange
(:func:`p2p_hop`); a one-process simulation holds every rank and the hop
rotates a list.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .flash_attention import (attention_delta, flash_attention_fwd,
                              flash_bwd_core)

_NEG_INF = -1e30
# A hop takes lists of per-rank tensors (one list per tensor kind) and
# returns each list as the ranks hold it one step later: rank r's entry is
# what rank r-1 held.
Hop = Callable[..., Tuple[List[torch.Tensor], ...]]


def _merge(o, lse, o_c, lse_c):
    """Fold chunk (o_c, lse_c) into the running (o, lse): o [B,S,H,D] and
    lse [B,H,S,1], all f32. Rows that have no key yet (lse -1e30) stay
    zero."""
    lse_new = torch.logaddexp(lse, lse_c)
    w_old = torch.where(lse == _NEG_INF, 0.0, torch.exp(lse - lse_new))
    w_new = torch.where(lse_c == _NEG_INF, 0.0, torch.exp(lse_c - lse_new))
    # [B,H,S,1] -> [B,S,H,1], o's layout.
    return (o * w_old.transpose(1, 2) + o_c * w_new.transpose(1, 2),
            lse_new)


def chunk_kind(rank: int, j: int, causal: bool) -> str:
    """What rank ``rank``'s queries do with the keys of chunk ``j``:
    "skip" (all in the future), "diag" (its own chunk, causal) or "full"
    (all in the past, or no mask)."""
    if not causal:
        return "full"
    if j > rank:
        return "skip"
    return "diag" if j == rank else "full"


def ring_fwd(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
             vs: Sequence[torch.Tensor], ranks: Sequence[int], size: int,
             hop: Hop, *, causal: bool, scale: float):
    """The forward ring for the ranks ``ranks`` (q/k/v chunks [B,S,H|KVH,D]
    each): returns (o in q's dtype, lse [B,H,S,1] f32) per rank."""
    B, S, H, D = qs[0].shape
    os_ = [torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
           for q in qs]
    lses = [torch.full((B, H, S, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    for step in range(size):
        for i, r in enumerate(ranks):
            kind = chunk_kind(r, (r - step) % size, causal)
            if kind == "skip":
                continue
            o_c, lse_c = flash_attention_fwd(qs[i], kc[i], vc[i], scale,
                                             kind == "diag")
            os_[i], lses[i] = _merge(os_[i], lses[i], o_c.float(), lse_c)
        if step < size - 1:
            kc, vc = hop(kc, vc)
    return [o.to(q.dtype) for o, q in zip(os_, qs)], lses


def ring_bwd(qs, ks, vs, dos, lses, deltas, ranks: Sequence[int],
             size: int, hop: Hop, *, causal: bool, scale: float):
    """The backward ring: (dq, dk, dv) per rank, from the global lse and
    delta [B,H,S,1] of each rank's rows."""
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    dkc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvc = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for v in vs]
    kc, vc = list(ks), list(vs)
    for step in range(size):
        for i, r in enumerate(ranks):
            kind = chunk_kind(r, (r - step) % size, causal)
            if kind == "skip":
                continue
            dq_c, dk_c, dv_c = flash_bwd_core(
                qs[i], kc[i], vc[i], dos[i], lses[i], deltas[i],
                scale=scale, causal=kind == "diag")
            dq[i] += dq_c.float()
            dkc[i] += dk_c.float()
            dvc[i] += dv_c.float()
        # dk/dv rotate every step, so the visiting chunk's gradient
        # travels the rest of the way home; k/v are dead after the last
        # step and skip its hop.
        if step < size - 1:
            kc, vc, dkc, dvc = hop(kc, vc, dkc, dvc)
        else:
            dkc, dvc = hop(dkc, dvc)
    return ([g.to(q.dtype) for g, q in zip(dq, qs)],
            [g.to(k.dtype) for g, k in zip(dkc, ks)],
            [g.to(v.dtype) for g, v in zip(dvc, vs)])


def rotate_hop(*lists: List[torch.Tensor]) -> Tuple[List[torch.Tensor], ...]:
    """The hop of a one-process simulation holding every rank."""
    return tuple(list(x[-1:]) + list(x[:-1]) for x in lists)


def p2p_hop(group, rank: int, size: int) -> Hop:
    """The hop of a process holding rank ``rank`` of ``group``: every
    tensor goes to rank+1 and comes from rank-1, in one batch."""
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)

    def hop(*lists):
        send = [x[0].contiguous() for x in lists]
        recv = [torch.empty_like(t) for t in send]
        ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in send]
               + [dist.P2POp(dist.irecv, t, prv, group) for t in recv])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple([t] for t in recv)

    return hop


class _RingAttention(torch.autograd.Function):
    """The ring as one differentiable op (the JAX ``_ring`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        hop = p2p_hop(group, rank, size)
        (o,), (lse,) = ring_fwd([q], [k], [v], [rank], size, hop,
                                causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        do = g.to(q.dtype)
        (dq,), (dk,), (dv,) = ring_bwd(
            [q], [k], [v], [do], [lse], [attention_delta(do, o)], [rank],
            size, p2p_hop(group, rank, size), causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel exact attention on this rank's chunks [B, S_local,
    H|KVH, D] of a sequence split in order over the ranks of ``group``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, group, bool(causal), float(scale))
