"""Mixture-of-Experts block: GShard-style capacity-based top-k dispatch.

The counterpart of the JAX package's ``ray_tpu/ops/moe.py``. Tokens route
within fixed-size groups of the whole batch's tokens (GShard's grouping):
the group size is the largest power of two up to ``group_size`` that
divides B*S, each expert takes at most ``capacity = max(1, int(cf * g * k /
E))`` tokens a group, and a token's k choices claim buffer slots in k-major
priority order (every token's first choice before any second choice).
Over-capacity choices are dropped (their combine weight is zero; the
residual carries the token). The chosen gates are renormalised, and the
aux loss is the Switch one on the top-1 assignment, averaged over groups.

Where the JAX package builds one-hot dispatch and combine tensors [T, E,
C] and contracts them with einsums, the port moves the same rows with
index ops: a token's row is copied into its slot of the [groups, E, C, d]
buffer, the experts run as one batched product over E, and each token sums
its kept slots' outputs weighted by its gates (cast to the compute dtype,
as the JAX combine is). The sums have at most k terms, so the results are
the einsums'.

On a mesh (:func:`moe_ffn_on_mesh`) the layer runs in ``local_map`` on each
rank's tokens and experts. The tokens stay split as the activations are
(over the batch axes, and ``seq`` where the rules split the sequence) and
are not moved: each rank gathers the router's probabilities of the whole
batch (``[T, E]`` f32, small), routes every group as one device would, and
runs its own tokens through its own experts (``expert`` splits E,
``tensor`` splits the FFN width). The output is then a partial sum over
those axes, reduced where the residual adds it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..parallel.mesh import mesh_shape
from ..parallel.sharding import (axis_coord, dtensor_mesh, entry_axes,
                                 logical_to_mesh_spec)


def group_size_for(tokens: int, group_size: int = 4096) -> int:
    """The largest power of two up to ``group_size`` that divides
    ``tokens`` (the JAX ``moe_ffn``)."""
    g = 1
    while g * 2 <= min(group_size, tokens) and tokens % (g * 2) == 0:
        g *= 2
    return g


def expert_capacity(group: int, k: int, n_experts: int,
                    capacity_factor: float) -> int:
    return max(1, int(capacity_factor * group * k / n_experts))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last dim, ties to
    the lower index as ``jax.lax.top_k`` breaks them (``torch.topk`` does
    not promise an order; ``argmax`` returns the first maximum)."""
    picks = []
    rest = probs.detach()
    for _ in range(k):
        i = rest.argmax(dim=-1, keepdim=True)
        picks.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    idx = torch.cat(picks, dim=-1)
    return probs.gather(-1, idx), idx


def route(probs: torch.Tensor, k: int, capacity: int):
    """Routing of groups of tokens, probs [G, g, E] f32 -> gates [G, g, k]
    (renormalised), expert [G, g, k], position in the expert's buffer
    [G, g, k], keep [G, g, k] (position < capacity) and the aux loss."""
    G, g, E = probs.shape
    gate, idx = top_k(probs, k)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # [G, g, k, E]; a comparison, not F.one_hot, which fills its output in
    # place (a selective-checkpoint policy refuses that on recompute).
    onehot = (idx[..., None] == torch.arange(E, device=idx.device)).long()
    # k-major priority: every token's first choice takes a slot before any
    # token's second choice. The scan runs along the innermost dim ([G, E,
    # k*g]): along an outer dim of E columns CUDA scans each column on few
    # threads (1.5 ms a layer at bench_350m's 8192 tokens on the H100).
    flat = onehot.permute(0, 3, 2, 1).reshape(G, E, k * g)
    pos = (flat.cumsum(dim=-1) - flat).reshape(G, E, k, g).permute(0, 3, 2, 1)
    position = (pos * onehot).sum(dim=-1)                     # [G, g, k]
    keep = position < capacity
    # Switch load balancing: E * sum_e(frac_tokens_e * frac_probs_e) on the
    # top-1 assignment, per group, averaged over groups.
    frac_tokens = onehot[:, :, 0].float().mean(dim=1)
    frac_probs = probs.mean(dim=1)
    aux = (E * (frac_tokens * frac_probs).sum(dim=-1)).mean()
    return gate, idx, position, keep, aux


def expert_ffn(x: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor,
               position: torch.Tensor, keep: torch.Tensor,
               group: torch.Tensor, n_groups: int, w_gate_up: torch.Tensor,
               w_down: torch.Tensor, *, first_expert: int, capacity: int,
               dtype: torch.dtype) -> torch.Tensor:
    """The experts ``first_expert`` .. + w_gate_up.shape[0] on tokens x
    [T, d] routed by gate/idx/position/keep [T, k]; ``group`` [T] is each
    token's group among the ``n_groups`` this call holds. The products run
    in ``dtype``; returns [T, d] in f32: the sum over the token's kept
    choices of these experts (zero for the others), which the caller
    rounds to ``dtype`` once, after any sum over ranks, as the JAX
    combine's f32-accumulated einsum is rounded once."""
    T, d = x.shape
    k = idx.shape[1]
    E = w_gate_up.shape[0]
    local = idx - first_expert
    mine = keep & (local >= 0) & (local < E)
    n_slots = n_groups * E * capacity
    # A slot per (group, expert, position); dropped choices and other
    # ranks' experts go to one spare row past the end, never read back.
    slot = torch.where(mine, (group[:, None] * E + local) * capacity
                       + position, n_slots).reshape(-1)
    rows = x.to(dtype)[:, None].expand(T, k, d).reshape(T * k, d)
    buf = x.new_zeros((n_slots + 1, d), dtype=dtype).index_copy(0, slot,
                                                                rows)
    buf = buf[:-1].reshape(n_groups, E, capacity, d).transpose(0, 1)
    gu = torch.einsum("egcd,edhf->egchf", buf, w_gate_up.to(dtype))
    act = F.silu(gu[..., 0, :]) * gu[..., 1, :]
    out = torch.einsum("egcf,efd->egcd", act, w_down.to(dtype))
    out = out.transpose(0, 1).reshape(n_slots, d)
    out = torch.cat([out, out.new_zeros((1, d))])
    picked = out.index_select(0, slot).reshape(T, k, d)
    return (gate.to(dtype).float()[..., None] * picked.float()).sum(dim=1)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor,
            w_gate_up: torch.Tensor, w_down: torch.Tensor, *,
            experts_per_token: int = 2, capacity_factor: float = 1.25,
            group_size: int = 4096, dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d], router_w [d, E], w_gate_up [E, d, 2, F], w_down
    [E, F, d] -> (output [B, S, d] in ``dtype``, aux loss, f32 scalar)."""
    B, S, d = x.shape
    T, E, k = B * S, router_w.shape[-1], experts_per_token
    g = group_size_for(T, group_size)
    C = expert_capacity(g, k, E, capacity_factor)
    xf = x.reshape(T, d)
    probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)
    gate, idx, pos, keep, aux = route(probs.reshape(T // g, g, E), k, C)
    group = torch.arange(T, device=x.device) // g
    out = expert_ffn(xf, gate.reshape(T, k), idx.reshape(T, k),
                     pos.reshape(T, k), keep.reshape(T, k), group, T // g,
                     w_gate_up, w_down, first_expert=0, capacity=C,
                     dtype=dtype)
    return out.to(dtype).reshape(B, S, d), aux


# ------------------------------------------------------------------ mesh


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``, in rank order. Every rank
    computes the same function of the result, so the gradient of its own
    piece is its own slice of the result's gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.n = dim, dist.get_rank(group), n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


# moe_w_gate_up's logical spec without its layer dim.
_GATE_UP_SPEC = ("expert", "embed", None, "mlp")


def moe_ffn_on_mesh(x, router_w, w_gate_up, w_down, *, mesh, rules,
                    experts_per_token: int, capacity_factor: float,
                    group_size: int = 4096, dtype=torch.bfloat16):
    """:func:`moe_ffn` on DTensors placed by ``rules`` on ``mesh``: x [B,
    S, d] split over the batch axes (and ``seq`` where the rules split the
    sequence), router_w whole, w_gate_up/w_down split over the axes of
    ``expert`` (E) and ``mlp`` (F) and whole over the batch axes. Returns
    (output, a partial sum over the expert and width axes; aux).

    The partial sums are reduced in f32 and rounded once. Every (expert,
    width) rank routes the same tokens and computes the same aux loss, and the router's gradient sums over those ranks (each
    holds the gate gradients of its own experts); so each rank's aux
    counts 1/n of the whole, and the aux is a partial sum too. Ranks of
    any other mesh axis compute the same whole result."""
    batch_axes, seq_axes = (entry_axes(e) for e in logical_to_mesh_spec(
        ("batch", "seq_act"), rules, mesh))
    gate_up = logical_to_mesh_spec(_GATE_UP_SPEC, rules, mesh)
    expert_axes, width_axes = entry_axes(gate_up[0]), entry_axes(gate_up[3])
    dmesh = dtensor_mesh(mesh)
    names = list(dmesh.mesh_dim_names)
    split = set(expert_axes) | set(width_axes)
    n_split = math.prod(dmesh.size(names.index(a)) for a in split)

    def along(placement_of):
        return tuple(placement_of(a) for a in names)

    x_in = along(lambda a: Shard(0) if a in batch_axes
                 else Shard(1) if a in seq_axes else Replicate())
    # The output, and the input's gradient, sum over the split axes.
    partial = along(lambda a: Shard(0) if a in batch_axes
                    else Shard(1) if a in seq_axes
                    else Partial() if a in split else Replicate())
    whole = along(lambda a: Replicate())
    router_grad = along(lambda a: Partial() if a in batch_axes
                        or a in seq_axes or a in split else Replicate())

    def w_grad(w):
        return tuple(Partial() if a in batch_axes or a in seq_axes else p
                     for a, p in zip(names, w.placements))

    aux_pl = along(lambda a: Partial() if a in split else Replicate())

    B, S, d = x.shape
    T, E, k = B * S, router_w.shape[-1], experts_per_token
    g = group_size_for(T, group_size)
    C = expert_capacity(g, k, E, capacity_factor)
    shape = mesh_shape(mesh)
    n_b = math.prod(shape[a] for a in batch_axes)
    n_s = math.prod(shape[a] for a in seq_axes)
    Bl, Sl = B // n_b, S // n_s
    b0 = axis_coord(mesh, batch_axes) * Bl
    s0 = axis_coord(mesh, seq_axes) * Sl
    first_group = (b0 * S + s0) // g
    n_groups = ((b0 + Bl - 1) * S + s0 + Sl - 1) // g - first_group + 1

    def local(x, router_w, w_gate_up, w_down):
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        # The whole batch's [B, S, E], gathered in the global order: the
        # sequence pieces of each row first, then the rows.
        for a in reversed(seq_axes):
            probs = _GatherDim.apply(probs, 1, mesh.get_group(a))
        for a in reversed(batch_axes):
            probs = _GatherDim.apply(probs, 0, mesh.get_group(a))
        gate, idx, pos, keep, aux = route(probs.reshape(T // g, g, E), k, C)

        def mine(t):  # this rank's tokens, [Bl * Sl, k]
            return t.reshape(B, S, k)[b0:b0 + Bl, s0:s0 + Sl].reshape(-1, k)

        dev = x.device
        tok = ((torch.arange(b0, b0 + Bl, device=dev)[:, None] * S
                + torch.arange(s0, s0 + Sl, device=dev)[None]).reshape(-1))
        first = axis_coord(mesh, expert_axes) * w_gate_up.shape[0]
        out = expert_ffn(x.reshape(-1, d), mine(gate), mine(idx), mine(pos),
                         mine(keep), tok // g - first_group, n_groups,
                         w_gate_up, w_down, first_expert=first,
                         capacity=C, dtype=dtype)
        return out.reshape(Bl, Sl, d), aux / n_split

    out, aux = local_map(
        local, out_placements=(partial, aux_pl),
        in_placements=(x_in, whole, tuple(w_gate_up.placements),
                       tuple(w_down.placements)),
        in_grad_placements=(partial, router_grad, w_grad(w_gate_up),
                            w_grad(w_down)),
        device_mesh=dmesh, redistribute_inputs=True)(
            x, router_w, w_gate_up, w_down)
    return out.redistribute(dmesh, x_in).to(dtype), aux
