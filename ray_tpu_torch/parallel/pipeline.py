"""Pipeline parallelism over the ``pipe`` mesh axis: a GPipe schedule of
microbatches, one stage per ``pipe`` rank.

The counterpart of the JAX package's ``ray_tpu/parallel/pipeline.py``.
There the whole schedule is one SPMD program: M+P-1 ticks, every stage
computing every tick (bubble ticks compute garbage that masks discard) and
a roll over the pipe-split stage dim handing activations on. Here each
``pipe`` rank runs its own stage and only the ticks that carry a
microbatch: stage s takes microbatch m at tick m+s, so skipping the bubble
ticks changes no result (their outputs and aux losses were masked anyway).

- The stage is this rank's local slice of the stacked layers: the rules
  map ``"layers"`` onto ``pipe``, so a layer leaf's local tensor holds
  L/P layers. It runs as DTensors on the mesh without ``pipe`` (the stage
  mesh), so fsdp, tensor and expert splits inside a stage work as on the
  whole mesh. ``seq_act`` is dropped inside stages, as in the reference.
- Activations pass between stages through autograd Functions: send to the
  next stage in the forward and receive its gradient in the backward, and
  the reverse for the receiving side.
- The embedding and the LM head run outside the schedule, on every pipe
  rank alike: stage 0's input gradient is broadcast to every pipe rank, and
  the last stage's output is broadcast to every pipe rank, so the
  gradients of the embedding and head are the same on each, as their
  placements (replicated over ``pipe``) say.
- The MoE aux loss is summed over the stages and divided by M (each
  microbatch adds one mean per layer).
- Microbatch m is the batch rows [m*B/M, (m+1)*B/M), as in the reference:
  routing groups are drawn within a microbatch, so MoE needs the same rows.
  The microbatches meet the batch shards (data x fsdp) in one of three
  layouts (:func:`microbatch_layout`). "split": B/M divides over the
  shards, and each shard holds its piece of every microbatch (the rows are
  reordered once before the embedding so that a rank's pieces are
  contiguous). "whole": M divides over the shards, and each shard holds
  M/shards whole microbatches, its own rows in their order; a dense stack
  only, since MoE gathers router probabilities over the batch axes and
  would route two microbatches of one tick as one group. "replicated":
  every other case, and MoE where "split" does not apply: each
  microbatch's rows are replicated over the batch axes (the loss runs with
  ``batch`` mapped to no mesh axis), so every batch rank computes the same
  gradient, which is then the whole batch's, averaged over the ranks and
  not summed. The loss is the mean over the global batch in each.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from . import sharding as shd
from .mesh import mesh_shape


class _SendNext(torch.autograd.Function):
    """Forward: send h to the next stage. Backward: receive h's gradient
    from it. Returns an empty tensor that joins the loss's graph, so the
    backward runs."""

    @staticmethod
    def forward(ctx, h, peer, group):
        ctx.peer, ctx.group = peer, group
        ctx.shape, ctx.dtype, ctx.device = h.shape, h.dtype, h.device
        dist.send(h.contiguous(), peer, group=group)
        return h.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        dist.recv(g, ctx.peer, group=ctx.group)
        return g, None, None


class _RecvPrev(torch.autograd.Function):
    """Forward: receive an activation from the previous stage. Backward:
    send its gradient back. ``anchor`` (a scalar that needs grad, on the
    activations' device) makes the result part of the graph."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, peer, group):
        ctx.peer, ctx.group = peer, group
        h = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(h, peer, group=group)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.peer, group=ctx.group)
        return None, None, None, None, None


class _FromFirstStage(torch.autograd.Function):
    """Identity in the forward (every pipe rank holds the same embedded
    batch; stage 0 uses it). Backward: stage 0's gradient, broadcast to
    every pipe rank."""

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.broadcast(g, ctx.src, group=ctx.group)
        return g, None, None


class _FromLastStage(torch.autograd.Function):
    """Forward: the last stage's output y, broadcast to every pipe rank.
    Backward: the last stage keeps y's gradient (the same on every rank:
    they compute the same head and loss); every rank hands zeros to
    ``links`` (stage 0's input and the sends' results), which starts the
    rest of its backward."""

    @staticmethod
    def forward(ctx, y, src, group, is_src, *links):
        ctx.is_src, ctx.links = is_src, [(t.shape, t.dtype) for t in links]
        ctx.device = y.device
        out = y.clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        zeros = [torch.zeros(s, dtype=dt, device=ctx.device)
                 for s, dt in ctx.links]
        return (g if ctx.is_src else None, None, None, None, *zeros)


class _SumOverStages(torch.autograd.Function):
    """All-reduce (sum) over the pipe group; every rank uses the sum alike,
    so each stage's part takes the sum's gradient unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _stage_mesh(mesh):
    """The mesh without ``pipe``: what a stage's DTensors live on."""
    return mesh[tuple(a for a in mesh.mesh_dim_names if a != "pipe")]


def _on_stage(w: DTensor, stage_dmesh) -> DTensor:
    """A layer leaf (split over ``pipe`` on its layer dim) as this stage's
    L/P layers, a DTensor on the stage mesh with its other placements."""
    names = list(w.device_mesh.mesh_dim_names)
    pl = tuple(w.placements[names.index(a)] if a in names else Replicate()
               for a in stage_dmesh.mesh_dim_names)
    return DTensor.from_local(w.to_local(), stage_dmesh, pl, run_check=False)


def _batch_axes(mesh, rules) -> Tuple[str, ...]:
    return shd.entry_axes(shd.logical_to_mesh_spec(("batch",), rules,
                                                   mesh)[0])


def pipeline_apply(cfg, layers: Dict[str, Any], x: DTensor, mesh,
                   rules: Optional[shd.Rules] = None,
                   num_microbatches: int = 4,
                   layout: str = "split") -> Tuple[DTensor, Any]:
    """Run the layer stack on x [B, S, d] as a P-stage GPipe pipeline, its
    rows laid out as ``layout`` says (:func:`microbatch_layout`; "split"
    rows ordered by :func:`microbatch_order`, "replicated" under rules
    that map ``batch`` to no axis). Returns (y [B, S, d], the summed MoE
    aux loss over M: None for dense stacks)."""
    from ..models.transformer import (_positions, iter_layers,
                                      layer_scan_body, run_layers)

    rules = rules or shd.DEFAULT_RULES
    M = num_microbatches
    P = mesh_shape(mesh)["pipe"]
    group = mesh.get_group("pipe")
    stage = mesh.get_local_rank("pipe")
    first = dist.get_global_rank(group, 0)
    last = dist.get_global_rank(group, P - 1)
    stage_mesh = _stage_mesh(mesh)
    inner_rules = {k: v for k, v in rules.items() if k != "seq_act"}
    dmesh, smesh = shd.dtensor_mesh(mesh), shd.dtensor_mesh(stage_mesh)
    act = shd.placements(("batch", None, None), rules, mesh)
    stage_act = shd.placements(("batch", None, None), inner_rules,
                               stage_mesh)

    B, S, d = x.shape
    xl = _FromFirstStage.apply(x.redistribute(dmesh, act).to_local(), first,
                               group)
    # A rank's microbatches: all M, or its M/shards whole ones.
    ticks = M // _n_shards(stage_mesh, inner_rules) if layout == "whole" \
        else M
    per_rank = xl.shape[0] // ticks
    stage_layers = list(iter_layers(
        {"layers": {k: _on_stage(w, smesh) for k, w in layers.items()}}))
    # Rows of a tick's activations across the batch shards.
    positions = _positions(
        per_rank * _n_shards(stage_mesh, inner_rules), S, xl.device)
    anchor = torch.zeros((), device=xl.device, requires_grad=True)
    outs, links, auxs = [], [xl], []
    with shd.sharding_ctx(stage_mesh, inner_rules):
        body = layer_scan_body(cfg, positions)
        for m in range(ticks):
            if stage == 0:
                h = xl[m * per_rank:(m + 1) * per_rank]
            else:
                h = _RecvPrev.apply(anchor, (per_rank, S, d), xl.dtype,
                                    dist.get_global_rank(group, stage - 1),
                                    group)
            hd = DTensor.from_local(h, smesh, stage_act, run_check=False)
            hd, aux = run_layers(body, hd, stage_layers)
            h = hd.redistribute(smesh, stage_act).to_local()
            if cfg.moe_num_experts:
                auxs.append(aux.full_tensor())
            if stage < P - 1:
                links.append(_SendNext.apply(
                    h, dist.get_global_rank(group, stage + 1), group))
            else:
                outs.append(h)
    y = torch.cat(outs) if outs else torch.empty_like(xl)
    y = _FromLastStage.apply(y, last, group, stage == P - 1, *links)
    y = DTensor.from_local(y, dmesh, act, run_check=False)
    if not cfg.moe_num_experts:
        return y, None
    aux = _SumOverStages.apply(sum(auxs[1:], auxs[0]), group) / M
    return y, DTensor.from_local(aux, dmesh, (Replicate(),) * dmesh.ndim,
                                 run_check=False)


def _n_shards(mesh, rules) -> int:
    """How many ways ``rules`` split the batch on ``mesh``."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _batch_axes(mesh, rules))


def microbatch_layout(B: int, M: int, n_batch: int, moe: bool) -> str:
    """How M microbatches of B/M rows meet ``n_batch`` batch shards:
    "split" (B/M divides over them), "whole" (M does; dense only) or
    "replicated" (see the module docstring)."""
    if B % M:
        raise ValueError(f"batch {B} not divisible by num_microbatches {M}")
    if (B // M) % n_batch == 0:
        return "split"
    if M % n_batch == 0 and not moe:
        return "whole"
    return "replicated"


def _replicate(t: DTensor) -> DTensor:
    """A batch-split DTensor made whole on every rank (tokens and masks)."""
    if t.ndim == 0:
        return t
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def microbatch_order(B: int, M: int, n_batch: int) -> torch.Tensor:
    """The row order that makes microbatch m (rows [m*B/M, (m+1)*B/M))
    this: batch shard c holds, for each m in turn, its own B/M/n_batch rows
    of microbatch m."""
    mb = B // M
    per = mb // n_batch
    c, m, i = torch.meshgrid(torch.arange(n_batch), torch.arange(M),
                             torch.arange(per), indexing="ij")
    return (m * mb + c * per + i).reshape(-1)


def _take_rows(t: DTensor, order: torch.Tensor, batch_axes,
               mesh) -> DTensor:
    """A batch-split DTensor with its rows in ``order``: each rank takes
    its rows from the whole (tokens and masks: no gradient flows)."""
    if t.ndim == 0:
        return t
    whole = t.full_tensor()
    n = t.to_local().shape[0]
    start = shd.axis_coord(mesh, batch_axes) * n
    local = whole[order[start:start + n].to(whole.device)]
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False)


def pipeline_loss_fn(cfg, mesh, *, rules: Optional[shd.Rules] = None,
                     num_microbatches: int = 4, shift_inputs: bool = False):
    """loss_fn(params, batch) running the decoder as a GPipe pipeline: the
    drop-in for ``models.transformer.loss_fn`` on a mesh with pipe > 1
    (``transformer_train_step(..., pipeline_microbatches=M)``).
    ``shift_inputs`` selects the [B, S+1]-tokens convention. MoE stacks
    add their aux loss as in the unpipelined loss."""
    from ..models import transformer as tfm

    rules = rules or shd.DEFAULT_RULES
    M = num_microbatches
    batch_axes = _batch_axes(mesh, rules)
    n_batch = _n_shards(mesh, rules)
    # The same rules with the batch on no mesh axis: "replicated" runs the
    # whole loss under them.
    whole_batch_rules = {**rules, "batch": None}

    def loss_fn(params, batch):
        layout = microbatch_layout(batch["tokens"].shape[0], M, n_batch,
                                   bool(cfg.moe_num_experts))
        if layout == "replicated":
            batch = {k: _replicate(v) for k, v in batch.items()}
            with shd.sharding_ctx(mesh, whole_batch_rules):
                return _loss(params, batch, whole_batch_rules, layout)
        if layout == "split" and n_batch > 1:
            order = microbatch_order(batch["tokens"].shape[0], M, n_batch)
            batch = {k: _take_rows(v, order, batch_axes, mesh)
                     for k, v in batch.items()}
        return _loss(params, batch, rules, layout)

    def _loss(params, batch, rules, layout):
        tokens = batch["tokens"]
        inputs = tokens[:, :-1] if shift_inputs else tokens
        x = tfm.embed_tokens(params, inputs, cfg)
        y, aux = pipeline_apply(cfg, params["layers"], x, mesh, rules, M,
                                layout)
        y = shd.maybe_constrain(y, ("batch", "seq_act", "embed"))
        logits = tfm.lm_head(params, y, cfg)
        if shift_inputs:
            targets, valid = tfm.shift_targets_valid(tokens,
                                                     batch.get("mask"))
            loss = tfm.token_cross_entropy(logits, targets, valid)
        else:
            loss = tfm.next_token_loss(logits, batch)
        if cfg.moe_num_experts:
            loss = loss + cfg.moe_aux_coef * aux
        return loss

    return loss_fn
