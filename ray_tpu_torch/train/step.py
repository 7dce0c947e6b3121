"""Training step: params + optimizer + batch -> one update.

The counterpart of the JAX package's ``train/step.py``. ``TrainStep`` runs
on one device; ``ShardedTrainStep`` on a ``DeviceMesh``, with the params
and the optimizer state as DTensors placed by the logical-axis rule tables
(``parallel/sharding.py``), the JAX ``ShardedTrainStep``'s counterpart.
PyTorch runs eagerly, so there is no program to compile: DTensor issues
the collectives op by op (the all-gathers of FSDP, the reduce-scatters and
all-reduces of the gradients), and the backward goes through the
hand-written flash kernels (``ops/flash_attention.py``) on each rank's
local shards.

Two differences from the reference, by design:

- parameters and optimizer state update in place; the JAX step donates its
  input buffers and returns new ones. ``step`` still returns
  ``(params, opt_state, loss)`` so a caller's loop reads the same;
- the optimizer state is the ``torch.optim.Optimizer`` object itself.

The pipeline branch of ``transformer_train_step`` and meshes with a
``pipe``, ``seq`` or ``expert`` axis > 1 wait for ROADMAP A4.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device, same_device
from ..parallel import sharding as shd
from ..parallel.mesh import mesh_device, mesh_shape

Params = Dict[str, Any]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def default_optimizer(leaves: List[torch.Tensor]) -> torch.optim.Optimizer:
    """AdamW as ``optax.adamw(3e-4, weight_decay=0.0)`` (the reference's
    default). Torch's own default weight_decay is 0.01, so it is set."""
    return torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The tensors of a param tree, top level first, then the layers."""
    out = [v for k, v in params.items() if k != "layers"]
    return out + list(params.get("layers", {}).values())


class TrainStep:
    """Holds the loss, the optimizer factory and the device of one-device
    training.

    ``loss_fn(params, batch) -> scalar loss``; ``init_params_fn(generator,
    device) -> params``. ``optimizer`` builds the optimizer over the param
    leaves (default: :func:`default_optimizer`). ``device=None`` means the
    current CUDA card, and raises without one.
    """

    def __init__(self, *, init_params_fn: Callable[..., Params],
                 loss_fn: Callable[[Params, Any], torch.Tensor],
                 device: DeviceLike = None,
                 optimizer: Optional[OptimizerFactory] = None):
        self.device = resolve_device(device)
        self._init_params_fn = init_params_fn
        self._loss_fn = loss_fn
        self._make_optimizer = optimizer or default_optimizer

    def init_opt_state(self, params: Params) -> torch.optim.Optimizer:
        """Mark the param leaves trainable and build the optimizer over
        them (the counterpart of ``optimizer.init(params)``)."""
        leaves = param_leaves(params)
        for t in leaves:
            if not same_device(t.device, self.device):
                raise ValueError(f"param on {t.device}, the step runs on "
                                 f"{self.device}")
            t.requires_grad_(True)
        return self._make_optimizer(leaves)

    def init(self, generator: torch.Generator
             ) -> Tuple[Params, torch.optim.Optimizer]:
        """Random params from ``generator`` (on the step's device) and a
        fresh optimizer over them."""
        with torch.no_grad():
            params = self._init_params_fn(generator, self.device)
        return params, self.init_opt_state(params)

    def step(self, params: Params, opt_state: torch.optim.Optimizer,
             batch: Any) -> Tuple[Params, torch.optim.Optimizer,
                                  torch.Tensor]:
        """One update in place; returns (params, opt_state, loss). The loss
        stays on the device (reading it waits for the step)."""
        opt_state.zero_grad(set_to_none=True)
        loss = self._loss_fn(params, batch)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    def eval_loss(self, params: Params, batch: Any) -> torch.Tensor:
        with torch.no_grad():
            return self._loss_fn(params, batch)


class ShardedTrainStep:
    """Training on a ``DeviceMesh``: the JAX ``ShardedTrainStep`` surface
    (``init``, ``shard_batch``, ``step``, ``eval_loss``).

    ``init_leaves_fn(generator, device)`` yields the params one at a time as
    (path, tensor); ``logical_specs`` is the tree of logical axis names
    matching them. Params are DTensors placed by ``tree_shardings(mesh,
    logical_specs, rules)``, and the optimizer runs on them, so its state
    takes their placements. The loss and its backward run under the
    sharding context, where the model's ``maybe_constrain`` calls
    redistribute its activations. Each process runs the same calls with
    the same arguments (one process per device)."""

    def __init__(self, *, init_leaves_fn: Callable[..., Iterator],
                 loss_fn: Callable[[Params, Any], torch.Tensor],
                 logical_specs: Params, mesh, rules: Optional[shd.Rules] = None,
                 optimizer: Optional[OptimizerFactory] = None):
        self.mesh = mesh
        self.rules = rules or shd.DEFAULT_RULES
        self.device = mesh_device(mesh)
        self.param_shardings = shd.tree_shardings(mesh, logical_specs,
                                                  self.rules)
        self._init_leaves_fn = init_leaves_fn
        self._loss_fn = loss_fn
        self._make_optimizer = optimizer or default_optimizer

    def init_opt_state(self, params: Params) -> torch.optim.Optimizer:
        """Check that each leaf lies on the mesh in its placements, mark it
        trainable, and build the optimizer over the leaves with its state
        made now (``optimizer.init(params)``; a checkpoint restores into
        it)."""
        leaves = []
        for path, t, s in _named(params, self.param_shardings):
            if not (isinstance(t, DTensor) and t.device_mesh == s.mesh
                    and tuple(t.placements) == s.placements):
                got = (tuple(t.placements) if isinstance(t, DTensor)
                       else type(t).__name__)
                raise ValueError(f"param {'.'.join(path)}: {got}, the step "
                                 f"places it {s.placements} on its mesh")
            if not same_device(t.device, self.device):
                raise ValueError(f"param on {t.device}, the step runs on "
                                 f"{self.device}")
            t.requires_grad_(True)
            leaves.append(t)
        opt = self._make_optimizer(leaves)
        for t in leaves:
            opt.state[t].update(_fresh_state(opt, t))
        return opt

    def init(self, generator: torch.Generator
             ) -> Tuple[Params, torch.optim.Optimizer]:
        """Random params from ``generator`` (on the step's device, seeded
        alike on every rank), each leaf distributed before the next is
        made: no device holds more than one whole leaf."""
        params: Params = {"layers": {}}
        with torch.no_grad():
            for path, t in self._init_leaves_fn(generator, self.device):
                s = _lookup(self.param_shardings, path)
                (params["layers"] if path[0] == "layers"
                 else params)[path[-1]] = s.distribute(t)
                del t  # before the next leaf is made
        return params, self.init_opt_state(params)

    def shard_batch(self, batch: Any) -> Any:
        """A host batch, the same on every rank, onto the mesh: the batch dim
        split over ``data`` and ``fsdp``."""
        return shd.shard_batch(self.mesh, batch)

    def step(self, params: Params, opt_state: torch.optim.Optimizer,
             batch: Any) -> Tuple[Params, torch.optim.Optimizer,
                                  torch.Tensor]:
        """One update in place; returns (params, opt_state, loss), the loss
        a plain tensor on this rank's device, the same on every rank."""
        opt_state.zero_grad(set_to_none=True)
        with shd.sharding_ctx(self.mesh, self.rules):
            loss = self._loss_fn(params, batch)
            loss.backward()
        for group in opt_state.param_groups:
            for t in group["params"]:
                # A gradient can come back in another layout (partial sums
                # of a product, say); the update needs the param's.
                if t.grad is not None and t.grad.placements != t.placements:
                    t.grad = t.grad.redistribute(t.device_mesh, t.placements)
        opt_state.step()
        return params, opt_state, loss.detach().full_tensor()

    def eval_loss(self, params: Params, batch: Any) -> torch.Tensor:
        with torch.no_grad(), shd.sharding_ctx(self.mesh, self.rules):
            return self._loss_fn(params, batch).full_tensor()

    def state_tree(self, params: Params,
                   opt_state: torch.optim.Optimizer) -> Dict[str, Any]:
        """Params and optimizer state as one tree, the optimizer's per-param
        state under the param's name: what ``Checkpoint.save_sharded``
        saves and ``load_sharded`` restores into, in place."""
        return {"params": params,
                "opt_state": shd.tree_map(lambda t: opt_state.state[t],
                                          params)}


def _named(params: Params, shardings: Params):
    """(path, leaf, sharding) of a param tree; the names must match."""
    top = [k for k in params if k != "layers"]
    if sorted(top) != sorted(k for k in shardings if k != "layers") or (
            sorted(params.get("layers", {})) != sorted(shardings["layers"])):
        raise ValueError("param names do not match the step's logical specs")
    for k in top:
        yield (k,), params[k], shardings[k]
    for k, t in params["layers"].items():
        yield ("layers", k), t, shardings["layers"][k]


def _lookup(tree: Params, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _fresh_state(opt: torch.optim.Optimizer, t: torch.Tensor) -> Dict:
    """The per-param state an Adam-family optimizer makes at its first
    step, made at once; other optimizers keep their own lazy state."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        return {}
    return {"step": torch.tensor(0.0, dtype=torch.float32),
            "exp_avg": torch.zeros_like(t),
            "exp_avg_sq": torch.zeros_like(t)}


def transformer_train_step(cfg, *, device: DeviceLike = None,
                           optimizer: Optional[OptimizerFactory] = None,
                           shift_inputs: bool = False, mesh: Any = None,
                           rules: Optional[shd.Rules] = None,
                           pipeline_microbatches: Optional[int] = None):
    """Wire a ``models.transformer`` config into a :class:`TrainStep`, or,
    with ``mesh``, a :class:`ShardedTrainStep` over it with ``rules``
    (default ``DEFAULT_RULES``). ``shift_inputs`` selects the [B,
    S+1]-tokens convention (see ``loss_fn``). A mesh with a ``pipe``,
    ``seq`` or ``expert`` axis > 1, and ``pipeline_microbatches``, raise
    NotImplementedError (ROADMAP A4)."""
    from ..models import transformer as tfm

    if pipeline_microbatches is not None:
        raise NotImplementedError(
            "the pipeline of transformer_train_step is not ported yet "
            "(ROADMAP A4)")
    loss = lambda params, batch: tfm.loss_fn(  # noqa: E731
        params, batch, cfg, shift_inputs=shift_inputs)
    if mesh is not None:
        if device is not None:
            raise ValueError("a mesh decides the device; pass one or the "
                             "other")
        wide = {a: n for a, n in mesh_shape(mesh).items()
                if a in ("pipe", "seq", "expert") and n > 1}
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide}: pipeline, sequence and expert "
                f"parallelism are not ported yet (ROADMAP A4); the port "
                f"trains over data, fsdp and tensor")
        return ShardedTrainStep(
            init_leaves_fn=lambda gen, dev: tfm.init_leaves(cfg, gen, dev),
            loss_fn=loss, logical_specs=tfm.param_logical_specs(cfg),
            mesh=mesh, rules=rules, optimizer=optimizer)
    if rules is not None:
        raise ValueError("sharding rules need a mesh")
    return TrainStep(
        init_params_fn=lambda gen, dev: tfm.init_params(cfg, gen, dev),
        loss_fn=loss,
        device=device,
        optimizer=optimizer,
    )
