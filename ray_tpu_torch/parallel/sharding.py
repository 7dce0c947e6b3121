"""Logical-axis sharding rules: how params and activations map onto the mesh.

The counterpart of the JAX package's ``parallel/sharding.py``. Every model
tags its arrays with *logical* axis names ("embed", "mlp", "heads",
"batch", ...) and a rule table maps logical axes to mesh axes per
parallelism strategy, so changing strategy means changing the rule table,
never the model. The rule tables are copies of the JAX package's. Where
the JAX package builds a ``NamedSharding`` (a mesh and a ``PartitionSpec``),
the port builds one DTensor placement per mesh axis: ``Shard(d)`` on each
mesh axis that tensor dim ``d`` is split over, ``Replicate()`` elsewhere.
A dim split over two mesh axes (the batch over ``data`` and ``fsdp``) is
split over the first one first, as a ``PartitionSpec`` tuple is.

DTensors live on the mesh's axes of size > 1 (:func:`dtensor_mesh`): the
rules drop the others anyway, and DTensor's sharding propagation weighs
every combination of per-axis strategies, so six axes where two are used
made each op take seconds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from .mesh import mesh_device, mesh_shape

# A logical spec is a tuple of logical axis names (or None), one per dim.
LogicalSpec = Tuple[Optional[str], ...]
Rules = Dict[str, Union[str, Tuple[str, ...], None]]
# Per tensor dim: None, one mesh axis, or a tuple of them (a PartitionSpec).
MeshAxes = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Rule tables per strategy. Values name mesh axes (see mesh.AXIS_ORDER).
# "batch" always shards over (data, fsdp) — fsdp acts as extra DP for
# activations, the standard ZeRO-3 trick.
_BATCH = ("data", "fsdp")

RULES_DP: Rules = {"batch": _BATCH}

RULES_FSDP: Rules = {
    "batch": _BATCH,
    # Params: shard the largest dim over fsdp (all-gathered at use).
    "embed": "fsdp",
    "vocab": "tensor",
    "mlp": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
}

RULES_TP: Rules = {
    "batch": _BATCH,
    "layers": "pipe",  # layer stack split across pipeline stages
    "vocab": "tensor",
    "mlp": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
    "embed": "fsdp",
    "seq_act": "seq",  # activation sequence dim under context parallelism
    "expert": "expert",
}

DEFAULT_RULES = RULES_TP  # superset table; unused mesh axes are size-1


def logical_to_mesh_spec(logical: LogicalSpec, rules: Rules,
                         mesh: DeviceMesh) -> MeshAxes:
    """Map a logical spec to mesh axes per dim (a ``PartitionSpec``'s
    entries), dropping axes the mesh doesn't have or that have size 1, and
    any axis an earlier dim of the same spec already took."""
    shape = mesh_shape(mesh)
    out = []
    used = set()
    for name in logical:
        if name is None:
            out.append(None)
            continue
        mapped = rules.get(name)
        if mapped is None:
            out.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        axes = tuple(
            a for a in axes if a in shape and shape[a] > 1 and a not in used
        )
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one entry of a mesh spec (None, a name, a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@functools.lru_cache(maxsize=16)
def dtensor_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The axes of ``mesh`` with size > 1 (its first axis if none is), the
    mesh the DTensors of a step live on."""
    names = tuple(a for a, n in mesh_shape(mesh).items() if n > 1)
    names = names or tuple(mesh.mesh_dim_names[:1])
    return mesh if names == tuple(mesh.mesh_dim_names) else mesh[names]


def placements(logical: LogicalSpec, rules: Rules,
               mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """One DTensor placement per axis of ``dtensor_mesh(mesh)`` for a tensor
    tagged ``logical``."""
    names = list(dtensor_mesh(mesh).mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(logical_to_mesh_spec(logical, rules, mesh)):
        axes = entry_axes(entry)
        index = [names.index(a) for a in axes]
        if index != sorted(index):
            # DTensor splits a dim over its mesh axes in mesh order.
            raise ValueError(f"dim {dim} of {logical} maps to mesh axes "
                             f"{axes}, not in the mesh's order {names}")
        for i in index:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements on it (``jax.sharding.NamedSharding``)."""

    mesh: DeviceMesh
    placements: Tuple[Placement, ...]

    def distribute(self, t: torch.Tensor) -> DTensor:
        """A global tensor, the same on every rank, as this DTensor."""
        return distribute_tensor(t, self.mesh, self.placements)


def named_sharding(mesh: DeviceMesh, logical: LogicalSpec,
                   rules: Optional[Rules] = None) -> NamedSharding:
    return NamedSharding(dtensor_mesh(mesh),
                         placements(logical, rules or DEFAULT_RULES, mesh))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] = lambda x: False) -> Any:
    """``fn`` over the leaves of nested dicts (and of the trees in ``rest``,
    which have the same keys)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(mesh: DeviceMesh, logical_tree: Any,
                   rules: Optional[Rules] = None) -> Any:
    """Map a tree of LogicalSpecs to a tree of NamedShardings."""
    rules = rules or DEFAULT_RULES
    return tree_map(lambda spec: named_sharding(mesh, spec, rules),
                    logical_tree, is_leaf=_is_spec)


def constrain(x: DTensor, mesh: DeviceMesh, logical: LogicalSpec,
              rules: Optional[Rules] = None) -> DTensor:
    """Redistribute a DTensor to the placements of its logical names (t5x's
    logical constraint, ``with_sharding_constraint`` in the JAX package)."""
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain takes a DTensor, got {type(x).__name__}")
    s = named_sharding(mesh, logical, rules)
    return x.redistribute(s.mesh, s.placements)


def replicated(mesh: DeviceMesh) -> NamedSharding:
    mesh = dtensor_mesh(mesh)
    return NamedSharding(mesh, (Replicate(),) * mesh.ndim)


def shard_batch(mesh: DeviceMesh, batch: Any) -> Any:
    """Place a host batch (the same on every rank) onto the mesh, its first
    dim sharded over the batch axes."""
    device = mesh_device(mesh)

    def put(x):
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x).to(device)
        if t.ndim == 0:
            return replicated(mesh).distribute(t)
        spec: LogicalSpec = ("batch",) + (None,) * (t.ndim - 1)
        return named_sharding(mesh, spec).distribute(t)

    return tree_map(put, batch)


def gather_for_use(w: torch.Tensor) -> torch.Tensor:
    """A weight split over the mesh axes that split the batch (``data`` and
    ``fsdp``: ZeRO-3), gathered whole over them for its use, so a product
    with batch-split activations moves the weight and not the activations;
    its backward reduce-scatters the gradient. Splits over other axes
    (``tensor``) stay. A no-op outside a sharding context."""
    ctx = current_sharding_ctx()
    if ctx is None or not isinstance(w, DTensor):
        return w
    rows = placements(("batch",), ctx[1], ctx[0])
    want = tuple(Replicate() if isinstance(r, Shard) else p
                 for r, p in zip(rows, w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a global value that every rank computed alike, as a replicated
    DTensor on ``ref``'s mesh when ``ref`` is a DTensor; else ``t``. For the
    few plain tensors a model makes beside its DTensor activations (rope
    tables, loss weights): DTensor refuses to mix the two."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


# --------------------------------------------------------- sharding context
# Models call maybe_constrain() on activations; it is a no-op unless a
# trainer established a (mesh, rules) context around the step. This keeps
# model code mesh-agnostic (the same function runs on one device and on a
# mesh).

_ctx = threading.local()


@contextlib.contextmanager
def _with_ctx(val):
    prev = getattr(_ctx, "val", None)
    _ctx.val = val
    try:
        yield
    finally:
        _ctx.val = prev


def sharding_ctx(mesh: DeviceMesh, rules: Optional[Rules] = None):
    return _with_ctx((mesh, rules or DEFAULT_RULES))


def current_sharding_ctx() -> Optional[Tuple[DeviceMesh, Rules]]:
    return getattr(_ctx, "val", None)


def no_sharding_ctx():
    """Suspend the context (inside ``local_map`` bodies, which see plain
    local tensors)."""
    return _with_ctx(None)


def maybe_constrain(x: torch.Tensor, logical: LogicalSpec) -> torch.Tensor:
    ctx = current_sharding_ctx()
    if ctx is None:
        return x
    mesh, rules = ctx
    return constrain(x, mesh, logical, rules)

