"""Cross-process collectives with a group object (counterpart of the JAX
package's ``parallel/collectives.py``, ``ray.util.collective`` parity).

Reference: python/ray/util/collective/collective.py (init_collective_group
:120, allreduce :258, GroupManager :40). Host-level collectives synchronise
processes that are not in one program: CPU workers, barriers, values a
driver hands out. The hot path's collectives are not here: they are the
mesh's NCCL collectives (``parallel/mesh.py``, ``parallel/sharding.py``).

Each group is one of ``util/collective.py``'s gloo groups. With no
``store_address`` the rendezvous is a ``torch.distributed.FileStore``
under the temporary directory, named after the group and the members'
parent process (the reference's named rendezvous actor): every member of
a group runs on one host and was started by the same process, and a file
left by a run that crashed is never read by the next. Rank 0 removes the
file in ``destroy_collective_group``, between two barriers: every member
is past its rendezvous, and none opens the file again. The
values are the reference's: ``allreduce`` takes a numpy array or a tree of
them (dicts, lists, tuples) and reduces with ``sum``, ``mean``, ``max`` or
``min``; ``allgather`` and ``broadcast`` take any picklable value. Each
round gathers every rank's value and reduces them in rank order, as the
reference's rendezvous does, so every rank gets the same bits.

On the CPU, in each of two processes: ``g = init_collective_group(2,
rank, "grp")``, then ``g.allreduce({"a": np.ones(3)})``.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from ..util import collective as host


def _tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples), the JAX package's ``jax.tree.map`` over numpy leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts)
                           for parts in zip(*trees))
    return fn(*trees)


def _tree_reduce(trees: List[Any], op) -> Any:
    out = trees[0]
    for t in trees[1:]:
        out = _tree_map(lambda a, b: op(np.asarray(a), np.asarray(b)), out, t)
    return out


def _tree_scale(tree: Any, s: float) -> Any:
    return _tree_map(lambda a: np.asarray(a) * s, tree)


_REDUCE_OPS = {
    "sum": lambda xs: _tree_reduce(xs, np.add),
    "mean": lambda xs: _tree_scale(_tree_reduce(xs, np.add), 1.0 / len(xs)),
    "max": lambda xs: _tree_reduce(xs, np.maximum),
    "min": lambda xs: _tree_reduce(xs, np.minimum),
}


class CollectiveGroup:
    def __init__(self, name: str, world_size: int, rank: int,
                 rendezvous: Optional[str] = None):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        # The FileStore this group's members met at, where it opened one.
        self.rendezvous = rendezvous

    def _gather(self, value: Any) -> List[Any]:
        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, value,
                               group=host.process_group(self.name))
        return out

    def allreduce(self, value, op: str = "sum"):
        """Reduce a numpy array (or a tree of arrays) across the group."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"op must be one of {sorted(_REDUCE_OPS)}, "
                             f"got {op!r}")
        return _REDUCE_OPS[op](self._gather(value))

    def allgather(self, value) -> List[Any]:
        return self._gather(value)

    def broadcast(self, value, src_rank: int = 0):
        box = [value if self.rank == src_rank else None]
        dist.broadcast_object_list(box, src=src_rank,
                                   group=host.process_group(self.name))
        return box[0]

    def reducescatter(self, value, op: str = "sum"):
        """Reduce then return this rank's equal slice along axis 0."""
        arr = np.asarray(self.allreduce(value, op))
        return np.array_split(arr, self.world_size, axis=0)[self.rank]

    def barrier(self) -> None:
        dist.barrier(group=host.process_group(self.name))


_groups: Dict[str, CollectiveGroup] = {}


def rendezvous_path(group_name: str, parent_pid: Optional[int] = None
                    ) -> str:
    """The FileStore of a group with no store address, for members started
    by ``parent_pid`` (by default this process's parent)."""
    parent = os.getppid() if parent_pid is None else parent_pid
    return os.path.join(tempfile.gettempdir(),
                        f"rtpu-collective-{parent}-{group_name}")


def init_collective_group(
    world_size: int,
    rank: int,
    group_name: str = "default",
    backend: str = "gloo",
    store_address: Optional[str] = None,
) -> CollectiveGroup:
    """Join a collective group; every member calls it with the same
    ``group_name``. Reference API: util/collective/collective.py:120."""
    path = None
    if store_address is None and not dist.is_initialized():
        path = rendezvous_path(group_name)
    host.init_collective_group(
        world_size, rank, backend, group_name,
        store_address or f"file://{rendezvous_path(group_name)}")
    group = CollectiveGroup(group_name, world_size, rank, path)
    _groups[group_name] = group
    return group


def get_group(group_name: str = "default") -> CollectiveGroup:
    return _groups[group_name]


def allreduce(value, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(value, op)


def allgather(value, group_name: str = "default"):
    return get_group(group_name).allgather(value)


def broadcast(value, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(value, src_rank)


def reducescatter(value, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).reducescatter(value, op)


def barrier(group_name: str = "default") -> None:
    get_group(group_name).barrier()


def destroy_collective_group(group_name: str = "default") -> None:
    group = _groups.pop(group_name, None)
    if group is None:
        return
    try:
        if group.rendezvous is not None:
            group.barrier()
            if group.rank == 0:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(group.rendezvous)
            group.barrier()
    finally:
        host.destroy_collective_group(group_name)
