"""Host-level collectives on numpy arrays between worker processes.

The port's counterpart of the JAX package's ``util/collective.py`` (the
reference's ``ray.util.collective``: init_collective_group, allreduce,
reduce, broadcast, allgather, reducescatter, send/recv). There a named
rendezvous actor combines every round; here each group is a gloo process
group of ``torch.distributed``: a new gloo group over the world when the
default group is already up (NCCL on the cards, say), else a default gloo
group started from a store address the caller gives (the trainer
process's, ``worker_group.py``). Control-sized payloads: gradient smoke tests on the
CPU, barriers, weight broadcast outside a mesh. The reduce semantics are
the reference's: ``reduce`` returns the reduced array on ``dst_rank`` and
the input elsewhere, ``reducescatter`` splits the reduced array along
axis 0 with ``np.array_split``, ``broadcast`` takes ``None`` on the
receivers.
"""
from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
        "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
# A member that never arrives (a dead peer) fails the round after this,
# as the reference's rendezvous times out a round.
TIMEOUT = timedelta(seconds=300)


@dataclass
class _GroupState:
    name: str
    world_size: int
    rank: int
    group: Any  # the gloo ProcessGroup
    owns_default: bool  # this group started the default process group


# Every group spans the whole world in rank order, so a group rank is a
# world rank. Process-global group registry (the reference's GroupManager): a worker
# joins on its command thread and runs collectives from the train-loop
# thread.
_process_groups: Dict[str, _GroupState] = {}


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "host",
    group_name: str = "default",
    store_address: Optional[str] = None,
) -> None:
    """Join this process into a collective group. Every member calls it
    with the same ``group_name``. With no default process group up,
    ``store_address`` (``"host:port"`` of a TCPStore server that outlives
    the group) starts a default gloo group of ``world_size`` processes."""
    if backend not in ("host", "gloo"):
        raise ValueError(f"backend {backend!r}: the port's host collectives "
                         "run on gloo ('host')")
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    if group_name in _process_groups:
        raise RuntimeError(f"collective group {group_name!r} already initialized")
    owns_default = not dist.is_initialized()
    if owns_default:
        if store_address is None:
            raise RuntimeError(
                "no process group is up: pass store_address to start one")
        host, port = store_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world_size, is_master=False,
                              timeout=TIMEOUT)
        dist.init_process_group(
            "gloo", store=dist.PrefixStore(f"collective/{group_name}", store),
            world_size=world_size, rank=rank, timeout=TIMEOUT)
        group = dist.group.WORLD
    else:
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise ValueError(
                f"rank {rank} of {world_size}: the process group up is rank "
                f"{dist.get_rank()} of {dist.get_world_size()}")
        group = (dist.group.WORLD if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo", timeout=TIMEOUT))
    _process_groups[group_name] = _GroupState(group_name, world_size, rank,
                                              group, owns_default)


def destroy_collective_group(group_name: str = "default") -> None:
    st = _process_groups.pop(group_name, None)
    if st is None:
        return
    if st.owns_default:
        dist.destroy_process_group()
    elif st.group is not dist.group.WORLD:
        dist.destroy_process_group(st.group)


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _process_groups


def get_rank(group_name: str = "default") -> int:
    return _state(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _state(group_name).world_size


def _state(group_name: str) -> _GroupState:
    st = _process_groups.get(group_name)
    if st is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "process; call init_collective_group first"
        )
    return st


def allreduce(tensor: np.ndarray, group_name: str = "default", op: str = "sum") -> np.ndarray:
    """Returns the reduced array (the reference's numpy callers assign the
    return too)."""
    st = _state(group_name)
    t = torch.from_numpy(np.array(tensor, order="C"))  # a copy: in place
    dist.all_reduce(t, op=_OPS[op], group=st.group)
    return t.numpy()


def allreduce_multigpu(tensor_list, group_name: str = "default", op: str = "sum"):
    return [allreduce(t, group_name, op) for t in tensor_list]


def reduce(tensor: np.ndarray, dst_rank: int = 0, group_name: str = "default", op: str = "sum"):
    out = allreduce(tensor, group_name, op)
    return out if get_rank(group_name) == dst_rank else tensor


def broadcast(tensor: Optional[np.ndarray], src_rank: int = 0, group_name: str = "default"):
    st = _state(group_name)
    box = [np.asarray(tensor) if st.rank == src_rank else None]
    dist.broadcast_object_list(box, src=src_rank,
                               group=st.group)
    return box[0]


def allgather(tensor: np.ndarray, group_name: str = "default") -> List[np.ndarray]:
    st = _state(group_name)
    out: List[Any] = [None] * st.world_size
    dist.all_gather_object(out, np.asarray(tensor), group=st.group)
    return out


def reducescatter(tensor: np.ndarray, group_name: str = "default", op: str = "sum") -> np.ndarray:
    st = _state(group_name)
    red = allreduce(tensor, group_name, op)
    return np.array_split(red, st.world_size, axis=0)[st.rank]


def barrier(group_name: str = "default") -> None:
    dist.barrier(group=_state(group_name).group)


def send(tensor: np.ndarray, dst_rank: int, group_name: str = "default") -> None:
    st = _state(group_name)
    dist.send_object_list([np.asarray(tensor)], dst=dst_rank,
                          group=st.group)


def recv(src_rank: int, group_name: str = "default") -> np.ndarray:
    st = _state(group_name)
    box = [None]
    dist.recv_object_list(box, src=src_rank, group=st.group)
    return box[0]

