"""Device-mesh formation: a ``DeviceMesh`` over the world's processes.

The counterpart of the JAX package's ``parallel/mesh.py``. There the mesh is
a ``jax.sharding.Mesh`` over the slice's devices and XLA emits the
collectives; here it is a ``torch.distributed.device_mesh.DeviceMesh`` with
one process per device, and DTensor issues the collectives (NCCL on CUDA,
gloo on the CPU). The axis names and their order are the JAX package's, and
every axis is kept, size 1 included, so a rule table names the same axes on
both sides:

    data  — pure data parallelism (gradient all-reduce)
    fsdp  — ZeRO-style parameter/optimizer sharding (all-gather + reduce-scatter)
    tensor— megatron-style intra-layer model parallelism
    seq   — sequence/context parallelism (ring attention neighbors)
    expert— MoE expert parallelism (all-to-all)
    pipe  — pipeline stages (ppermute microbatch handoff)

The port trains over every axis: ``seq`` through ring and Ulysses
attention (``ops/ring_attention.py``, ``ops/ulysses_attention.py``),
``expert`` through the MoE layer (``ops/moe.py``; its tokens stay where
the batch split puts them, so no all-to-all), ``pipe`` through the GPipe
schedule (``parallel/pipeline.py``; point-to-point hand-offs).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

AXIS_ORDER: Tuple[str, ...] = ("pipe", "data", "fsdp", "seq", "expert", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout. -1 on at most one axis means "fill with
    remaining devices" (like torch DeviceMesh / t5x partitioning)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1

    def sizes(self) -> Dict[str, int]:
        return {
            "pipe": self.pipe,
            "data": self.data,
            "fsdp": self.fsdp,
            "seq": self.seq,
            "expert": self.expert,
            "tensor": self.tensor,
        }

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        wildcards = [k for k, v in sizes.items() if v == -1]
        if len(wildcards) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wildcards:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wildcards[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh spec {sizes} needs {fixed} devices, have {n_devices}")
        return MeshSpec(**{k: sizes[k] for k in ("data", "fsdp", "tensor", "pipe", "seq", "expert")})

    @property
    def num_devices(self) -> int:
        return math.prod(self.sizes().values())


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """Axis name -> size, as ``jax.sharding.Mesh.shape`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process holds its shards on."""
    if mesh.device_type == "cuda":
        return resolve_device("cuda")
    return torch.device(mesh.device_type)


def make_mesh(spec: MeshSpec, device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh over every process of the world, in the canonical axis
    order. One process per device: rank r holds device r of the mesh, and
    the trailing axes (``tensor`` innermost) are the ranks nearest each
    other. ``device_type`` is ``cuda`` unless the caller asks for another
    (the CPU tests pass ``"cpu"``); the process group must be up
    (:class:`MeshBootstrap`)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call MeshBootstrap.initialize() "
                           "(or torch.distributed.init_process_group) first")
    device_type = device_type or resolve_device(None).type
    spec = spec.resolve(dist.get_world_size())
    sizes = spec.sizes()
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """Every axis of size 1: the mesh of a world of one process."""
    return make_mesh(MeshSpec(), device_type)


def best_effort_spec(
    n_devices: int,
    *,
    want_fsdp: bool = False,
    want_tensor: int = 1,
) -> MeshSpec:
    """A sane default layout: tensor innermost, remainder to fsdp or data."""
    if n_devices % want_tensor != 0:
        raise ValueError(f"{n_devices} devices not divisible by tensor={want_tensor}")
    rest = n_devices // want_tensor
    if want_fsdp:
        return MeshSpec(fsdp=rest, tensor=want_tensor)
    return MeshSpec(data=rest, tensor=want_tensor)


@dataclasses.dataclass
class MeshBootstrap:
    """What each process of a world needs to join it: the address of process
    0, the world size and this process's rank (the JAX package's
    ``jax.distributed.initialize`` arguments). ``initialize()`` starts the
    default process group before any mesh is made.

    ``coordinator_address`` is ``"host:port"`` (TCP) or an init-method URL
    (``file:///path`` for processes of one host). ``local_rank`` picks the
    card (default ``LOCAL_RANK``, else the rank); ``device_type`` is ``cuda``
    unless the caller asks for ``"cpu"``."""

    coordinator_address: str
    num_processes: int
    process_id: int
    local_rank: Optional[int] = None
    device_type: Optional[str] = None

    def initialize(self) -> None:
        device_type = self.device_type or resolve_device(None).type
        if device_type == "cuda":
            local = self.local_rank
            if local is None:
                local = int(os.environ.get("LOCAL_RANK", self.process_id))
            torch.cuda.set_device(local)
            backend = "nccl"
        else:
            backend = "gloo"
        addr = self.coordinator_address
        init_method = addr if "://" in addr else f"tcp://{addr}"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=self.num_processes,
                                rank=self.process_id)
