"""Pluggable collective bring-up on the worker group.

The port's counterpart of the JAX package's ``train/backend.py`` (the
reference's Backend: on_start/on_training_start/on_shutdown, and
_TorchBackend's process-group setup). ``TorchBackend`` takes the place of
``JaxBackend``: every rank joins one ``torch.distributed`` world (NCCL on
the cards, gloo on the CPU) through the port's ``MeshBootstrap``, and
builds a ``DeviceMesh`` into its session. ``HostCollectiveBackend`` joins
every worker into a gloo group for ``util.collective``.

The rendezvous store is the trainer process's: ``start_store`` binds a
TCPStore server on a free port (the kernel picks it, so two runs side by
side never race for one) and keeps it for the life of the group; every
rank connects to it as a client. The workers' hooks are module-level
functions: they go to the workers by pickle, by reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, Optional

import torch.distributed as dist

from .session import _get_session
from .worker_group import WorkerGroup

# A rank that never arrives (a dead peer) fails the others' group start
# after this.
STORE_TIMEOUT = timedelta(seconds=300)
# on_shutdown waits this long for the workers' teardown; a worker stuck in
# a collective with a dead peer is then terminated by the group.
TEARDOWN_TIMEOUT_S = 10.0


class Backend:
    """Hooks around the worker group lifecycle."""

    def on_start(self, worker_group: WorkerGroup) -> None:  # noqa: B027
        pass

    def on_training_start(self, worker_group: WorkerGroup) -> None:  # noqa: B027
        pass

    def on_shutdown(self, worker_group: WorkerGroup) -> None:  # noqa: B027
        pass


def start_store() -> dist.TCPStore:
    """A TCPStore server in this process on a port the kernel picks."""
    return dist.TCPStore("localhost", 0, None, True, timeout=STORE_TIMEOUT,
                         wait_for_workers=False)


def _address(store: dist.TCPStore) -> str:
    return f"localhost:{store.port}"


def _client_store(address: str, world: int) -> dist.TCPStore:
    host, port = address.rsplit(":", 1)
    return dist.TCPStore(host, int(port), world, False, timeout=STORE_TIMEOUT)


@dataclass
class HostCollectiveBackend(Backend):
    """Joins every worker into a host collective group (``util.collective``
    on gloo) for CPU smoke tests and control-sized payloads."""

    group_name: str = "train_default"
    _store: Any = field(default=None, init=False, repr=False)

    def on_start(self, worker_group: WorkerGroup) -> None:
        self._store = start_store()
        n = len(worker_group)
        worker_group.call("join_collective", [
            (n, m.world_rank, "host", self.group_name, _address(self._store))
            for m in worker_group.workers])

    def on_training_start(self, worker_group: WorkerGroup) -> None:
        worker_group.foreach("setup_session_extras", self.group_name)

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        # Workers may already be dead, or stuck in a round with a dead
        # peer: the teardown is bounded, and the group kills what is left.
        try:
            worker_group.call("execute", [(_leave_group, self.group_name)]
                              * len(worker_group), timeout=TEARDOWN_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        self._store = None


def _leave_group(group_name: str) -> None:
    from ..util import collective

    collective.destroy_collective_group(group_name)


@dataclass
class TorchBackend(Backend):
    """Brings up ``torch.distributed`` across the worker group.

    ``on_start``: every rank calls ``MeshBootstrap(...).initialize()`` on
    the trainer process's store (NCCL on the cards, gloo on the CPU), the
    analog of the JAX package's ``jax.distributed.initialize``.
    ``on_training_start``: each rank builds
    ``make_mesh(MeshSpec(**mesh_shape))``, or ``best_effort_spec(world)``
    (all ranks on ``data``), into its session (``train.get_mesh()``).
    ``on_shutdown``: ``destroy_process_group``.
    """

    mesh_shape: Optional[Dict[str, int]] = None
    _store: Any = field(default=None, init=False, repr=False)

    def on_start(self, worker_group: WorkerGroup) -> None:
        self._store = start_store()
        n = len(worker_group)
        worker_group.call("execute", [
            (_setup_torch, m.world_rank, n, _address(self._store),
             worker_group.device_type) for m in worker_group.workers])

    def on_training_start(self, worker_group: WorkerGroup) -> None:
        worker_group.execute(_build_mesh, self.mesh_shape,
                             worker_group.device_type)

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        try:
            worker_group.call("execute", [(_teardown_torch,)]
                              * len(worker_group), timeout=TEARDOWN_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        self._store = None


def _setup_torch(rank: int, world: int, address: str, device_type: str) -> None:
    from ..parallel.mesh import MeshBootstrap

    MeshBootstrap(address, world, rank, local_rank=rank,
                  device_type=device_type,
                  store=_client_store(address, world)).initialize()


def _build_mesh(shape: Optional[Dict[str, int]], device_type: str) -> None:
    from ..parallel.mesh import MeshSpec, best_effort_spec, make_mesh

    spec = (MeshSpec(**shape) if shape
            else best_effort_spec(dist.get_world_size()))
    _get_session().mesh = make_mesh(spec, device_type)


def _teardown_torch() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


BACKENDS = {
    "host": HostCollectiveBackend,
    "torch": TorchBackend,
}
