"""The process's worker context (counterpart of the JAX package's
``core/context.py``).

It says what this process is to the port's core: the ``driver`` (the
process that called ``init``, the owner of every object), a ``task``
worker of the driver's pool, or an ``actor`` (which one), and which card
it took, if any, and the id of the one node (the driver's host, named by
the driver at ``init``). The JAX context also carries a client of its
cluster controller; a task worker's or an actor's line to the driver is
``core/api.py``'s ``_Client``, made where the process starts.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

ROLES = ("driver", "task", "actor")


@dataclasses.dataclass
class WorkerContext:
    role: str
    actor_id: Optional[str] = None
    card: Optional[int] = None
    pid: int = dataclasses.field(default_factory=os.getpid)
    node_id: str = ""


_context: Optional[WorkerContext] = None
task_local = threading.local()


def set_worker_context(c: Optional[WorkerContext]) -> None:
    global _context
    if c is not None and c.role not in ROLES:
        raise ValueError(f"role {c.role!r}: one of {ROLES}")
    _context = c


def get_worker_context() -> WorkerContext:
    if _context is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call "
                           "ray_tpu_torch.init() first")
    return _context


def current() -> Optional[WorkerContext]:
    """This process's context, or None (no core here)."""
    return _context


def is_initialized() -> bool:
    return _context is not None


def role() -> Optional[str]:
    return None if _context is None else _context.role


def current_actor_id() -> Optional[str]:
    return None if _context is None else _context.actor_id
