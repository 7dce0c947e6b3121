"""Fault-tolerant actors on the port's worker processes (counterpart of the
JAX package's ``rllib/utils/actor_manager.py``).

Parity: reference rllib/utils/actor_manager.py:196 FaultTolerantActorManager
(foreach_actor :573, probe_unhealthy_actors :823): calls fan out to a set of
actors; actors whose calls fail are marked unhealthy and skipped; restart
recreates them from the saved factory, so a lost env runner never kills the
training loop.

An actor here is one spawned process hosting one object
(:class:`ActorProcess`, which this module takes from the process core,
``core/worker.py``, on ``util/procs.py``'s loop, shared with the Train
layer's workers and the data pool): the object's class and arguments go by
plain pickle, by reference, and its methods are called over the pipe, in
order. Where the reference's actor runs on a CPU host or a GPU, the process
runs its torch on ``num_threads`` CPU threads or takes one card. Large
arguments and results travel as files (``procs.Spilled``): a runner's
fragment at Atari's shape is tens of MB. The submit/wait pair
(:meth:`FaultTolerantActorManager.submit`, :meth:`~FaultTolerantActorManager.wait_any`)
stands for ``actor.method.remote()`` and ``ray_tpu.wait(...,
num_returns=1)``.

Divergences by design: there is no preemption flag (the reference's
``_is_preempted_error``), since no control plane announces a departure;
an actor is "already dead" when its process has exited.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

from ...core.worker import (ActorError, ActorProcess, actor_payload,
                            collect)
from ...util import procs

__all__ = ["ActorError", "ActorProcess", "FaultTolerantActorManager",
           "Ticket", "actor_payload", "collect"]

logger = logging.getLogger(__name__)


class Ticket(NamedTuple):
    """A call submitted to one actor of a manager (its id, the actor's
    incarnation and the call's number)."""

    actor_id: int
    actor: ActorProcess
    seq: int


class FaultTolerantActorManager:
    """A set of actors, each from ``actor_factory(i)`` (an
    :class:`ActorProcess`), called together; failed actors are marked
    unhealthy and restored from the factory at most ``max_restarts`` times
    each."""

    def __init__(
        self,
        actor_factory: Callable[[int], ActorProcess],
        num_actors: int,
        *,
        max_restarts: int = 3,
    ):
        self._factory = actor_factory
        self._max_restarts = max_restarts
        self._actors: Dict[int, ActorProcess] = {}
        self._retired: List[ActorProcess] = []
        self._healthy: Dict[int, bool] = {}
        self._restarts: Dict[int, int] = {i: 0 for i in range(num_actors)}
        try:
            for i in range(num_actors):
                self._actors[i] = actor_factory(i)
                self._healthy[i] = True
        except BaseException:
            self.shutdown()  # no process left of those already spawned
            raise

    # ------------------------------------------------------------------ info

    @property
    def num_actors(self) -> int:
        return len(self._actors)

    def healthy_actor_ids(self) -> List[int]:
        return [i for i, ok in self._healthy.items() if ok]

    def actor(self, i: int) -> ActorProcess:
        return self._actors[i]

    def num_restarts(self, i: int) -> int:
        return self._restarts[i]

    # ------------------------------------------------------------------ calls

    def foreach_actor(
        self,
        fn_name: str,
        *args,
        actor_ids: Optional[Sequence[int]] = None,
        timeout: Optional[float] = None,
        **kwargs,
    ) -> List[Tuple[int, Any]]:
        """Call ``fn_name(*args, **kwargs)`` on each healthy actor (of
        ``actor_ids``), every call sent before any is waited on; returns
        ``[(actor_id, result)]`` for the calls that succeeded and marks
        the others' actors unhealthy."""
        ids = [i for i in (self.healthy_actor_ids() if actor_ids is None
                           else actor_ids) if self._healthy.get(i)]
        seqs = {self._actors[i]: self._actors[i].submit(fn_name, *args,
                                                         **kwargs)
                for i in ids}
        got = collect(seqs, timeout)
        out: List[Tuple[int, Any]] = []
        for i in ids:
            status, value = got[self._actors[i]]
            if status == "ok":
                out.append((i, value))
            else:
                logger.warning("actor %d call %s failed: %s", i, fn_name,
                               value)
                self._healthy[i] = False
        return out

    def submit(self, i: int, fn_name: str, *args, **kwargs
               ) -> Optional[Ticket]:
        """Send one call to actor ``i`` without waiting (the reference's
        ``actor.fn.remote(...)``); None, and the actor unhealthy, where it
        cannot be sent."""
        a = self._actors[i]
        if not self._healthy.get(i) or not a.proc.is_alive():
            self._healthy[i] = False
            return None
        return Ticket(i, a, a.submit(fn_name, *args, **kwargs))

    def wait_any(self, tickets: Sequence[Ticket],
                 timeout: Optional[float] = None
                 ) -> Optional[Tuple[Ticket, bool, Any]]:
        """The first of ``tickets`` to settle, as ``(ticket, ok, value)``
        (the reference's ``ray_tpu.wait(..., num_returns=1)`` and
        ``get``); a failed call's actor is marked unhealthy and ``value``
        says why. None where none settles within ``timeout``. A ticket of
        a replaced incarnation settles at once, failed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        dead: set = set()
        while True:
            for t in tickets:
                if t.actor is not self._actors.get(t.actor_id):
                    return t, False, "the actor was replaced"
                if t.seq in t.actor.replies:
                    status, value = t.actor.replies.pop(t.seq)
                    if status != "ok":
                        self._healthy[t.actor_id] = False
                    return t, status == "ok", value
            for t in tickets:
                if t.actor in dead:
                    self._healthy[t.actor_id] = False
                    return t, False, t.actor.failure()
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return None
            replies, died = procs.wait(list({t.actor for t in tickets}),
                                       left)
            for a, seq, status, value in replies:
                a.keep(seq, status, value)
            dead.update(died)

    def restore_unhealthy(self) -> int:
        """Stop each unhealthy actor's process and spawn a new one from
        the factory (at most ``max_restarts`` times an actor). Returns the
        number restored."""
        restored = 0
        for i, ok in list(self._healthy.items()):
            if ok or self._restarts[i] >= self._max_restarts:
                continue
            old = self._actors[i]
            procs.stop([old])
            self._retired.append(old)
            self._actors[i] = self._factory(i)
            self._healthy[i] = True
            self._restarts[i] += 1
            restored += 1
        return restored

    def io(self) -> Dict[str, float]:
        """The calling process's seconds moving calls to and from every
        actor, retired incarnations included (:meth:`ActorProcess.io`)."""
        total = {"send_s": 0.0, "recv_s": 0.0, "load_s": 0.0}
        for a in list(self._actors.values()) + self._retired:
            for k, v in a.io().items():
                total[k] += v
        return total

    def shutdown(self) -> None:
        """Stop every actor process; none is left behind."""
        procs.stop(list(self._actors.values()))
        self._actors.clear()
        self._healthy.clear()
