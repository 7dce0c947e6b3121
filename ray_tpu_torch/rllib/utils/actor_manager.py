"""Fault-tolerant actors on the port's worker processes (counterpart of the
JAX package's ``rllib/utils/actor_manager.py``).

Parity: reference rllib/utils/actor_manager.py:196 FaultTolerantActorManager
(foreach_actor :573, probe_unhealthy_actors :823): calls fan out to a set of
actors; actors whose calls fail are marked unhealthy and skipped; restart
recreates them from the saved factory, so a lost env runner never kills the
training loop.

An actor here is one spawned process hosting one object
(:class:`ActorProcess`, on ``util/procs.py``'s core, shared with the Train
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
import multiprocessing
import os
import pickle
import time
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple)

from ...util import procs

logger = logging.getLogger(__name__)


class ActorError(RuntimeError):
    """A call on an actor process failed: the call raised (the worker's
    traceback is in the message), the process died, or the call timed
    out."""

    def __init__(self, name: str, method: str, why: str):
        super().__init__(f"{name}: {method} failed: {why}")
        self.name = name
        self.method = method


# ---------------------------------------------------------- the actor side


class _Hosted:
    """The object an actor process serves: the user's object, whose
    methods the calls reach, plus the process's own meter."""

    def __init__(self, obj: Any, io: Dict[str, float]):
        self._obj = obj
        self._io = io
        self._call_s: Dict[str, float] = {}

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._obj, name)
        if not callable(attr):
            return attr

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return attr(*args, **kwargs)
            finally:
                self._call_s[name] = (self._call_s.get(name, 0.0)
                                      + time.perf_counter() - t)

        return timed

    def process_info(self) -> Dict[str, Any]:
        """Where this actor runs and what it spent: its pid, the device of
        the object (if it has one), whether CUDA was ever initialised in
        the process, its torch threads, the seconds each method took and
        the seconds spent reading calls (``recv_s``) and answering
        (``send_s``), files included."""
        import sys

        torch = sys.modules.get("torch")
        device = getattr(self._obj, "device", None)
        return {
            "pid": os.getpid(),
            "device": None if device is None else str(device),
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized()),
            "num_threads": None if torch is None else torch.get_num_threads(),
            "call_s": dict(self._call_s),
            **self._io,
        }


def _actor_main(conn, payload: bytes, card: Optional[int],
                num_threads: Optional[int], spill_dir: str,
                spill_results: Tuple[str, ...]) -> None:
    """An actor process: take the card (or set the CPU threads), then
    build the object from the payload and serve its calls; the results of
    ``spill_results`` methods go back as files."""
    t_main = time.time()
    if card is not None:
        procs.take_card(card)
    elif num_threads is not None:
        import torch

        torch.set_num_threads(num_threads)
    io = {"recv_s": 0.0, "send_s": 0.0}

    def build() -> _Hosted:
        cls, args, kwargs = pickle.loads(payload)
        return _Hosted(cls(*args, **kwargs), io)

    def spill(seq: int, method: str, value: Any) -> Any:
        if method not in spill_results:
            return value
        return procs.Spilled(os.path.join(spill_dir, f"{seq}.out"), value)

    procs.serve(conn, build, ready={"t_main": t_main}, load=procs.unspill,
                wrap=spill, io=io)


# ------------------------------------------------------ the calling process


class ActorProcess(procs.Worker):
    """The calling process's handle on one actor process.

    ``cls(*args, **kwargs)`` is built there (``payload`` from
    :func:`actor_payload`), on the card ``card`` or on ``num_threads`` CPU
    threads. Positional arguments of ``spill_args`` methods that are
    dicts (batches) travel as files, and so do the results of
    ``spill_results`` methods. Replies are kept on the handle by call
    number until taken."""

    def __init__(self, payload: bytes, name: str, *, spill_dir: str,
                 card: Optional[int] = None,
                 num_threads: Optional[int] = None,
                 spill_args: Iterable[str] = (),
                 spill_results: Iterable[str] = ()):
        super().__init__(multiprocessing.get_context("spawn"), _actor_main,
                         (payload, card, num_threads, spill_dir,
                          tuple(spill_results)), name)
        self.name = name
        self.spill_dir = spill_dir
        self.spill_args = frozenset(spill_args)
        self.replies: Dict[int, Tuple[str, Any]] = {}
        self.abandoned: set = set()
        self._n_spilled = 0
        # Seconds the calling process spent writing argument files
        # (``send_s``) and reading result files (``load_s``); the pipe's
        # own reads are ``recv_s``.
        self.send_s = 0.0
        self.load_s = 0.0

    @property
    def spawn_s(self) -> Optional[float]:
        """Seconds from the spawn to the actor's ready answer (its
        interpreter, imports, card and object), once it answered."""
        if self.ready is None:
            return None
        return self.ready["t_ready"] - self.t_start

    def submit(self, method: str, *args, **kwargs) -> int:
        """Send a call; return its number."""
        t = time.perf_counter()
        if method in self.spill_args:
            spilled = []
            for a in args:
                if isinstance(a, dict):
                    self._n_spilled += 1
                    path = os.path.join(
                        self.spill_dir,
                        f"{self.pid}-{self._n_spilled}.in")
                    a = procs.Spilled(path, a)
                spilled.append(a)
            args = tuple(spilled)
        seq = self.send(method, args, kwargs)
        self.send_s += time.perf_counter() - t
        return seq

    def keep(self, seq: int, status: str, value: Any) -> None:
        """File a reply read off the pipe, its result file read back (or
        removed, for a call nobody waits on any more)."""
        if isinstance(value, procs.Spilled):
            if seq in self.abandoned:
                value.discard()
            else:
                t = time.perf_counter()
                value = value.load()
                self.load_s += time.perf_counter() - t
        if seq in self.abandoned:
            self.abandoned.discard(seq)
            return
        self.replies[seq] = (status, value)

    def failure(self) -> str:
        """Why this actor can answer no more: its build's traceback, or
        its exit code."""
        if self.ready_error is not None:
            return f"its object did not build:\n{self.ready_error}"
        return f"the process died (exit code {self.exitcode()})"

    def call(self, method: str, *args, timeout: Optional[float] = None,
             **kwargs) -> Any:
        """``method(*args, **kwargs)`` there, waited for; raises
        :class:`ActorError` where it raised, the process died or
        ``timeout`` passed."""
        seq = self.submit(method, *args, **kwargs)
        results = collect({self: seq}, timeout)
        status, value = results[self]
        if status != "ok":
            raise ActorError(self.name, method, value)
        return value

    def io(self) -> Dict[str, float]:
        """The calling process's seconds moving this actor's calls:
        writing argument files and pickling calls (``send_s``), reading
        replies off the pipe (``recv_s``) and reading result files
        (``load_s``)."""
        return {"send_s": self.send_s, "recv_s": self.recv_s,
                "load_s": self.load_s}


def actor_payload(cls: Callable, args: Sequence = (),
                  kwargs: Optional[Dict[str, Any]] = None,
                  where: str = "actor processes") -> bytes:
    """``(cls, args, kwargs)`` pickled for an :class:`ActorProcess`. Each
    part is tried alone first, so one that cannot travel raises here,
    before any spawn, naming itself."""
    kwargs = dict(kwargs or {})
    hint = ("define it at module level (a class or a function), not inside "
            "a function or as a lambda")
    procs.dumps(cls, f"the actor's class or factory {cls!r}", where, hint)
    for name, value in [(f"argument {i}", a) for i, a in enumerate(args)] + [
            (k, v) for k, v in kwargs.items()]:
        procs.dumps(value, f"{name} {value!r}", where, hint)
    return pickle.dumps((cls, tuple(args), kwargs))


def collect(seqs: Dict[ActorProcess, int], timeout: Optional[float]
            ) -> Dict[ActorProcess, Tuple[str, Any]]:
    """Wait for the replies numbered ``seqs`` (actor -> call number) and
    return actor -> ``(status, value)``: ``("ok", result)``, or ``("err",
    why)`` for a call that raised, an actor that died and a call still
    unanswered after ``timeout`` (then abandoned: its reply, if it comes,
    is dropped)."""
    pending = dict(seqs)
    out: Dict[ActorProcess, Tuple[str, Any]] = {}
    deadline = None if timeout is None else time.monotonic() + timeout

    def settle() -> None:
        for a in list(pending):
            if pending[a] in a.replies:
                out[a] = a.replies.pop(pending.pop(a))

    settle()
    while pending:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            for a, seq in pending.items():
                a.abandoned.add(seq)
                out[a] = ("err", f"no answer in {timeout} s")
            break
        replies, dead = procs.wait(list(pending), left)
        for a, seq, status, value in replies:
            a.keep(seq, status, value)
        settle()
        for a in dead:
            if a in pending:
                del pending[a]
                out[a] = ("err", a.failure())
    return out


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
