"""The port's core API on one host: tasks, actors and objects (the
single-host subset of the JAX package's ``core/api.py``).

``init`` makes this process the driver. The driver holds every object,
ref and handle; the work runs in processes of this host, all children of
the driver (``util/procs.py``'s loop, ``core/worker.py``'s hosts):

- a task (``@remote`` function) runs on a pool of task workers, spawned
  as the tasks need them, at most ``num_cpus`` at once; a worker imports
  what the function's module imports, so one that runs numpy never loads
  torch. Arguments and results of ``serialization.SPILL_BYTES`` (1 MiB)
  or more travel as files (``procs.Spilled``), the pipe carrying names;
- an actor (``@remote`` class) is a process of its own, spawned (or, for
  an actor that asks a preload, forked from multiprocessing's fork server,
  which imported it once and never touches CUDA). Its calls run in their
  order of submission. ``max_restarts`` restarts a process that died,
  restoring the newest checkpoint where ``checkpoint_every_n`` or
  ``checkpoint_interval_s`` wrote one; ``max_task_retries`` replays the
  calls it had not answered, and the restored journal answers those that
  were applied without running them again;
- an object is a value in the driver: ``put`` copies it in, a task's or a
  call's result lands there, ``get`` and ``wait`` read it.

One reader thread of the driver (``rtpt-core-reader``) reads every
process's answers and deaths and sends the work that became ready.

Cards: ``num_gpus`` is 0 or 1, as everywhere in the port; an actor or
task that asks 1 takes a card of its own (``procs.take_card``) and raises
before any spawn where there is no CUDA or no free card.

The driver is the owner of every object and the server of its children
(the JAX package's ownership sidecar and controller, on one host). An
``ObjectRef`` or an ``ActorHandle`` passes into a task or an actor, at
the top of an argument or nested in one, and arrives as a ref or a
handle (``serialization.py``); a task worker or an actor process then
talks to the driver through a :class:`_Client` over the pipe it already
has: it submits tasks and actor calls, creates actors, puts, gets,
waits, looks up and kills actors, and the driver's reader answers on
the same pipe. A ref the driver sent to a process pins its object until
the process drops its last copy or exits. A task blocked in ``get`` or
``wait`` gives its CPUs back while it waits (the JAX package's
``_with_block_notify``), so ``init(num_cpus=1)`` runs a task that waits
on a task. Task options ``max_retries`` (a task whose worker died runs
again, up to n times) and ``retry_exceptions`` (an error the task raised
is retried too) are the JAX package's; ``catch_exceptions`` is carried
for workflows (``workflow/executor.py``) and not acted on here. An actor
with ``async def`` methods runs every call on one event loop of its own
(``core/worker.py``), up to ``max_concurrency`` (default 100) at once;
its sync methods, and every method of a sync actor, run on
``max_concurrency`` threads of its process (default 1, in order).

The rest of the JAX package's core API on one host:

- ``cancel(ref, force=False, recursive=False)``: a task or actor call
  still queued in the driver fails there at once with
  ``TaskCancelledError``; one queued in its process is answered by that
  process's pipe reader without waiting for the calls ahead of it; a
  running one gets the error raised in its own thread. ``force`` stops a
  task's worker process (the pool frees its card and spawns another when
  one is needed); on an actor call it degrades to the raise.
  ``recursive`` also cancels what the task or call submitted from its
  process, through a parent that has finished. Cancelling twice, or a
  finished ref, does nothing.
- ``deadline_s`` (a task option, and ``ActorMethod.options``): past it, a
  call that has not started fails with ``DeadlineExceededError`` where it
  leaves the driver's queue or where its process dequeues it.
- ``num_returns="streaming"`` returns an :class:`ObjectRefGenerator`:
  each value the generator yields becomes an object of the driver,
  reported at once; the driver holds back its answer to the producer
  while the consumer lags more than ``_generator_backpressure_num_objects``
  (16) items, without blocking its reader (the answer is sent when the
  consumer catches up); ``close()`` makes the producer's next report
  answer ``closed``, and it closes its generator.
- ``free``, ``error_of``, ``get_runtime_context``,
  ``available_resources`` and ``nodes`` (one node).
- With tracing on (``util/tracing.py``), each submission records a
  PRODUCER span and carries its context; the task or call runs in a
  CONSUMER span of the same trace.

Divergences by design: one host; functions, classes and arguments go by
plain pickle, by reference, so a nested class or function, a closure or
a lambda raises ``TypeError`` naming itself before any spawn; a running
call that a cancel stopped fails with ``TaskCancelledError`` itself (the
JAX package wraps it in ``TaskError``); ``get_accelerator_ids()`` names
the card under ``"GPU"``.
"""
from __future__ import annotations

import atexit
import dataclasses
import itertools
import logging
import multiprocessing
import multiprocessing.connection as mpc
import os
import pickle
import queue
import shutil
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

from ..util import procs
from . import context as ctx
from . import serialization
from . import worker as core_worker
from .ids import ActorID, NodeID, ObjectID, TaskID
from .serialization import ObjectRef

logger = logging.getLogger(__name__)

TASK_OPTIONS = ("num_cpus", "num_gpus", "num_returns", "name",
                "max_retries", "retry_exceptions", "catch_exceptions",
                "deadline_s", "_generator_backpressure_num_objects")
# Items a streaming generator's producer may run ahead of its consumer.
BACKPRESSURE_DEFAULT = 16
ACTOR_OPTIONS = ("num_cpus", "num_gpus", "name", "max_restarts",
                 "max_task_retries", "checkpoint_interval_s",
                 "checkpoint_every_n", "max_concurrency", "_preload")
# Seconds an actor that is being killed or retired gets to leave.
_STOP_S = 5.0


class RayTpuError(Exception):
    """Base of the core's errors."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` found the object not ready within its timeout."""


class WorkerCrashedError(RayTpuError):
    """The task worker running a task died."""


class NodePreemptedError(WorkerCrashedError):
    """The node left on a planned departure (the JAX package's drain and
    preemption; the port's one node never raises it)."""

    preempted = True


class ActorDiedError(RayTpuError):
    """The actor is dead: killed, retired by ``exit_actor``, its
    constructor raised, or its process died with no restart left."""


class OutOfMemoryError(RayTpuError):
    """A worker was killed to relieve host memory (the JAX package's
    memory monitor; the port has none yet)."""


class TaskCancelledError(RayTpuError):
    """The task or actor call was cancelled by :func:`cancel`."""


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The call's deadline (``deadline_s``) passed before it started."""


class ObjectLostError(RayTpuError):
    """An object's value is gone and cannot be made again."""


class DependencyError(RayTpuError):
    """A task's argument is an object whose task failed."""


class TaskError(RayTpuError):
    """An exception raised inside a task or an actor's method."""

    def __init__(self, label: str, cause: BaseException,
                 traceback_str: str = ""):
        super().__init__(f"task {label} failed: {cause!r}\n{traceback_str}")
        self.label = label
        self.cause = cause
        self.traceback_str = traceback_str

    def __reduce__(self):
        return TaskError, (self.label, self.cause, self.traceback_str)


# ------------------------------------------------------------ the runtime


class _Proc(procs.Worker):
    """A process of the core: a task worker or one incarnation of an
    actor. Its calls are pickled by the core's rules."""

    def __init__(self, context, target, args, name: str, card):
        super().__init__(context, target, args, name,
                         encode=serialization.dumps)
        self.card = card
        self.lock = threading.Lock()
        self.calls: Dict[int, "_Call"] = {}  # sent, not answered
        # Refs this process borrows: object id -> the times the driver
        # sent it, less those the process said it released.
        self.borrows: Dict[str, int] = {}

    def send(self, method, args=(), kwargs=None) -> int:
        with self.lock:
            return super().send(method, args, kwargs)

    def answer(self, rid: int, status: str, value: Any) -> None:
        """Answer the process's request ``rid``."""
        data = self.encode(("down", rid, status, value))
        with self.lock:
            try:
                self.conn.send_bytes(data)
            except OSError:
                pass  # gone: its sentinel reports the death


class _Call:
    """A task, an actor's method call or a control call, from submission
    to its answer."""

    __slots__ = ("kind", "label", "fn", "method", "args", "kwargs", "oids",
                 "num_returns", "key", "cpus", "card_ask", "seq", "proc",
                 "reply", "retries", "retry_exceptions", "blocked", "actor",
                 "wire", "deadline", "gen", "children", "cancelled", "done")

    def __init__(self, kind, label, args, kwargs, oids, num_returns):
        self.kind = kind  # "task" | "actor" | "control"
        self.label = label
        self.fn = None
        self.method = None
        self.args = args
        self.kwargs = kwargs
        self.oids = oids
        self.num_returns = num_returns
        self.key: Optional[int] = None
        self.cpus = 0.0
        self.card_ask = 0
        self.seq: Optional[int] = None
        self.proc: Optional[_Proc] = None
        self.reply: Optional[Tuple[str, Any]] = None
        self.retries = 0  # runs left after a worker death (max_retries)
        self.retry_exceptions = False
        self.blocked = 0  # its worker's gets and waits not yet answered
        self.actor: Optional["_Actor"] = None
        # What the call's process gets beside its arguments
        # (``core/worker.py``): task id, label, deadline, stream, trace.
        self.wire: Dict[str, Any] = {}
        self.deadline: Optional[float] = None  # time.time() of deadline_s
        self.gen: Optional["_Gen"] = None  # a streaming call's stream
        self.children: List["_Call"] = []  # what it submitted (cancel)
        self.cancelled = False
        self.done = False


class _Gen:
    """A streaming call's items on their way to the consumer (the JAX
    controller's generator state): each item an object the stream holds
    until its ref is handed out. The producer's report waits (``waiting``:
    its process and request) while more than ``window`` items are ahead of
    the consumer; children's ``next`` requests wait in ``nexts``."""

    __slots__ = ("gid", "items", "consumed", "released", "window", "done",
                 "error", "closed", "waiting", "nexts")

    def __init__(self, gid: str, window: int):
        self.gid = gid
        self.items: List[str] = []
        self.consumed = 0  # items handed to the consumer
        self.released = 0  # leading items whose hold the stream let go
        self.window = window
        self.done = False
        self.error: Optional[BaseException] = None
        self.closed = False
        self.waiting: Optional[Tuple["_Proc", int]] = None
        self.nexts: List[Tuple["_Proc", int, int]] = []


class _UpWait:
    """A child's ``get`` or ``wait`` that the driver answers once its
    objects are ready or its deadline passed."""

    __slots__ = ("proc", "rid", "oids", "num", "deadline", "kind", "call")

    def __init__(self, proc, rid, oids, num, deadline, kind, call):
        self.proc, self.rid, self.oids, self.num = proc, rid, oids, num
        self.deadline, self.kind, self.call = deadline, kind, call


# A request handler's value that says it answers later.
_LATER = object()


class _Actor:
    def __init__(self, actor_id: str, cls: type, payload: bytes,
                 opts: Dict[str, Any], methods: Dict[str, int]):
        self.actor_id = actor_id
        self.cls = cls
        self.payload = payload
        self.opts = opts
        self.methods = methods
        self.name = opts.get("name")
        self.max_restarts = int(opts.get("max_restarts") or 0)
        self.max_task_retries = int(opts.get("max_task_retries") or 0)
        self.restarts = 0
        self.incarnation = 0
        self.state = "starting"  # starting | alive | restarting | dead
        self.death: Optional[str] = None
        self.card: Optional[int] = None
        self.cpus = float(opts.get("num_cpus") or 0)
        self.proc: Optional[_Proc] = None
        self.pending: deque = deque()  # calls not sent yet, in order
        self.next_key = itertools.count()
        self.spawn_s: List[float] = []  # each incarnation's spawn-to-ready
        # Refs in the constructor's arguments: held while the actor can
        # restart, borrowed by each incarnation's process.
        self.payload_refs: List[str] = []


class _Runtime:
    def __init__(self, num_cpus: int, num_gpus: Optional[int]):
        self.num_cpus = num_cpus
        self._num_gpus = num_gpus
        self.cv = threading.Condition()
        self.objects: Dict[str, Tuple[str, Any]] = {}
        # Object id -> its holders: the driver's live refs to it, each
        # process that borrows it, each actor whose arguments carry it.
        # An object whose holders are gone is dropped.
        self.holds: Dict[str, int] = {}
        self.upwaits: List[_UpWait] = []  # children's gets and waits
        self.tasks: deque = deque()  # tasks not sent yet
        self.idle: Dict[Optional[int], List[_Proc]] = {}
        self.task_procs: List[_Proc] = []
        self.cpus_used = 0.0
        self.cards_used: set = set()
        self.actors: Dict[str, _Actor] = {}
        self.names: Dict[str, str] = {}
        # Object id (or stream id) -> the call that makes it, while a ref
        # to it lives: what cancel reaches, finished or not.
        self.producers: Dict[str, _Call] = {}
        self.gens: Dict[str, _Gen] = {}
        # Streams closed by their consumer in this process, handled by the
        # reader (a close may run in __del__, on any thread).
        self.closes: "queue.SimpleQueue[str]" = queue.SimpleQueue()
        self.node_id = NodeID.generate()
        self.spill_dir = tempfile.mkdtemp(prefix="rtpt-core-")
        self.forked = False
        self._stopped = False
        self._wake_r, self._wake_w = mpc.Pipe(duplex=False)
        self._reader = threading.Thread(target=self._loop,
                                        name="rtpt-core-reader", daemon=True)
        self._reader.start()

    # ------------------------------------------------------------- cards

    def num_gpus(self) -> int:
        if self._num_gpus is None:
            import torch

            self._num_gpus = (torch.cuda.device_count()
                              if torch.cuda.is_available() else 0)
        return self._num_gpus

    def _take_card(self, what: str) -> int:
        """A free card for ``what``; raises where there is none (before
        any spawn)."""
        n = self.num_gpus()
        if n == 0:
            raise RuntimeError(f"{what} asks num_gpus=1, but this host has "
                               "no CUDA card")
        free = [c for c in range(n) if c not in self.cards_used]
        if not free:
            raise RuntimeError(f"{what} asks num_gpus=1, but all {n} cards "
                               "are taken")
        self.cards_used.add(free[0])
        return free[0]

    # ----------------------------------------------------------- objects

    def new_ref(self) -> ObjectRef:
        return self.adopt(ObjectID.generate())

    def adopt(self, oid: str) -> ObjectRef:
        """A ref of the driver to ``oid``: a new one, or one that arrived
        from a child (``serialization._rebuild_ref``)."""
        ref = ObjectRef(oid)
        with self.cv:
            self._hold(oid)
        weakref.finalize(ref, self._unhold, oid)
        return ref

    def _hold(self, oid: str) -> None:
        self.holds[oid] = self.holds.get(oid, 0) + 1

    def _unhold(self, oid: str) -> None:
        with self.cv:
            left = self.holds.get(oid, 0) - 1
            if left > 0:
                self.holds[oid] = left
                return
            self.holds.pop(oid, None)
            self.objects.pop(oid, None)
            self.producers.pop(oid, None)

    def _borrow(self, p: _Proc, oids: Iterable[str]) -> None:
        """``p`` was sent these refs (called with ``cv`` held)."""
        for oid in oids:
            n = p.borrows.get(oid, 0)
            if n == 0:
                self._hold(oid)
            p.borrows[oid] = n + 1

    def _give_back(self, p: _Proc, counts: Dict[str, int]) -> None:
        """``p`` dropped its last copy of these refs, received ``n`` times
        each; ``counts`` None: all of them (its process ended)."""
        for oid, n in (dict(p.borrows) if counts is None
                       else counts).items():
            left = p.borrows.get(oid, 0) - n
            if left > 0:
                p.borrows[oid] = left
            elif oid in p.borrows:
                del p.borrows[oid]
                self._unhold(oid)

    def _post(self, p: _Proc, send: Callable[[], Any]) -> Any:
        """``send()`` a message to ``p``; the refs it carried become
        ``p``'s borrows once it is sent (called with ``cv`` held)."""
        with serialization.capture() as refs:
            out = send()
        self._borrow(p, refs)
        return out

    def _settle(self, oid: str, status: str, value: Any) -> None:
        if oid in self.holds:  # else its refs are gone: drop the value
            self.objects[oid] = status, value
            if self.upwaits:
                self._wake()

    def _settle_all(self, call: _Call, status: str, value: Any) -> None:
        for oid in call.oids:
            self._settle(oid, status, value)

    def _settle_value(self, call: _Call, value: Any) -> None:
        if call.num_returns == 1:
            self._settle(call.oids[0], "ok", value)
            return
        try:
            values = tuple(value)
            if len(values) != call.num_returns:
                raise ValueError(f"returned {len(values)} values")
        except (TypeError, ValueError) as e:
            err = TaskError(call.label, ValueError(
                f"num_returns={call.num_returns}, but the call {e}"))
            self._settle_all(call, "err", err)
            return
        for oid, v in zip(call.oids, values):
            self._settle(oid, "ok", v)

    def put(self, value: Any) -> ObjectRef:
        bufs: list = []
        data = serialization.dumps(value, bufs)
        return self._store(serialization.loads(data,
                                               [b.raw() for b in bufs]))

    def _store(self, value: Any) -> ObjectRef:
        """A new object holding ``value`` itself."""
        with self.cv:
            ref = self.new_ref()
            self._settle(ref.object_id, "ok", value)
        return ref

    def get_objects(self, oids: Sequence[str], timeout: Optional[float]
                    ) -> List[Tuple[str, Any]]:
        """Each object's ``(status, value)``, waiting up to ``timeout``."""
        n = len(set(oids))
        done = self.wait_objects(oids, n, timeout)
        if len(done) < n:
            raise GetTimeoutError(f"{n - len(done)} of {n} objects not "
                                  f"ready within {timeout} s")
        with self.cv:
            return [self.objects[o] for o in oids]

    def wait_objects(self, oids: Sequence[str], num: int,
                     timeout: Optional[float]) -> List[str]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cv:
            while True:
                done = [o for o in oids if o in self.objects]
                if len(done) >= num:
                    return done
                left = None if deadline is None else (
                    deadline - time.monotonic())
                if left is not None and left <= 0:
                    return done
                self.cv.wait(0.5 if left is None else min(0.5, left))

    # ------------------------------------------------------------- tasks

    def submit_task(self, fn: Callable, label: str, args, kwargs,
                    opts: Dict[str, Any], parent: Optional[_Call] = None
                    ) -> Union[List[ObjectRef], "ObjectRefGenerator"]:
        with self.cv:
            call = _Call("task", label, args, kwargs, [], 1)
            call.fn = fn
            call.cpus = float(opts.get("num_cpus", 1) or 0)
            call.card_ask = int(opts.get("num_gpus", 0) or 0)
            call.retries = int(opts.get("max_retries", 0) or 0)
            call.retry_exceptions = bool(opts.get("retry_exceptions"))
            if call.cpus > self.num_cpus:
                raise ValueError(f"{label} asks num_cpus={call.cpus}, more "
                                 f"than the {self.num_cpus} of this core")
            out = self._outputs(call, opts, parent)
            self.tasks.append(call)
            self._dispatch()
        return out

    def _outputs(self, call: _Call, opts: Dict[str, Any],
                 parent: Optional[_Call]
                 ) -> Union[List[ObjectRef], "ObjectRefGenerator"]:
        """The call's refs, or its stream; its wire, deadline and parent
        (called with ``cv`` held)."""
        call.wire = {"task_id": TaskID.generate(), "label": call.label}
        if opts.get("_trace"):
            call.wire["trace_ctx"] = opts["_trace"]
        if opts.get("deadline_s") is not None:
            call.deadline = time.time() + float(opts["deadline_s"])
            call.wire["deadline"] = call.deadline
        if parent is not None:
            parent.children.append(call)
        if opts.get("num_returns", 1) == "streaming":
            gid = ObjectID.generate()
            call.num_returns = 0
            call.gen = _Gen(gid, int(
                opts.get("_generator_backpressure_num_objects")
                or BACKPRESSURE_DEFAULT))
            call.wire["stream"] = gid
            self.gens[gid] = call.gen
            self.producers[gid] = call
            return ObjectRefGenerator(gid)
        call.num_returns = int(opts.get("num_returns", 1))
        refs = [self.new_ref() for _ in range(call.num_returns)]
        call.oids = [r.object_id for r in refs]
        for oid in call.oids:
            self.producers[oid] = call
        return refs

    def _deps_state(self, call: _Call) -> Optional[Tuple[str, Any]]:
        """None while a top-level ref argument is pending, ("err", e) for a
        failed one (a task's ``DependencyError``, an actor call's
        ``TaskError`` around the upstream error, as the JAX package
        raises), else ("ok", None)."""
        for v in itertools.chain(call.args, call.kwargs.values()):
            if isinstance(v, ObjectRef):
                got = self.objects.get(v.object_id)
                if got is None:
                    return None
                if got[0] == "err":
                    if call.kind == "task":
                        return "err", DependencyError(
                            f"upstream task failed for object "
                            f"{v.object_id[:8]}")
                    return "err", TaskError(call.label, got[1])
        return ("ok", None)

    def _resolved(self, call: _Call) -> Tuple[Tuple, Dict[str, Any]]:
        def value(v):
            return (self.objects[v.object_id][1]
                    if isinstance(v, ObjectRef) else v)

        n = itertools.count()
        args = tuple(serialization.spill_if_large(
            os.path.join(self.spill_dir, f"arg-{id(call)}-{next(n)}"),
            value(a)) for a in call.args)
        return args, {k: value(v) for k, v in call.kwargs.items()}

    def _task_proc(self, card: Optional[int]) -> _Proc:
        idle = self.idle.get(card)
        if idle:
            return idle.pop()
        p = _Proc(multiprocessing.get_context("spawn"),
                  core_worker._task_main,
                  (card, self.spill_dir, dict(os.environ), self.node_id),
                  f"rtpt-task-{len(self.task_procs)}", card)
        self.task_procs.append(p)
        self._wake()
        return p

    def _dispatch(self) -> None:
        """Send every task and actor call whose arguments are ready and
        whose resources are free (called with ``cv`` held)."""
        for call in list(self.tasks):
            if _expired(call):
                self.tasks.remove(call)
                self._finish(call, "err", _deadline_error(call))
                continue
            deps = self._deps_state(call)
            if deps is None:
                continue
            if deps[0] == "err":
                self.tasks.remove(call)
                self._finish(call, "err", deps[1])
                continue
            if self.cpus_used + call.cpus > self.num_cpus:
                continue
            card = None
            if call.card_ask:
                if len(self.cards_used) >= self.num_gpus():
                    continue
                card = self._take_card(call.label)
            self.tasks.remove(call)
            self.cpus_used += call.cpus
            p = self._task_proc(card)
            self._send(p, call, "run", (call.fn, call.wire))
        for actor in self.actors.values():
            self._dispatch_actor(actor)
        self.cv.notify_all()

    def _send(self, p: _Proc, call: _Call, method: str, head: Tuple) -> None:
        def send():
            args, kwargs = self._resolved(call)
            return p.send(method, head + args, kwargs)

        try:
            call.proc = p
            call.seq = self._post(p, send)
        except Exception as e:  # noqa: BLE001 — the call's error
            self._finish(call, "err", TaskError(call.label, e))
            return
        p.calls[call.seq] = call

    # ------------------------------------------------------------ actors

    def create_actor(self, wrapper: Any, args, kwargs, opts: Dict[str, Any],
                     methods: Dict[str, int]) -> str:
        """Start an actor of ``wrapper`` (an ``ActorClass``, sent by name)
        or of a plain class; returns its id."""
        cls = getattr(wrapper, "__rtpu_target__", wrapper)
        label = f"actor {cls.__qualname__}"
        gpus = int(opts.get("num_gpus", 0) or 0)
        if gpus not in (0, 1):
            raise ValueError(f"{label}: num_gpus={gpus}; an actor takes 0 "
                             "or 1 card")
        _check_sendable(list(args) + list(kwargs.values()), label)
        with serialization.capture() as refs:
            payload = core_worker.actor_payload(wrapper, args, kwargs,
                                                where="actor's process")
        actor_id = ActorID.generate()
        a = _Actor(actor_id, cls, payload, opts, methods)
        a.payload_refs = refs
        with self.cv:
            if a.name is not None and a.name in self.names:
                raise ValueError(f"an actor named {a.name!r} exists")
            if self.cpus_used + a.cpus > self.num_cpus:
                raise RuntimeError(
                    f"{label} asks num_cpus={a.cpus}: "
                    f"{self.num_cpus - self.cpus_used} of this core's "
                    f"{self.num_cpus} are free (an actor holds its CPUs "
                    "for its life)")
            if gpus:
                a.card = self._take_card(label)
            self.cpus_used += a.cpus
            for oid in set(refs):
                self._hold(oid)
            self.actors[actor_id] = a
            if a.name is not None:
                self.names[a.name] = actor_id
            self._spawn_actor(a, restore=False)
        return actor_id

    def _spawn_actor(self, a: _Actor, restore: bool) -> None:
        preload = a.opts.get("_preload")
        if preload:
            context = core_worker.fork_context(preload)
            self.forked = True
        else:
            context = multiprocessing.get_context("spawn")
        opts = {k: a.opts.get(k) for k in (
            "max_task_retries", "checkpoint_every_n",
            "checkpoint_interval_s", "max_concurrency")}
        opts["wire"] = {"label": f"{a.cls.__qualname__}.__init__",
                        "actor_id": a.actor_id}
        if a.opts.get("_trace"):
            opts["wire"]["trace_ctx"] = a.opts["_trace"]
        a.incarnation += 1
        a.proc = _Proc(context, core_worker._core_actor_main,
                       (a.payload, a.actor_id, a.card, opts, restore,
                        self.spill_dir, dict(os.environ), self.node_id),
                       f"rtpt-actor-{a.cls.__name__}-{a.actor_id[:8]}",
                       a.card)
        self._borrow(a.proc, a.payload_refs)
        a.state = "starting"
        self._wake()

    def submit_call(self, actor_id: str, method: str, args, kwargs,
                    opts: Dict[str, Any], parent: Optional[_Call] = None
                    ) -> Union[List[ObjectRef], "ObjectRefGenerator"]:
        with self.cv:
            a = self.actors[actor_id]
            label = f"{a.cls.__qualname__}.{method}"
            call = _Call("actor", label, args, kwargs, [], 1)
            call.method = method
            call.actor = a
            call.key = next(a.next_key)
            out = self._outputs(call, opts, parent)
            call.wire["actor_id"] = actor_id
            if a.state == "dead":
                self._finish(call, "err", self._died(a))
                return out
            a.pending.append(call)
            self._dispatch_actor(a)
            self.cv.notify_all()
        return out

    def _died(self, a: _Actor) -> ActorDiedError:
        return ActorDiedError(f"actor {a.cls.__qualname__} "
                              f"({a.actor_id[:8]}) is dead: {a.death}")

    def _dispatch_actor(self, a: _Actor) -> None:
        if a.state not in ("starting", "alive"):
            return
        while a.pending:
            call = a.pending[0]
            if _expired(call):
                a.pending.popleft()
                self._finish(call, "err", _deadline_error(call))
                continue
            deps = self._deps_state(call)
            if deps is None:
                return
            a.pending.popleft()
            if deps[0] == "err":
                self._finish(call, "err", deps[1])
                continue
            self._send(a.proc, call, "call", (call.method, call.key,
                                              call.wire))

    def control(self, actor_id: str, method: str, *args,
                timeout: Optional[float] = 30.0) -> Any:
        """``method(*args)`` of an actor's host (``core/worker.py``
        ``ActorHost``), past the actor's call queue, waited for."""
        return self.control_wait(self.control_send(actor_id, method, *args),
                                 timeout)

    def control_send(self, actor_id: str, method: str, *args) -> _Call:
        with self.cv:
            a = self.actors[actor_id]
            call = _Call("control", f"{a.cls.__qualname__} {method}", args,
                         {}, [], 1)
            if a.state in ("starting", "alive"):
                p = call.proc = a.proc
                call.seq = self._post(p, lambda: p.send(method, args))
                p.calls[call.seq] = call
            else:
                call.reply = ("err", f"the actor is {a.state}")
        return call

    def control_wait(self, call: _Call, timeout: Optional[float]) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cv:
            while call.reply is None:
                left = None if deadline is None else (
                    deadline - time.monotonic())
                if left is not None and left <= 0:
                    if call.proc is not None:
                        call.proc.calls.pop(call.seq, None)
                    raise GetTimeoutError(f"{call.label}: no answer in "
                                          f"{timeout} s")
                self.cv.wait(0.5 if left is None else min(0.5, left))
        status, value = call.reply
        if status != "ok":
            raise RuntimeError(f"{call.label} failed: {value}")
        return value

    def actor_info(self, actor_id: str) -> Dict[str, Any]:
        with self.cv:
            a = self.actors[actor_id]
            p = a.proc
            return {"state": a.state, "death": a.death,
                    "restarts": a.restarts, "incarnation": a.incarnation,
                    "pid": None if p is None else p.pid,
                    "ready": p is not None and p.ready is not None,
                    "spawn_s": list(a.spawn_s), "card": a.card,
                    "max_restarts": a.max_restarts}

    def wait_actor(self, actor_id: str, pred: Callable[[Dict[str, Any]],
                   bool], timeout: float) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout
        while True:
            info = self.actor_info(actor_id)
            if pred(info) or time.monotonic() > deadline:
                return info
            with self.cv:
                self.cv.wait(0.05)

    def kill(self, actor_id: str, wait: bool = True) -> None:
        """Kill the actor's process; with ``wait``, until the reader has
        reaped it (the reader itself kills without waiting)."""
        with self.cv:
            a = self.actors.get(actor_id)
            if a is None or a.state == "dead":
                return
            a.state, a.death = "dead", "killed"
            self._retire(a)
            p = a.proc
            if p is None:
                self._fail_actor_calls(a)
                return
            p.proc.kill()
            if not wait:
                return
            # The reader reaps the process and fails its calls.
            deadline = time.monotonic() + _STOP_S
            while a.proc is p and time.monotonic() < deadline:
                self.cv.wait(0.05)

    def _fail_actor_calls(self, a: _Actor, sent: Iterable[_Call] = ()
                          ) -> None:
        err = self._died(a)
        for call in list(sent) + list(a.pending):
            self._finish(call, "err", err)
        a.pending.clear()

    def _retire(self, a: _Actor) -> None:
        """Free a dead actor's name, card and CPUs (once)."""
        if a.name is not None and self.names.get(a.name) == a.actor_id:
            del self.names[a.name]
        if a.card is not None:
            self.cards_used.discard(a.card)
            a.card = None
        self.cpus_used -= a.cpus
        a.cpus = 0.0
        refs, a.payload_refs = a.payload_refs, []
        for oid in set(refs):
            self._unhold(oid)

    # ------------------------------------------------------ the reader

    def _wake(self) -> None:
        try:
            self._wake_w.send_bytes(b"")
        except OSError:
            pass

    def _live(self) -> List[_Proc]:
        out = list(self.task_procs)
        out += [a.proc for a in self.actors.values() if a.proc is not None]
        return out

    def _loop(self) -> None:
        while not self._stopped:
            with self.cv:
                live = self._live()
                deadlines = [w.deadline for w in self.upwaits
                             if w.deadline is not None]
            by_conn = {p.conn: p for p in live}
            by_sentinel = {p.proc.sentinel: p for p in live}
            timeout = 1.0
            if deadlines:
                timeout = min(timeout, max(0.0, min(deadlines)
                                           - time.monotonic()))
            try:
                ready = mpc.wait([self._wake_r] + list(by_conn)
                                 + list(by_sentinel), timeout)
            except OSError:
                continue  # a process went away while we listed it
            if self._wake_r in ready:
                while self._wake_r.poll():
                    self._wake_r.recv_bytes()
            closes = []
            while not self.closes.empty():
                closes.append(self.closes.get_nowait())
            got: List[Tuple[_Proc, Tuple]] = []
            for o in ready:
                if o in by_conn:
                    got += self._read_all(by_conn[o])
            dead = [by_sentinel[o] for o in ready if o in by_sentinel]
            for p in dead:
                got += self._read_all(p)
            with self.cv:
                for gid in closes:
                    self.gen_close(gid)
                for p, reply in got:
                    if reply[0] == "up":
                        self._on_request(p, *reply[1:])
                    else:
                        self._on_reply(p, *reply)
                for p in dead:
                    self._on_death(p)
                self._dispatch()
                self._serve_waits()

    def _read_all(self, p: _Proc) -> List[Tuple[_Proc, Tuple]]:
        out = []
        while True:
            reply = p.read()
            if reply is None:
                return out
            if reply[0] == "up":  # a request of the process
                out.append((p, reply))
                continue
            seq, status, value = reply
            if isinstance(value, procs.Spilled):
                try:
                    value = value.load()
                except Exception as e:  # noqa: BLE001 — the call's error
                    status, value = "err", repr(e)
            out.append((p, (seq, status, value)))

    def _actor_of(self, p: _Proc) -> Optional[_Actor]:
        for a in self.actors.values():
            if a.proc is p:
                return a
        return None

    def _on_reply(self, p: _Proc, seq: int, status: str, value: Any) -> None:
        if seq == 0:
            if status == "err":
                p.ready_error = value
            else:
                p.ready = value
                a = self._actor_of(p)
                if a is not None and a.state == "starting":
                    a.state = "alive"
                    a.spawn_s.append(value["t_ready"] - p.t_start)
            return
        call = p.calls.pop(seq, None)
        if call is None:
            return
        if call.kind == "task":
            self._free_task(p, call)
            self.idle.setdefault(p.card, []).append(p)
            if (isinstance(value, core_worker.Raised)
                    and call.retry_exceptions and call.retries > 0):
                self._retry(call)
                return
        self._finish(call, status, value)

    def _free_task(self, p: _Proc, call: _Call) -> None:
        """The CPUs and the card a task held (its CPUs only where it did
        not give them back while blocked)."""
        if not call.blocked:
            self.cpus_used -= call.cpus
        call.blocked = 0
        if p.card is not None:
            self.cards_used.discard(p.card)

    def _retry(self, call: _Call) -> None:
        """Run a task again, first of the queue (``max_retries``)."""
        call.retries -= 1
        call.proc = call.seq = None
        self.tasks.appendleft(call)

    # -------------------------------------------------- children's requests

    def _on_request(self, p: _Proc, rid: int, op: str, args: Tuple,
                    kwargs: Dict[str, Any]) -> None:
        """A request of a task worker or an actor process (``_Client``),
        answered on its pipe now or, for a ``get`` or ``wait`` not yet
        ready, by :meth:`_serve_waits`. ``rid`` 0 wants no answer."""
        try:
            out = getattr(self, f"_up_{op}")(p, rid, *args, **kwargs)
        except Exception as e:  # noqa: BLE001 — the request's error
            out = _LATER
            if rid:
                self._answer(p, rid, "err", _portable(e))
        if out is not _LATER and rid:
            self._answer(p, rid, "ok", out)

    def _answer(self, p: _Proc, rid: int, status: str, value: Any) -> None:
        def send():
            v = value
            if status == "ok":  # a large value goes as a file
                v = serialization.spill_if_large(
                    os.path.join(self.spill_dir, f"up-{p.pid}-{rid}"), v)
            p.answer(rid, status, v)

        try:
            self._post(p, send)
        except Exception as e:  # noqa: BLE001 — a value that cannot travel
            p.answer(rid, "err", _portable(e))

    def _up_submit_task(self, p, rid, fn, label, args, kwargs, opts):
        parent = p.calls.get(opts.pop("_parent", None))
        return self.submit_task(fn, label, args, kwargs, opts, parent)

    def _up_submit_call(self, p, rid, actor_id, method, args, kwargs,
                        opts):
        parent = p.calls.get(opts.pop("_parent", None))
        return self.submit_call(actor_id, method, args, kwargs, opts,
                                parent)

    def _up_cancel(self, p, rid, key, force, recursive):
        self.cancel(key, force, recursive)

    def _up_gen_item(self, p, rid, gid, value):
        """A streaming call's next item (``core/worker.py`` ``_stream``):
        stored as an object the stream holds; the answer, ``ok`` or
        ``closed``, waits while the consumer lags past the window."""
        gen = self.gens.get(gid)
        if gen is None or gen.closed:
            return "closed"
        if isinstance(value, procs.Spilled):
            value = value.load()
        oid = ObjectID.generate()
        self._hold(oid)
        self._settle(oid, "ok", value)
        gen.items.append(oid)
        self._serve_gen_nexts(gen)
        self.cv.notify_all()
        if len(gen.items) - gen.consumed > gen.window:
            gen.waiting = (p, rid)
            return _LATER
        return "ok"

    def _up_gen_next(self, p, rid, gid, index):
        gen = self.gens.get(gid)
        if gen is None:
            return "done", None
        got = self._gen_take(gen, index, p)
        if got is None:
            gen.nexts.append((p, rid, index))
            return _LATER
        return got

    def _up_gen_close(self, p, rid, gid):
        self.gen_close(gid)

    def _up_free(self, p, rid, oids):
        self.free(oids)

    def _up_error_of(self, p, rid, oid):
        return self.error_of(oid)

    def _up_available_resources(self, p, rid):
        return self.available_resources()

    def _up_nodes(self, p, rid):
        return self.nodes()

    def _up_create_actor(self, p, rid, wrapper, args, kwargs, opts,
                         methods):
        return self.create_actor(wrapper, args, kwargs, opts, methods)

    def _up_put(self, p, rid, value):
        if isinstance(value, procs.Spilled):
            value = value.load()
        return self._store(value)  # a copy already: it crossed a pipe

    def _up_get(self, p, rid, oids, timeout):
        return self._up_wait(p, rid, oids, len(set(oids)), timeout, "get")

    def _up_wait(self, p, rid, oids, num, timeout, kind="wait"):
        deadline = None if timeout is None else time.monotonic() + timeout
        call = None
        if p in self.task_procs:
            call = next((c for c in p.calls.values() if c.kind == "task"),
                        None)
        w = _UpWait(p, rid, list(oids), num, deadline, kind, call)
        if self._try_answer(w):
            return _LATER
        if call is not None:  # the task gives its CPUs back while it waits
            if not call.blocked:
                self.cpus_used -= call.cpus
            call.blocked += 1
        self.upwaits.append(w)
        return _LATER

    def _try_answer(self, w: _UpWait) -> bool:
        done = {o for o in w.oids if o in self.objects}
        late = w.deadline is not None and time.monotonic() >= w.deadline
        if len(done) < w.num and not late:
            return False
        if w.kind == "wait":
            self._answer(w.proc, w.rid, "ok", [o for o in w.oids
                                               if o in done])
        elif len(done) < w.num:
            self._answer(w.proc, w.rid, "err", GetTimeoutError(
                f"{w.num - len(done)} of {w.num} objects not ready "
                f"within the timeout"))
        else:
            self._answer(w.proc, w.rid, "ok",
                         [self.objects[o] for o in w.oids])
        return True

    def _serve_waits(self) -> None:
        """Answer the children's gets and waits that are ready or late
        (called with ``cv`` held)."""
        for w in list(self.upwaits):
            if self._try_answer(w):
                self.upwaits.remove(w)
                self._unblock(w)

    def _unblock(self, w: _UpWait) -> None:
        call = w.call
        if call is None or not call.blocked:
            return
        call.blocked -= 1
        if not call.blocked:
            self.cpus_used += call.cpus

    def _up_get_actor(self, p, rid, name):
        aid = self.names.get(name)
        if aid is None:
            raise ValueError(f"no live actor named {name!r}")
        return aid, self.actors[aid].methods

    def _up_kill(self, p, rid, actor_id):
        self.kill(actor_id, wait=False)

    def _up_release(self, p, rid, counts):
        self._give_back(p, counts)

    def _up_cluster_resources(self, p, rid):
        return self.cluster_resources()

    # ------------------------------------------------ objects and the node

    def free(self, oids: Iterable[str]) -> None:
        """Drop the values of ``oids``: a later ``get`` waits for a value
        that will not come (``GetTimeoutError`` past its timeout)."""
        with self.cv:
            for oid in oids:
                self.objects.pop(oid, None)

    def error_of(self, oid: str) -> Optional[BaseException]:
        """The error a ready object holds, None for a value, read from
        the table without moving the value."""
        with self.cv:
            got = self.objects.get(oid)
        if got is None:
            raise GetTimeoutError(f"object {oid[:8]} is not ready")
        return got[1] if got[0] == "err" else None

    def cluster_resources(self) -> Dict[str, float]:
        return {"CPU": float(self.num_cpus), "GPU": float(self.num_gpus())}

    def available_resources(self) -> Dict[str, float]:
        """CPU and GPU less what tasks and actors hold now."""
        with self.cv:
            return {"CPU": float(self.num_cpus) - self.cpus_used,
                    "GPU": float(self.num_gpus() - len(self.cards_used))}

    def nodes(self) -> List[Dict[str, Any]]:
        """The one node, with the keys of the JAX package's node entries
        (``tpu_free`` lists the free cards)."""
        with self.cv:
            n = self.num_gpus()
            free = [c for c in range(n) if c not in self.cards_used]
            workers = len(self._live())
        spill = [os.path.join(self.spill_dir, f)
                 for f in os.listdir(self.spill_dir)]
        return [{"node_id": self.node_id,
                 "resources": self.cluster_resources(),
                 "available": self.available_resources(),
                 "labels": {}, "alive": True, "state": "alive",
                 "drain_reason": None, "index": 0, "num_workers": workers,
                 "mem_fraction": _mem_fraction(),
                 "cpu_percent": None, "tpu_free": free, "proc_stats": {},
                 "arena": {},
                 "spill": {"files": len(spill), "bytes": sum(
                     os.path.getsize(f) for f in spill
                     if os.path.isfile(f))},
                 "channels": {}}]

    def _finish(self, call: _Call, status: str, value: Any) -> None:
        if call.kind == "control":
            call.reply = (status, value)
            return
        if call.done:
            return  # answered already (a cancel raced its end)
        err = None
        if status == "err":
            err = value if isinstance(value, BaseException) else TaskError(
                call.label, RuntimeError(str(value)), str(value))
        elif isinstance(value, core_worker.Refused):
            err = value.exc
        elif isinstance(value, core_worker.Raised):
            err = (value.exc if call.cancelled and isinstance(
                value.exc, TaskCancelledError)
                else TaskError(call.label, value.exc, value.tb))
        elif isinstance(value, core_worker.Exited):
            a = self._actor_of(call.proc) if call.proc else None
            if value.retired or a is None:
                err = ActorDiedError(f"{call.label}: the actor exited")
            else:
                value = (None if call.num_returns == 1
                         else (None,) * call.num_returns)
                self._exit_actor(a)
        call.done = True
        # What only a retry needed; its children and stream stay.
        call.fn = call.args = call.kwargs = None
        if call.gen is not None:
            self._gen_end(call.gen, err)
        elif err is not None:
            self._settle_all(call, "err", err)
        else:
            self._settle_value(call, value)

    def _exit_actor(self, a: _Actor) -> None:
        """The actor called exit_actor(): dead for good, its process asked
        to leave, the calls behind it failed."""
        if a.state == "dead":
            return
        a.state, a.death = "dead", "exited by exit_actor()"
        self._retire(a)
        p = a.proc
        try:
            p.conn.send_bytes(serialization.dumps(None))
        except OSError:
            pass
        self._fail_actor_calls(a, list(p.calls.values()))
        p.calls.clear()

    def _on_death(self, p: _Proc) -> None:
        p.proc.join(1.0)
        sent = sorted(p.calls.values(), key=lambda c: c.seq)
        p.calls.clear()
        self.upwaits = [w for w in self.upwaits if w.proc is not p]
        for gen in self.gens.values():
            gen.nexts = [n for n in gen.nexts if n[0] is not p]
            if gen.waiting is not None and gen.waiting[0] is p:
                gen.waiting = None
        self._give_back(p, None)
        try:
            self._on_death_of(p, sent)
        finally:
            p.conn.close()
            p.proc.close()

    def _on_death_of(self, p: _Proc, sent: List[_Call]) -> None:
        if p in self.task_procs:
            self.task_procs.remove(p)
            for procs_ in self.idle.values():
                if p in procs_:
                    procs_.remove(p)
            for call in sent:
                self._free_task(p, call)
                if call.cancelled:  # cancel(force=True) stopped it
                    self._finish(call, "err", TaskCancelledError(
                        f"{call.label} was cancelled with force=True: its "
                        f"task worker was stopped"))
                    continue
                if call.retries > 0:
                    self._retry(call)
                    continue
                self._finish(call, "err", WorkerCrashedError(
                    f"{call.label}: the task worker died (exit code "
                    f"{p.proc.exitcode})"))
            return
        a = self._actor_of(p)
        if a is None:
            return
        a.proc = None
        controls = [c for c in sent if c.kind == "control"]
        calls = [c for c in sent if c.kind != "control"]
        for c in controls:
            self._finish(c, "err", "the actor's process died")
        if a.state == "dead":
            self._retire(a)
            self._fail_actor_calls(a, calls)
            return
        if p.ready_error is not None:
            a.state, a.death = "dead", (
                f"its constructor raised:\n{p.ready_error}")
        elif a.max_restarts < 0 or a.restarts < a.max_restarts:
            a.restarts += 1
            if a.max_task_retries != 0:
                a.pending.extendleft(reversed(calls))
                calls = []
            else:
                err = ActorDiedError(
                    f"actor {a.cls.__qualname__} ({a.actor_id[:8]}) died "
                    f"with the call unanswered (exit code "
                    f"{p.proc.exitcode}); max_task_retries=0")
                for c in calls:
                    self._finish(c, "err", err)
                calls = []
            a.state = "restarting"
            self._spawn_actor(a, restore=True)
            return
        else:
            a.state, a.death = "dead", (
                f"its process died (exit code {p.proc.exitcode}) and "
                f"{a.restarts} of max_restarts={a.max_restarts} restarts "
                "were used")
        self._retire(a)
        self._fail_actor_calls(a, calls)

    # ------------------------------------------------------------ cancel

    def cancel(self, key: str, force: bool, recursive: bool) -> None:
        """Cancel the call that makes the object (or the stream) ``key``
        and, with ``recursive``, every call it submitted, down the tree;
        a finished call, or one cancelled already, is passed over."""
        with self.cv:
            call = self.producers.get(key)
            seen: set = set()
            todo = [call] if call is not None else []
            while todo:
                c = todo.pop()
                if id(c) in seen:
                    continue
                seen.add(id(c))
                self._cancel_one(c, force)
                if recursive:
                    todo.extend(c.children)
            self._dispatch()

    def _cancel_one(self, call: _Call, force: bool) -> None:
        if call.done or call.cancelled:
            return
        call.cancelled = True
        call.retries = 0  # a cancel must not bring it back
        call.retry_exceptions = False
        queued = (call in self.tasks if call.kind == "task"
                  else call.actor is not None and call in call.actor.pending)
        if queued:
            (self.tasks if call.kind == "task"
             else call.actor.pending).remove(call)
            what = "task" if call.kind == "task" else "actor call"
            self._finish(call, "err", TaskCancelledError(
                f"{what} {call.wire['task_id'][:8]} was cancelled before "
                f"it started"))
            return
        p = call.proc
        if p is None or p.calls.get(call.seq) is not call:
            return
        if force and call.kind == "task":
            p.proc.kill()  # the reader reaps it and fails the call
            return
        # Its process answers one that waits there at once, or raises the
        # error in the thread that runs it (core/worker.py CALLS).
        data = p.encode(("cancel", call.seq))
        with p.lock:
            try:
                p.conn.send_bytes(data)
            except OSError:
                pass  # gone: its sentinel reports the death

    # ----------------------------------------------------------- streams

    def _gen_take(self, gen: _Gen, index: int, proc: Optional[_Proc]
                  ) -> Optional[Tuple[str, Any]]:
        """Item ``index`` of the stream for its consumer (``proc`` where it
        is a child): ("item", ref), ("done", None), ("err", error), or None
        while the item is not there yet (called with ``cv`` held)."""
        if index < len(gen.items):
            ref = self.adopt(gen.items[index])
            gen.consumed = max(gen.consumed, index + 1)
            while gen.released < gen.consumed:
                self._unhold(gen.items[gen.released])
                gen.released += 1
            if gen.waiting is not None and (
                    len(gen.items) - gen.consumed <= gen.window):
                (p, rid), gen.waiting = gen.waiting, None
                self._answer(p, rid, "ok", "ok")
            return "item", ref
        if not gen.done:
            return None
        self._gen_drop(gen)
        if gen.error is not None:
            return "err", gen.error
        return "done", None

    def gen_next(self, gid: str, index: int) -> Tuple[str, Any]:
        """The driver's own consumer: waits for item ``index``."""
        with self.cv:
            while True:
                gen = self.gens.get(gid)
                if gen is None:
                    return "done", None
                got = self._gen_take(gen, index, None)
                if got is not None:
                    return got
                self.cv.wait(0.5)

    def _gen_end(self, gen: _Gen, err: Optional[BaseException]) -> None:
        """The producer's call ended (with ``err`` where it failed)."""
        gen.done = True
        gen.error = err
        self._serve_gen_nexts(gen)
        if gen.closed:
            self._gen_drop(gen)
        self.cv.notify_all()

    def _serve_gen_nexts(self, gen: _Gen) -> None:
        for n in list(gen.nexts):
            got = self._gen_take(gen, n[2], n[0])
            if got is None:
                continue
            gen.nexts.remove(n)
            self._answer(n[0], n[1], "ok", got)

    def gen_close(self, gid: str) -> None:
        """The consumer let the stream go: the producer's waiting report
        and its next one answer ``closed``; the items not handed out go
        (called with ``cv`` held)."""
        gen = self.gens.get(gid)
        if gen is None:
            return
        gen.closed = True
        if gen.waiting is not None:
            (p, rid), gen.waiting = gen.waiting, None
            self._answer(p, rid, "ok", "closed")
        self._gen_drop(gen)

    def _gen_drop(self, gen: _Gen) -> None:
        if self.gens.pop(gen.gid, None) is None:
            return
        self.producers.pop(gen.gid, None)
        for oid in gen.items[gen.released:]:
            self._unhold(oid)
        gen.released = len(gen.items)

    # ---------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        from ..dag import compiled_dag

        compiled_dag.teardown_all()
        with self.cv:
            self._stopped = True
            for a in self.actors.values():
                if a.state != "dead":
                    a.state, a.death = "dead", "the core shut down"
                    self._fail_actor_calls(a, list(a.proc.calls.values())
                                           if a.proc else [])
            for call in self.tasks:
                self._finish(call, "err",
                             RayTpuError("the core shut down"))
            self.tasks.clear()
            self.cv.notify_all()
        self._wake()
        self._reader.join(5.0)
        with self.cv:
            every = self._live()  # the reader may have reaped some meanwhile
        procs.stop(every)
        if self.forked:
            procs.stop_fork_server()
        shutil.rmtree(self.spill_dir, ignore_errors=True)
        self._wake_r.close()
        self._wake_w.close()


def _expired(call: _Call) -> bool:
    return call.deadline is not None and time.time() > call.deadline


def _deadline_error(call: _Call) -> DeadlineExceededError:
    return DeadlineExceededError(
        f"{call.label}: its deadline passed "
        f"{time.time() - call.deadline:.3f} s before it started")


def _mem_fraction() -> Optional[float]:
    """The host memory in use, as a fraction (``/proc/meminfo``)."""
    try:
        with open("/proc/meminfo") as f:
            kb = {line.split(":")[0]: int(line.split()[1]) for line in f}
        return 1.0 - kb["MemAvailable"] / kb["MemTotal"]
    except (OSError, KeyError, ValueError, IndexError):
        return None


def _portable(e: BaseException) -> BaseException:
    """``e`` where it pickles, else a RuntimeError naming it."""
    try:
        pickle.loads(serialization.dumps(e))
        return e
    except Exception:  # noqa: BLE001 — an exception that cannot travel
        return RuntimeError(f"{type(e).__name__}: {e}")


def _check_sendable(values: Sequence[Any], label: str) -> None:
    """Raise here, in the caller, for an argument that cannot travel
    (top-level refs are the arguments' dependencies and are resolved in
    the driver)."""
    for v in values:
        if isinstance(v, ObjectRef):
            continue
        try:
            serialization.dumps(v)
        except TypeError as e:
            raise TypeError(f"{label}: {e}") from e
        except Exception as e:  # noqa: BLE001 — pickling's own errors
            raise TypeError(
                f"{label}: argument {v!r} cannot be sent to another "
                f"process ({e}). Functions and classes go by pickle, by "
                "reference: define them at module level") from e


# ------------------------------------------------- a child's line up


class _Client:
    """A task worker's or an actor process's line to the driver: the
    core's API there (what :func:`runtime` returns), each call a request
    up the process's pipe (``procs.serve``'s ``uplink``) that the driver's
    reader answers on the same pipe. The answer goes to the thread that
    waits for it, not to the process's calls.

    It also keeps the refs of this process: for each object id, the times
    the driver sent it (``serialization.delivering``) and the copies
    alive here. When the last copy goes, a thread of its own tells the
    driver how many it had received (``release``), so the driver unpins
    the object once no process holds it."""

    def __init__(self, post: Callable[[Any], None], spill_dir: str):
        self._post = post
        self._spill_dir = spill_dir
        self._rids = itertools.count(1)
        self._lock = threading.Lock()
        self._waits: Dict[int, list] = {}  # rid -> [event, status, value]
        self._refs: Dict[str, List[int]] = {}  # oid -> [received, alive]
        self._refs_lock = threading.RLock()
        self._released: "queue.SimpleQueue[Tuple[str, int]]" = (
            queue.SimpleQueue())
        threading.Thread(target=self._release_loop, daemon=True,
                         name="rtpt-core-release").start()

    # ----------------------------------------------------------- the pipe

    def route(self, msg: Any) -> bool:
        """Take an answer, or a cancel, off the reader (``procs.serve``'s
        ``route``). A cancel of a call that has not started is answered
        here, at once; a running one gets the error in its thread."""
        if type(msg) is not tuple or not msg:
            return False
        if msg[0].__class__ is int:  # a call, on its way to the queue
            core_worker.CALLS.expect(msg)
            return False
        if msg[0] == "cancel":
            seq = msg[1]
            refused = core_worker.CALLS.cancel(seq)
            if refused is not None:
                self._post((seq, "ok", refused))
            return True
        if msg[0] != "down":
            return False
        _, rid, status, value = msg
        with self._lock:
            slot = self._waits.pop(rid, None)
        if slot is None:
            return True
        if isinstance(value, procs.Spilled):
            try:
                with serialization.delivering():
                    value = value.load()
            except Exception as e:  # noqa: BLE001 — the request's error
                status, value = "err", e
        slot[1], slot[2] = status, value
        slot[0].set()
        return True

    def request(self, op: str, *args, **kwargs) -> Any:
        """``op`` done by the driver, waited for; raises its error."""
        rid = next(self._rids)
        slot: list = [threading.Event(), None, None]
        with self._lock:
            self._waits[rid] = slot
        try:
            self._post(("up", rid, op, args, kwargs))
            # In slices: a cancel raised into this thread lands between.
            while not slot[0].wait(0.1):
                pass
        except BaseException:
            with self._lock:
                self._waits.pop(rid, None)
            raise
        if slot[1] != "ok":
            raise slot[2]
        return slot[2]

    # ----------------------------------------------------------- the refs

    def adopt(self, oid: str) -> ObjectRef:
        ref = ObjectRef(oid)
        with self._refs_lock:
            entry = self._refs.setdefault(oid, [0, 0])
            entry[1] += 1
            if serialization.is_delivering():
                entry[0] += 1
        weakref.finalize(ref, self._drop, oid)
        return ref

    def _drop(self, oid: str) -> None:
        with self._refs_lock:
            entry = self._refs.get(oid)
            if entry is None:
                return
            entry[1] -= 1
            if entry[1] > 0:
                return
            del self._refs[oid]
        if entry[0]:
            self._released.put((oid, entry[0]))

    def _release_loop(self) -> None:
        """Tell the driver of released refs and of closed streams (a
        stream's close may run in ``__del__``, on any thread)."""
        while True:
            counts: Dict[str, int] = {}
            closes: List[str] = []
            oid, n = self._released.get()
            while True:
                if n is None:
                    closes.append(oid)
                else:
                    counts[oid] = counts.get(oid, 0) + n
                try:
                    oid, n = self._released.get_nowait()
                except queue.Empty:
                    break
            try:
                if counts:
                    self._post(("up", 0, "release", (counts,), {}))
                for gid in closes:
                    self._post(("up", 0, "gen_close", (gid,), {}))
            except (OSError, ValueError):
                return  # the driver is gone

    # ------------------------------------------------------ the core's API

    def submit_task(self, fn, label, args, kwargs, opts):
        opts = {**opts, "_parent": core_worker.current_seq()}
        return self.request("submit_task", fn, label, args, kwargs, opts)

    def submit_call(self, actor_id, method, args, kwargs, opts):
        opts = {**opts, "_parent": core_worker.current_seq()}
        return self.request("submit_call", actor_id, method, args, kwargs,
                            opts)

    def cancel(self, key: str, force: bool, recursive: bool) -> None:
        self.request("cancel", key, force, recursive)

    def gen_item(self, gid: str, value: Any) -> str:
        """Report a streaming call's next item: ``ok`` or ``closed``."""
        value = serialization.spill_if_large(
            os.path.join(self._spill_dir,
                         f"item-{os.getpid()}-{ObjectID.generate()}"), value)
        return self.request("gen_item", gid, value)

    def gen_next(self, gid: str, index: int) -> Tuple[str, Any]:
        return self.request("gen_next", gid, index)

    def gen_close(self, gid: str) -> None:
        self._released.put((gid, None))  # fire and forget

    def free(self, oids) -> None:
        self.request("free", list(oids))

    def error_of(self, oid: str) -> Optional[BaseException]:
        return self.request("error_of", oid)

    def available_resources(self) -> Dict[str, float]:
        return self.request("available_resources")

    def nodes(self) -> List[Dict[str, Any]]:
        return self.request("nodes")

    def create_actor(self, wrapper, args, kwargs, opts, methods):
        return self.request("create_actor", wrapper, args, kwargs, opts,
                            methods)

    def put(self, value: Any) -> ObjectRef:
        value = serialization.spill_if_large(
            os.path.join(self._spill_dir,
                         f"put-{os.getpid()}-{ObjectID.generate()}"), value)
        return self.request("put", value)

    def get_objects(self, oids, timeout):
        return self.request("get", list(oids), timeout)

    def wait_objects(self, oids, num, timeout):
        return self.request("wait", list(oids), num, timeout)

    def kill(self, actor_id: str) -> None:
        self.request("kill", actor_id)

    def get_actor(self, name: str) -> Tuple[str, Dict[str, int]]:
        return self.request("get_actor", name)

    def cluster_resources(self) -> Dict[str, float]:
        return self.request("cluster_resources")


# ------------------------------------------------------------- the API

_rt: Optional[_Runtime] = None
_client: Optional[_Client] = None
_rt_lock = threading.Lock()


def client_uplink(spill_dir: str) -> Callable[[Callable[[Any], None]],
                                              Callable[[Any], bool]]:
    """``procs.serve``'s ``uplink`` for a task worker or an actor: this
    process's :class:`_Client`, made once the pipe is up."""
    def uplink(post):
        global _client
        _client = _Client(post, spill_dir)
        serialization.set_tracker(_client)
        return _client.route

    return uplink


def init(num_cpus: Optional[int] = None, num_gpus: Optional[int] = None,
         *, ignore_reinit_error: bool = False) -> None:
    """Make this process the driver of a core with ``num_cpus`` task slots
    (default: the host's cores) and ``num_gpus`` cards (default: the
    visible CUDA cards, counted at first need). A task or an actor is
    connected to its driver already."""
    global _rt
    with _rt_lock:
        if _rt is not None or _client is not None:
            if ignore_reinit_error:
                return
            raise RuntimeError("ray_tpu_torch is already initialized; call "
                               "shutdown() first")
        _rt = _Runtime(int(num_cpus or os.cpu_count() or 1), num_gpus)
        ctx.set_worker_context(ctx.WorkerContext("driver",
                                                 node_id=_rt.node_id))
        serialization.set_tracker(_rt)


def shutdown() -> None:
    """Stop every process of the core, the reader thread and (where the
    core started it) the fork server; drop every object. In a task or an
    actor it does nothing."""
    global _rt
    with _rt_lock:
        rt, _rt = _rt, None
    if rt is not None:
        rt.shutdown()
        serialization.set_tracker(None)
        ctx.set_worker_context(None)


atexit.register(shutdown)


def is_initialized() -> bool:
    return _rt is not None or _client is not None


def runtime() -> Union[_Runtime, _Client]:
    """The driver's core (started with the defaults where ``init`` was
    not called), or in a task or an actor its line to the driver."""
    if _client is not None:
        return _client
    if _rt is None:
        init(ignore_reinit_error=True)
    return _rt


def _as_list(refs) -> Tuple[List[ObjectRef], bool]:
    if isinstance(refs, ObjectRef):
        return [refs], True
    refs = list(refs)
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get/wait take ObjectRefs, got {r!r}")
    return refs, False


def put(value: Any) -> ObjectRef:
    """A copy of ``value`` as an object of the driver."""
    return runtime().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *,
        timeout: Optional[float] = None) -> Any:
    """The values of ``refs`` (one ref or a list), waiting for them up to
    ``timeout`` seconds; raises the error of a failed one. In a task, the
    task's CPUs are free for other tasks while it waits."""
    lst, single = _as_list(refs)
    got = runtime().get_objects([r.object_id for r in lst], timeout)
    out = []
    for status, value in got:
        if status == "err":
            raise value
        out.append(value)
    return out[0] if single else out


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """(ready, not ready): the first ``num_returns`` refs that are ready,
    in the order given, once that many are or ``timeout`` passed."""
    rt = runtime()
    lst, _ = _as_list(refs)
    done = set(rt.wait_objects([r.object_id for r in lst], num_returns,
                               timeout))
    ready = [r for r in lst if r.object_id in done][:num_returns]
    rest = [r for r in lst if r not in ready]
    return ready, rest


def cluster_resources() -> Dict[str, float]:
    return runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    """CPU and GPU of the node less what tasks and actors hold now."""
    return runtime().available_resources()


def nodes() -> List[Dict[str, Any]]:
    """The one node of this core, as the JAX package's node entries."""
    return runtime().nodes()


def free(refs: Sequence[ObjectRef]) -> None:
    """Drop the driver's values of ``refs`` (``get`` then times out)."""
    lst, _ = _as_list(refs)
    runtime().free([r.object_id for r in lst])


def error_of(ref: ObjectRef, *, timeout: Optional[float] = 30.0
             ) -> Optional[BaseException]:
    """The exception a ready object holds, or None for a value: read from
    the driver's object table, a healthy value never moved. Waits up to
    ``timeout`` for the object (``GetTimeoutError`` past it)."""
    rt = runtime()
    if not rt.wait_objects([ref.object_id], 1, timeout):
        raise GetTimeoutError(f"object {ref.object_id[:8]} not ready "
                              f"within {timeout} s")
    return rt.error_of(ref.object_id)


def cancel(ref: Union[ObjectRef, "ObjectRefGenerator"], *,
           force: bool = False, recursive: bool = False) -> None:
    """Cancel the task or actor call that makes ``ref`` (or the stream):
    queued, it fails at once with TaskCancelledError; running, the error
    is raised in its thread (``force``: a task's worker process is
    stopped). ``recursive`` also cancels what it submitted, through a
    parent that has finished. A finished call, or a second cancel, does
    nothing."""
    if isinstance(ref, ObjectRefGenerator):
        key = ref._gen_id
    elif isinstance(ref, ObjectRef):
        key = ref.object_id
    else:
        raise TypeError(f"cancel takes an ObjectRef, got {ref!r}")
    runtime().cancel(key, force, recursive)


class ObjectRefGenerator:
    """The refs of a streaming call's items, in order
    (``ray_tpu/core/api.py:583``): each ``next`` waits until the producer
    reported the item, so item 0 can be read while the producer runs; the
    producer's error arrives at the next ``next``. ``close()`` (and
    ``__del__``) tells the driver the consumer is gone, without waiting:
    it may run on any thread, during a collection, where a request that
    waits could wait on itself. Pickling hands the stream to the
    receiver."""

    def __init__(self, gen_id: str, index: int = 0):
        self._gen_id = gen_id
        self._index = index
        self._exhausted = False

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        if self._exhausted:
            raise StopIteration
        kind, value = runtime().gen_next(self._gen_id, self._index)
        if kind == "item":
            self._index += 1
            return value
        self._exhausted = True
        if kind == "err":
            raise value
        raise StopIteration

    def close(self) -> None:
        if self._exhausted:
            return
        self._exhausted = True
        if _client is not None:
            _client.gen_close(self._gen_id)
        elif _rt is not None:
            _rt.closes.put(self._gen_id)
            _rt._wake()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __reduce__(self):
        self._exhausted = True  # the receiver holds the stream now
        return ObjectRefGenerator, (self._gen_id, self._index)


@dataclasses.dataclass
class RuntimeContext:
    """Where the calling code runs (``ray_tpu/core/api.py:2387``)."""

    node_id: str
    namespace: str
    task_id: Optional[str]
    actor_id: Optional[str]
    card: Optional[int] = None

    def get_node_id(self) -> str:
        return self.node_id

    def get_accelerator_ids(self) -> Dict[str, List[str]]:
        """The cards this process took, under ``"GPU"``: its card where
        the core gave it one, else ``CUDA_VISIBLE_DEVICES`` (empty where
        unset: no card assigned)."""
        if self.card is not None:
            return {"GPU": [str(self.card)]}
        visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        return {"GPU": [c for c in visible.split(",") if c.strip()]}


def get_runtime_context() -> RuntimeContext:
    runtime()  # the driver's core, started where init was not called
    wc = ctx.get_worker_context()
    return RuntimeContext(node_id=wc.node_id, namespace="default",
                          task_id=core_worker.current_task_id(),
                          actor_id=wc.actor_id, card=wc.card)


def kill(actor: "ActorHandle", *, no_restart: bool = True) -> None:
    """Kill the actor's process at once; it is not restarted and its calls
    fail with ActorDiedError."""
    if not isinstance(actor, ActorHandle):
        raise TypeError(f"kill takes an ActorHandle, got {actor!r}")
    runtime().kill(actor._actor_id)


def get_actor(name: str) -> "ActorHandle":
    rt = runtime()
    if isinstance(rt, _Client):
        return ActorHandle(*rt.get_actor(name))
    with rt.cv:
        aid = rt.names.get(name)
        if aid is None:
            raise ValueError(f"no live actor named {name!r}")
        return ActorHandle(aid, rt.actors[aid].methods)


def exit_actor() -> None:
    """Retire the actor whose method calls this: the call answers None,
    the calls behind it fail, and the actor is not restarted."""
    if ctx.role() != "actor":
        raise RuntimeError("exit_actor() called outside an actor's method")
    raise core_worker.ActorExit()


def method(*, num_returns: Union[int, str] = 1):
    """Give an actor's method ``num_returns`` results by default (or
    ``"streaming"``: an :class:`ObjectRefGenerator`)."""
    def deco(fn):
        fn.__rtpu_num_returns__ = _num_returns(num_returns)
        return fn

    return deco


def _num_returns(n: Union[int, str]) -> Union[int, str]:
    if n == "streaming":
        return n
    return int(n)


def _check_options(opts: Dict[str, Any], allowed: Sequence[str],
                   what: str) -> Dict[str, Any]:
    unknown = sorted(set(opts) - set(allowed))
    if unknown:
        raise ValueError(f"{what} options {unknown} are not supported by "
                         f"the port's single-host core (it takes "
                         f"{[a for a in allowed if not a.startswith('_')]})")
    gpus = opts.get("num_gpus", 0) or 0
    if gpus not in (0, 1):
        raise ValueError(f"num_gpus={gpus}: 0 or 1 card, as everywhere in "
                         "the port")
    if "num_returns" in opts:
        _num_returns(opts["num_returns"])
    return dict(opts)


def _traced(opts: Dict[str, Any], label: str) -> Dict[str, Any]:
    """``opts`` with the submit span's context, where tracing is on (the
    JAX package's ``inject_submit_span`` on its three submit paths)."""
    from ..util import tracing

    if not tracing.enabled():
        return opts
    carrier: Dict[str, Any] = {}
    tracing.inject_submit_span(carrier, label)
    return {**opts, "_trace": carrier.get("trace_ctx")}


def _single(out):
    if isinstance(out, ObjectRefGenerator):
        return out
    return out[0] if len(out) == 1 else out


def _resolve(module: str, qualname: str) -> Any:
    """The object at ``module.qualname`` (a ``@remote`` function or class,
    sent by name: its module-level name holds the wrapper, not the
    function or class itself)."""
    import importlib

    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _rebuild_remote(kind: str, module: str, qualname: str,
                    options: Dict[str, Any]) -> Any:
    """A ``@remote`` wrapper sent by name, with the options it was sent
    with: the name may hold the wrapper or the plain function or class
    (wrapped where it is used)."""
    target = _resolve(module, qualname)
    target = getattr(target, "__rtpu_target__", target)
    return (ActorClass if kind == "actor" else RemoteFunction)(target,
                                                               options)


def _reduce_by_name(target: Any, what: str, kind: str,
                    options: Dict[str, Any]):
    qualname = getattr(target, "__qualname__", "")
    if "<locals>" in qualname or "<lambda>" in qualname:
        raise pickle.PicklingError(
            f"{what} {qualname} is defined inside a function: it cannot be "
            "found by name in another process")
    return _rebuild_remote, (kind, target.__module__, qualname, options)


class RemoteFunction:
    """``@remote`` on a function: ``f.remote(*args)`` runs it as a task.
    It travels by name (its module and qualified name)."""

    def __init__(self, fn: Callable, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = _check_options(options or {}, TASK_OPTIONS,
                                       "task")
        self.__name__ = getattr(fn, "__name__", "task")
        self.__doc__ = getattr(fn, "__doc__", None)

    def options(self, **opts) -> "RemoteFunction":
        return RemoteFunction(self._fn, {**self._options, **opts})

    @property
    def __rtpu_target__(self) -> Callable:
        return self._fn

    def __reduce__(self):
        return _reduce_by_name(self._fn, "the remote function", "task",
                               self._options)

    def remote(self, *args, **kwargs):
        label = getattr(self._fn, "__qualname__", repr(self._fn))
        rt = runtime()
        procs.dumps(self, f"the task function {label}", "task workers",
                    "define it at module level, not inside a function or "
                    "as a lambda")
        _check_sendable(list(args) + list(kwargs.values()), label)
        return _single(rt.submit_task(self, label, args, kwargs,
                                      _traced(self._options, label)))

    def bind(self, *args, **kwargs):
        from ..dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"remote function {self.__name__} cannot be called "
                        "directly; use .remote()")


# What ``ActorMethod.options`` takes.
CALL_OPTIONS = ("num_returns", "deadline_s",
                "_generator_backpressure_num_objects")


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: Union[int, str] = 1,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._name = name
        self._options = {"num_returns": num_returns, **(options or {})}

    def options(self, **opts) -> "ActorMethod":
        """``num_returns`` (a count or ``"streaming"``), ``deadline_s``,
        ``_generator_backpressure_num_objects``."""
        return ActorMethod(self._handle, self._name, options={
            **self._options, **_check_options(opts, CALL_OPTIONS,
                                              "actor call")})

    def remote(self, *args, **kwargs):
        h = self._handle
        _check_sendable(list(args) + list(kwargs.values()),
                        f"actor method {self._name}")
        return _single(runtime().submit_call(
            h._actor_id, self._name, args, kwargs,
            _traced(self._options, self._name)))

    def bind(self, *args, **kwargs):
        from ..dag.dag_node import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    """A handle on an actor: ``h.method.remote(...)``. It travels by id:
    in a task or an actor, its calls go through the driver."""

    def __init__(self, actor_id: str, methods: Dict[str, int]):
        self._actor_id = actor_id
        self._methods = methods

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._methods:
            raise AttributeError(f"the actor has no method {name!r}")
        return ActorMethod(self, name, self._methods[name])

    def __reduce__(self):
        return ActorHandle, (self._actor_id, self._methods)

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, ActorHandle)
                and other._actor_id == self._actor_id)

    def __hash__(self) -> int:
        return hash(self._actor_id)

    def __repr__(self) -> str:
        return f"ActorHandle({self._actor_id[:16]})"


def _methods_of(cls: type) -> Dict[str, int]:
    out = {}
    for name in dir(cls):
        if name.startswith("__"):
            continue
        fn = getattr(cls, name, None)
        if callable(fn):
            out[name] = getattr(fn, "__rtpu_num_returns__", 1)
    return out


class ActorClass:
    """``@remote`` on a class: ``C.remote(*args)`` starts an actor."""

    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = _check_options(options or {}, ACTOR_OPTIONS,
                                       "actor")
        self.__name__ = cls.__name__
        self.__doc__ = cls.__doc__

    def options(self, **opts) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **opts})

    @property
    def __rtpu_target__(self) -> type:
        return self._cls

    def __reduce__(self):
        return _reduce_by_name(self._cls, "the actor class", "actor",
                               self._options)

    def remote(self, *args, **kwargs) -> ActorHandle:
        """Start the actor; a ref at the top of an argument is passed as
        its value."""
        methods = _methods_of(self._cls)
        args = [get(a) if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {k: get(v) if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
        aid = runtime().create_actor(self, args, kwargs, _traced(
            self._options, f"{self._cls.__qualname__}.__init__"), methods)
        return ActorHandle(aid, methods)

    def bind(self, *args, **kwargs):
        from ..dag.dag_node import ClassNode

        return ClassNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"actor class {self.__name__} cannot be "
                        "instantiated directly; use .remote()")


def remote(*args, **kwargs):
    """``@remote`` or ``@remote(**options)`` on a function or a class."""
    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return wrap(args[0])
    if args:
        raise TypeError("remote takes a function or class, or options only")
    return wrap
