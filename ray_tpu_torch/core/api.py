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

Divergences by design (this slice): one host; handles and refs stay in
the driver, so passing an ``ActorHandle`` or an ``ObjectRef`` to another
process, nested in an argument, and submitting a task from a task or an
actor raise ``TypeError`` (``serialization.HANDLES_STAY``); functions,
classes and arguments go by plain pickle, by reference, so a nested
class or function, a closure or a lambda raises ``TypeError`` naming
itself before any spawn.
"""
from __future__ import annotations

import atexit
import itertools
import logging
import multiprocessing
import multiprocessing.connection as mpc
import os
import pickle
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
from .ids import ActorID, ObjectID
from .serialization import HANDLES_STAY, ObjectRef

logger = logging.getLogger(__name__)

TASK_OPTIONS = ("num_cpus", "num_gpus", "num_returns", "name")
ACTOR_OPTIONS = ("num_cpus", "num_gpus", "name", "max_restarts",
                 "max_task_retries", "checkpoint_interval_s",
                 "checkpoint_every_n", "_preload")
# Seconds an actor that is being killed or retired gets to leave.
_STOP_S = 5.0


class RayTpuError(Exception):
    """Base of the core's errors."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` found the object not ready within its timeout."""


class WorkerCrashedError(RayTpuError):
    """The task worker running a task died."""


class ActorDiedError(RayTpuError):
    """The actor is dead: killed, retired by ``exit_actor``, its
    constructor raised, or its process died with no restart left."""


class TaskError(RayTpuError):
    """An exception raised inside a task or an actor's method."""

    def __init__(self, label: str, cause: BaseException,
                 traceback_str: str = ""):
        super().__init__(f"task {label} failed: {cause!r}\n{traceback_str}")
        self.label = label
        self.cause = cause
        self.traceback_str = traceback_str


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

    def send(self, method, args=(), kwargs=None) -> int:
        with self.lock:
            return super().send(method, args, kwargs)


class _Call:
    """A task, an actor's method call or a control call, from submission
    to its answer."""

    __slots__ = ("kind", "label", "fn", "method", "args", "kwargs", "oids",
                 "num_returns", "key", "cpus", "card_ask", "seq", "proc",
                 "reply")

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


class _Runtime:
    def __init__(self, num_cpus: int, num_gpus: Optional[int]):
        self.num_cpus = num_cpus
        self._num_gpus = num_gpus
        self.cv = threading.Condition()
        self.objects: Dict[str, Tuple[str, Any]] = {}
        self.waiting: set = set()  # oids not settled whose ref lives
        self.tasks: deque = deque()  # tasks not sent yet
        self.idle: Dict[Optional[int], List[_Proc]] = {}
        self.task_procs: List[_Proc] = []
        self.cpus_used = 0.0
        self.cards_used: set = set()
        self.actors: Dict[str, _Actor] = {}
        self.names: Dict[str, str] = {}
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
        ref = ObjectRef(ObjectID.generate())
        self.waiting.add(ref.object_id)
        weakref.finalize(ref, self._release, ref.object_id)
        return ref

    def _release(self, oid: str) -> None:
        with self.cv:
            self.objects.pop(oid, None)
            self.waiting.discard(oid)

    def _settle(self, oid: str, status: str, value: Any) -> None:
        if oid in self.waiting:  # else its ref is gone: drop the value
            self.waiting.discard(oid)
            self.objects[oid] = (status, value)

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
        copy = serialization.loads(data, [b.raw() for b in bufs])
        with self.cv:
            ref = self.new_ref()
            self._settle(ref.object_id, "ok", copy)
        return ref

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
                    opts: Dict[str, Any]) -> List[ObjectRef]:
        num_returns = int(opts.get("num_returns", 1))
        with self.cv:
            refs = [self.new_ref() for _ in range(num_returns)]
            call = _Call("task", label, args, kwargs,
                         [r.object_id for r in refs], num_returns)
            call.fn = fn
            call.cpus = float(opts.get("num_cpus", 1) or 0)
            call.card_ask = int(opts.get("num_gpus", 0) or 0)
            if call.cpus > self.num_cpus:
                raise ValueError(f"{label} asks num_cpus={call.cpus}, more "
                                 f"than the {self.num_cpus} of this core")
            self.tasks.append(call)
            self._dispatch()
        return refs

    def _deps_state(self, call: _Call) -> Optional[Tuple[str, Any]]:
        """None while a top-level ref argument is pending, ("err", e) for a
        failed one, else ("ok", None)."""
        for v in itertools.chain(call.args, call.kwargs.values()):
            if isinstance(v, ObjectRef):
                got = self.objects.get(v.object_id)
                if got is None:
                    return None
                if got[0] == "err":
                    return got
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
                  (card, self.spill_dir, dict(os.environ)),
                  f"rtpt-task-{len(self.task_procs)}", card)
        self.task_procs.append(p)
        self._wake()
        return p

    def _dispatch(self) -> None:
        """Send every task and actor call whose arguments are ready and
        whose resources are free (called with ``cv`` held)."""
        for call in list(self.tasks):
            deps = self._deps_state(call)
            if deps is None:
                continue
            if deps[0] == "err":
                self.tasks.remove(call)
                self._settle_all(call, "err", deps[1])
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
            self._send(p, call, "run", (call.fn,))
        for actor in self.actors.values():
            self._dispatch_actor(actor)
        self.cv.notify_all()

    def _send(self, p: _Proc, call: _Call, method: str, head: Tuple) -> None:
        try:
            args, kwargs = self._resolved(call)
            call.proc = p
            call.seq = p.send(method, head + args, kwargs)
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
        payload = core_worker.actor_payload(wrapper, args, kwargs,
                                            where="actor's process")
        actor_id = ActorID.generate()
        a = _Actor(actor_id, cls, payload, opts, methods)
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
            "checkpoint_interval_s")}
        a.incarnation += 1
        a.proc = _Proc(context, core_worker._core_actor_main,
                       (a.payload, a.actor_id, a.card, opts, restore,
                        self.spill_dir, dict(os.environ)),
                       f"rtpt-actor-{a.cls.__name__}-{a.actor_id[:8]}",
                       a.card)
        a.state = "starting"
        self._wake()

    def submit_call(self, actor_id: str, method: str, args, kwargs,
                    num_returns: int) -> List[ObjectRef]:
        with self.cv:
            a = self.actors[actor_id]
            label = f"{a.cls.__qualname__}.{method}"
            refs = [self.new_ref() for _ in range(num_returns)]
            call = _Call("actor", label, args, kwargs,
                         [r.object_id for r in refs], num_returns)
            call.method = method
            call.key = next(a.next_key)
            if a.state == "dead":
                self._settle_all(call, "err", self._died(a))
                return refs
            a.pending.append(call)
            self._dispatch_actor(a)
            self.cv.notify_all()
        return refs

    def _died(self, a: _Actor) -> ActorDiedError:
        return ActorDiedError(f"actor {a.cls.__qualname__} "
                              f"({a.actor_id[:8]}) is dead: {a.death}")

    def _dispatch_actor(self, a: _Actor) -> None:
        if a.state not in ("starting", "alive"):
            return
        while a.pending:
            call = a.pending[0]
            deps = self._deps_state(call)
            if deps is None:
                return
            a.pending.popleft()
            if deps[0] == "err":
                self._settle_all(call, "err", deps[1])
                continue
            self._send(a.proc, call, "call", (call.method, call.key))

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
                call.proc = a.proc
                call.seq = a.proc.send(method, args)
                a.proc.calls[call.seq] = call
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

    def kill(self, actor_id: str) -> None:
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
            by_conn = {p.conn: p for p in live}
            by_sentinel = {p.proc.sentinel: p for p in live}
            try:
                ready = mpc.wait([self._wake_r] + list(by_conn)
                                 + list(by_sentinel), 1.0)
            except OSError:
                continue  # a process went away while we listed it
            if self._wake_r in ready:
                while self._wake_r.poll():
                    self._wake_r.recv_bytes()
            got: List[Tuple[_Proc, Tuple]] = []
            for o in ready:
                if o in by_conn:
                    got += self._read_all(by_conn[o])
            dead = [by_sentinel[o] for o in ready if o in by_sentinel]
            for p in dead:
                got += self._read_all(p)
            with self.cv:
                for p, reply in got:
                    self._on_reply(p, *reply)
                for p in dead:
                    self._on_death(p)
                self._dispatch()

    def _read_all(self, p: _Proc) -> List[Tuple[_Proc, Tuple]]:
        out = []
        while True:
            reply = p.read()
            if reply is None:
                return out
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
        self._finish(call, status, value)
        if call.kind == "task":
            self.cpus_used -= call.cpus
            if p.card is not None:
                self.cards_used.discard(p.card)
            self.idle.setdefault(p.card, []).append(p)

    def _finish(self, call: _Call, status: str, value: Any) -> None:
        if call.kind == "control":
            call.reply = (status, value)
            return
        if status == "err":
            err = value if isinstance(value, BaseException) else TaskError(
                call.label, RuntimeError(str(value)), str(value))
            self._settle_all(call, "err", err)
        elif isinstance(value, core_worker.Raised):
            self._settle_all(call, "err",
                             TaskError(call.label, value.exc, value.tb))
        elif isinstance(value, core_worker.Exited):
            a = self._actor_of(call.proc) if call.proc else None
            if value.retired or a is None:
                self._settle_all(call, "err", ActorDiedError(
                    f"{call.label}: the actor exited"))
            else:
                self._settle_value(call, None if call.num_returns == 1
                                   else (None,) * call.num_returns)
                self._exit_actor(a)
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
                self.cpus_used -= call.cpus
                if p.card is not None:
                    self.cards_used.discard(p.card)
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


# ------------------------------------------------------------- the API

_rt: Optional[_Runtime] = None
_rt_lock = threading.Lock()


def _refuse_outside_driver(what: str) -> None:
    role = ctx.role()
    if role in ("task", "actor"):
        raise TypeError(f"{what} in a {role} process: {HANDLES_STAY}")


def init(num_cpus: Optional[int] = None, num_gpus: Optional[int] = None,
         *, ignore_reinit_error: bool = False) -> None:
    """Make this process the driver of a core with ``num_cpus`` task slots
    (default: the host's cores) and ``num_gpus`` cards (default: the
    visible CUDA cards, counted at first need)."""
    global _rt
    _refuse_outside_driver("init()")
    with _rt_lock:
        if _rt is not None:
            if ignore_reinit_error:
                return
            raise RuntimeError("ray_tpu_torch is already initialized; call "
                               "shutdown() first")
        ctx.set_worker_context(ctx.WorkerContext("driver"))
        _rt = _Runtime(int(num_cpus or os.cpu_count() or 1), num_gpus)


def shutdown() -> None:
    """Stop every process of the core, the reader thread and (where the
    core started it) the fork server; drop every object."""
    global _rt
    with _rt_lock:
        rt, _rt = _rt, None
    if rt is not None:
        rt.shutdown()
        ctx.set_worker_context(None)


atexit.register(shutdown)


def is_initialized() -> bool:
    return _rt is not None


def runtime() -> _Runtime:
    """The driver's core, started with the defaults where ``init`` was not
    called."""
    _refuse_outside_driver("a remote call")
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
    ``timeout`` seconds; raises the error of a failed one."""
    rt = runtime()
    lst, single = _as_list(refs)
    oids = [r.object_id for r in lst]
    done = rt.wait_objects(oids, len(set(oids)), timeout)
    if len(done) < len(set(oids)):
        raise GetTimeoutError(f"{len(set(oids)) - len(done)} of "
                              f"{len(set(oids))} objects not ready within "
                              f"{timeout} s")
    out = []
    with rt.cv:
        got = [rt.objects[o] for o in oids]
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
    rt = runtime()
    return {"CPU": float(rt.num_cpus), "GPU": float(rt.num_gpus())}


def kill(actor: "ActorHandle", *, no_restart: bool = True) -> None:
    """Kill the actor's process at once; it is not restarted and its calls
    fail with ActorDiedError."""
    if not isinstance(actor, ActorHandle):
        raise TypeError(f"kill takes an ActorHandle, got {actor!r}")
    runtime().kill(actor._actor_id)


def get_actor(name: str) -> "ActorHandle":
    rt = runtime()
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


def method(*, num_returns: int = 1):
    """Give an actor's method ``num_returns`` results by default."""
    def deco(fn):
        fn.__rtpu_num_returns__ = int(num_returns)
        return fn

    return deco


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
    return dict(opts)


def _resolve(module: str, qualname: str) -> Any:
    """The object at ``module.qualname`` (a ``@remote`` function or class,
    sent by name: its module-level name holds the wrapper, not the
    function or class itself)."""
    import importlib

    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _reduce_by_name(target: Any, what: str):
    qualname = getattr(target, "__qualname__", "")
    if "<locals>" in qualname or "<lambda>" in qualname:
        raise pickle.PicklingError(
            f"{what} {qualname} is defined inside a function: it cannot be "
            "found by name in another process")
    return _resolve, (target.__module__, qualname)


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
        return _reduce_by_name(self._fn, "the remote function")

    def remote(self, *args, **kwargs):
        label = getattr(self._fn, "__qualname__", repr(self._fn))
        rt = runtime()
        procs.dumps(self, f"the task function {label}", "task workers",
                    "define it at module level, not inside a function or "
                    "as a lambda")
        _check_sendable(list(args) + list(kwargs.values()), label)
        refs = rt.submit_task(self, label, args, kwargs, self._options)
        return refs[0] if len(refs) == 1 else refs

    def bind(self, *args, **kwargs):
        from ..dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"remote function {self.__name__} cannot be called "
                        "directly; use .remote()")


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, num_returns)

    def remote(self, *args, **kwargs):
        h = self._handle
        _check_sendable(list(args) + list(kwargs.values()),
                        f"actor method {self._name}")
        refs = runtime().submit_call(h._actor_id, self._name, args, kwargs,
                                     self._num_returns)
        return refs[0] if len(refs) == 1 else refs

    def bind(self, *args, **kwargs):
        from ..dag.dag_node import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    """The driver's handle on an actor: ``h.method.remote(...)``. It never
    leaves the driver (see the module docstring)."""

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
        raise TypeError(f"{self!r} cannot be sent to another process: "
                        f"{HANDLES_STAY}")

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
            out[name] = int(getattr(fn, "__rtpu_num_returns__", 1))
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
        return _reduce_by_name(self._cls, "the actor class")

    def remote(self, *args, **kwargs) -> ActorHandle:
        methods = _methods_of(self._cls)
        aid = runtime().create_actor(self, args, kwargs, self._options,
                                     methods)
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
