"""The process core's worker side: actor processes and task workers
(counterpart of the JAX package's ``core/worker.py``, its actor part
``:76-230`` and its task loop).

Every process here is one process of one host, started by the calling
process with ``multiprocessing`` and served by ``util/procs.py``'s loop:
calls come over a pipe and run in their order of arrival on the
process's one call thread (the JAX package's actor mailbox).

- :class:`ActorProcess` (spawned, ``_actor_main``) hosts one object whose
  methods are called by name: RLlib's runners and learners
  (``rllib/utils/actor_manager.py`` imports them from here).
- ``_core_actor_main`` hosts the object of an actor of the core's
  ``remote`` (``core/api.py``) in an :class:`ActorHost`: the calls' errors
  travel as values, ``exit_actor`` retires the actor. An async actor (a
  class with ``async def`` methods) runs every call, sync or async, on
  one persistent event loop on a thread of its own (the JAX package's
  ``ActorMailbox.ensure_aio_loop``): the call thread hands each call to
  the loop and takes the next, so a coroutine that awaits (a queue's
  blocked ``get``) holds up no other call; at most ``max_concurrency``
  (default 100) run at once, and each answers itself when it ends. An
  actor with
  ``checkpoint_every_n`` / ``checkpoint_interval_s`` writes its instance
  and its exactly-once call journal to the host-local record store
  (``core/checkpoint.py``) and a restarted one restores the newest
  record, so a replayed call whose result the journal holds returns it
  without running again. The compiled DAG's resident loop runs on the
  same call thread (``dag/resident.py``): installing a plan hands the
  thread to the loop, which answers the DAG's control calls itself, and
  teardown gives it back.
- ``_task_main`` is a task worker of the driver's pool: it runs the
  functions sent to it; results of ``serialization.SPILL_BYTES`` or more
  go back as files.

Both kinds talk to the driver through ``core/api.py``'s ``_Client`` over
their pipe (``procs.serve``'s ``uplink``): a task or an actor submits
tasks and calls, gets, waits and puts.

Nothing here imports torch at the top: an actor or task worker that runs
no torch never loads it.
"""
from __future__ import annotations

import inspect
import logging
import multiprocessing
import os
import pickle
import tempfile
import threading
import time
import traceback
import types
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from .. import flags
from ..util import procs
from . import checkpoint
from . import context as ctx
from . import serialization

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
    with serialization.capture():  # the checks' pickles carry no refs
        procs.dumps(cls, f"the actor's class or factory {cls!r}", where,
                    hint)
        for name, value in [(f"argument {i}", a)
                            for i, a in enumerate(args)] + [
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




# ------------------------------------------------- the core's actor and task


class ActorExit(BaseException):
    """Raised by ``exit_actor()`` inside an actor's method: the call
    answers None and the actor retires for good (no restart; the calls
    behind it fail)."""


class Raised:
    """An exception raised by a task or an actor's method, travelling as
    the call's value (the process goes on serving): the exception where it
    pickles, else a RuntimeError naming it, and the traceback."""

    def __init__(self, exc: BaseException, tb: str):
        try:
            pickle.loads(serialization.dumps(exc))
        except Exception:  # noqa: BLE001 — an exception that cannot travel
            exc = RuntimeError(f"{type(exc).__name__}: {exc!r}")
        self.exc = exc
        self.tb = tb


class Exited:
    """The value of an actor's call after ``exit_actor()``: the exiting
    call itself (``retired`` False: it answers None) and every call behind
    it (``retired`` True: they fail)."""

    def __init__(self, retired: bool):
        self.retired = retired


def _run(fn: Callable, args: Tuple, kwargs: Dict[str, Any]) -> Any:
    value = fn(*args, **kwargs)
    if isinstance(value, types.CoroutineType):  # an async function
        import asyncio

        value = asyncio.run(value)
    return value


def is_async(cls: type) -> bool:
    """Does ``cls`` define an ``async def`` method (an async actor)?"""
    return any(inspect.iscoroutinefunction(getattr(cls, name, None))
               for name in dir(cls) if not name.startswith("__"))


# Coroutines an async actor runs at once where ``max_concurrency`` is not
# given (the JAX package's default for async actors).
ASYNC_CONCURRENCY = 100


class _AsyncLoop:
    """An async actor's event loop, on a thread of its own for the
    actor's life, and the semaphore that bounds its calls."""

    def __init__(self, actor_id: str, max_concurrency: int):
        import asyncio

        self.loop = asyncio.new_event_loop()
        self.sem = asyncio.Semaphore(max_concurrency)
        self.running: set = set()  # the calls' futures, until each ends
        self.thread = threading.Thread(
            target=self._run, name=f"rtpt-actor-aio-{actor_id[:8]}",
            daemon=True)
        self.thread.start()

    def _run(self) -> None:
        import asyncio

        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def submit(self, coro) -> None:
        import asyncio

        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        self.running.add(fut)
        fut.add_done_callback(self._done)

    def _done(self, fut) -> None:
        self.running.discard(fut)
        if not fut.cancelled() and fut.exception() is not None:
            logger.error("an async call failed past its answer",
                         exc_info=fut.exception())


class ActorHost:
    """What a core actor process serves: the user's instance behind
    :meth:`call`, its journal and checkpoints, and the compiled DAGs it
    takes part in.

    ``opts``: ``max_task_retries`` (nonzero keeps the exactly-once journal
    of applied calls), ``checkpoint_every_n`` and
    ``checkpoint_interval_s`` (durable checkpoints while
    ``RTPU_ACTOR_CHECKPOINT`` is on). ``restore``: this process replaces a
    dead one, so the newest checkpoint of ``actor_id`` is restored (its
    instance and journal) in place of a constructor run, where one
    exists."""

    # Journal entries kept: the driver's call numbers are dense, so this
    # bounds the journal to the retry horizon, not the actor's life.
    JOURNAL_MAX = 1024

    def __init__(self, payload: bytes, actor_id: str,
                 opts: Dict[str, Any], restore: bool):
        self.actor_id = actor_id
        self.ckpt_every_n = int(opts.get("checkpoint_every_n") or 0)
        self.ckpt_interval = float(opts.get("checkpoint_interval_s") or 0.0)
        self.ckpt_enabled = bool(
            flags.get("RTPU_ACTOR_CHECKPOINT")
            and (self.ckpt_every_n > 0 or self.ckpt_interval > 0.0))
        self.replay = bool(opts.get("max_task_retries"))
        # Applied calls: call number -> value. Compiled DAGs keep their
        # own entries here under "__dag__<dag_id>" (``dag/resident.py``).
        self.journal: Dict[Any, Any] = {}
        self.epoch = 0
        self.calls_since_ckpt = 0
        self.last_ckpt = time.monotonic()
        self.exited = False
        self.restored_epoch: Optional[int] = None
        self.mailbox: Optional[procs.Mailbox] = None
        self.dags: Dict[str, Any] = {}  # dag id -> resident.WorkerDAG
        # How an async actor's call answers itself: its result, a file
        # where large (``_core_actor_main`` sets it).
        self.result_wrap: Callable[[int, str, Any], Any] = (
            lambda seq, method, value: value)
        self.aio: Optional[_AsyncLoop] = None
        record = None
        if restore and self.ckpt_enabled:
            found = checkpoint.newest_local(actor_id)
            if found is not None:
                record = checkpoint.decode(found[1])
        # The class as sent: an ActorClass travels by name (its module
        # attribute is the wrapper, not the class), so checkpoints keep it
        # beside the instance's state (``_restore``).
        with serialization.delivering():  # its refs: the process's borrows
            self._cls_ref, args, kwargs = pickle.loads(payload)
        cls = getattr(self._cls_ref, "__rtpu_target__", self._cls_ref)
        if is_async(cls):
            conc = opts.get("max_concurrency")
            self.aio = _AsyncLoop(actor_id, ASYNC_CONCURRENCY if conc is None
                                  else max(1, int(conc)))
        if record is not None:
            self.instance = _restore(*record["instance"])
            self.journal = record["journal"]
            self.epoch = self.restored_epoch = int(record["epoch"])
        else:
            if restore:
                checkpoint.prune_local(actor_id)
            self.instance = cls(*args, **kwargs)

    def bind(self, mailbox: procs.Mailbox) -> None:
        self.mailbox = mailbox

    # ------------------------------------------------------------- calls

    def call(self, _method: str, _key: Optional[int], /, *args,
             **kwargs) -> Any:
        """``method(*args, **kwargs)`` on the instance; its value, a
        :class:`Raised` or an :class:`Exited`. A call number ``key`` the
        journal holds returns its journaled value without running."""
        if self.exited:
            return Exited(retired=True)
        if self.replay and _key is not None and _key in self.journal:
            return self.journal[_key]
        if self.aio is not None:
            self.aio.submit(self._drive(self.mailbox.seq, _method, _key,
                                        args, kwargs))
            return procs.ANSWERED
        try:
            value = _run(getattr(self.instance, _method), args, kwargs)
        except ActorExit:
            return self._exit()
        except Exception as e:  # noqa: BLE001 — the call's value
            value = Raised(e, traceback.format_exc())
        return self._applied(_key, value)

    def _exit(self) -> "Exited":
        self.exited = True
        checkpoint.prune_local(self.actor_id)
        return Exited(retired=False)

    async def _drive(self, seq: int, method: str, key: Optional[int],
                     args: Tuple, kwargs: Dict[str, Any]) -> None:
        """An async actor's call, on its loop: a coroutine method is
        awaited, a sync one runs there; then the call answers itself."""
        async with self.aio.sem:
            if self.exited:
                value: Any = Exited(retired=True)
            else:
                try:
                    value = getattr(self.instance, method)(*args, **kwargs)
                    if inspect.isawaitable(value):
                        value = await value
                    value = self._applied(key, value)
                except ActorExit:
                    value = self._exit()
                except Exception as e:  # noqa: BLE001 — the call's value
                    value = self._applied(
                        key, Raised(e, traceback.format_exc()))
        try:
            value = self.result_wrap(seq, method, value)
            self.mailbox.answer(seq, "ok", value)
        except Exception:  # noqa: BLE001 — reported to the caller
            self.mailbox.answer(seq, "err", traceback.format_exc())

    def _applied(self, _key: Optional[int], value: Any) -> Any:
        """Journal and checkpoint after a call ran; its value."""
        if self.replay and _key is not None:
            self.journal[_key] = value
            keys = [k for k in self.journal if isinstance(k, int)]
            for k in sorted(keys)[:max(0, len(keys) - self.JOURNAL_MAX)]:
                del self.journal[k]
        if self.ckpt_enabled:
            self.calls_since_ckpt += 1
            self.maybe_checkpoint()
        return value

    # ------------------------------------------------------- checkpoints

    def maybe_checkpoint(self) -> None:
        """Checkpoint where one is due: every ``checkpoint_every_n``
        calls, or ``checkpoint_interval_s`` after the last."""
        if not self.ckpt_enabled or self.exited:
            return
        due = ((self.ckpt_every_n
                and self.calls_since_ckpt >= self.ckpt_every_n)
               or (self.ckpt_interval > 0.0 and time.monotonic()
                   - self.last_ckpt >= self.ckpt_interval))
        if due:
            self.checkpoint()

    def checkpoint(self) -> Optional[int]:
        """Write the instance and the journal under the next epoch; the
        epoch, or None where the instance does not pickle (the actor goes
        on, without checkpoints)."""
        try:
            blob = checkpoint.encode(
                (self._cls_ref, self.instance.__getstate__()), self.journal,
                self.epoch + 1)
        except Exception:  # noqa: BLE001 — an instance that cannot pickle
            logger.exception("actor %s: checkpoint failed",
                             self.actor_id[:8])
            return None
        self.epoch += 1
        self.calls_since_ckpt = 0
        self.last_ckpt = time.monotonic()
        checkpoint.write_local(self.actor_id, self.epoch, blob)
        return self.epoch

    def idle(self) -> None:
        if self.ckpt_interval > 0.0:
            self.maybe_checkpoint()

    def checkpoint_state(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "restored_epoch": self.restored_epoch,
                "pid": os.getpid()}

    # ----------------------------------------------------- compiled DAGs

    def dag_install(self, plan: Dict[str, Any],
                    recover: Optional[Dict[str, Any]] = None) -> Any:
        """Install this actor's part of a compiled DAG's plan and run its
        resident loop on this thread until teardown: the loop answers this
        call once its rings exist."""
        from ..dag import resident

        return resident.install(self, plan, recover)

    def dag_status(self, dag_id: str) -> Dict[str, Any]:
        from ..dag import resident

        return resident.status(self, dag_id)

    def dag_teardown(self, dag_id: str) -> Dict[str, Any]:
        from ..dag import resident

        return resident.teardown(self, dag_id)

    def dag_pause(self, dag_id: str) -> Dict[str, Any]:
        return {"known": False}  # no loop runs here: nothing to pause

    def dag_positions(self, dag_id: str) -> Dict[str, Any]:
        return {"known": False}

    def dag_resume_info(self, dag_id: str) -> Dict[str, Any]:
        from ..dag import resident

        return resident.resume_info(self, dag_id)


def _restore(cls_ref: Any, state: Any) -> Any:
    """An instance from its class (as sent) and its ``__getstate__``, as
    pickle itself would rebuild it."""
    cls = getattr(cls_ref, "__rtpu_target__", cls_ref)
    obj = cls.__new__(cls)
    if hasattr(obj, "__setstate__"):
        obj.__setstate__(state)
    elif state:
        obj.__dict__.update(state)
    return obj


def _take_environment(environ: Optional[Dict[str, str]]) -> None:
    """Take the calling process's environment of the moment (a fork
    server's is older) before anything reads it."""
    if environ is not None:
        os.environ.clear()
        os.environ.update(environ)
        tempfile.tempdir = None


def _result_wrap(spill_dir: str) -> Callable[[int, str, Any], Any]:
    def wrap(seq: int, method: str, value: Any) -> Any:
        return serialization.spill_if_large(
            os.path.join(spill_dir, f"{os.getpid()}-{seq}.out"), value)

    return wrap


def _core_actor_main(conn, payload: bytes, actor_id: str,
                     card: Optional[int], opts: Dict[str, Any],
                     restore: bool, spill_dir: str,
                     environ: Optional[Dict[str, str]]) -> None:
    """A core actor process: the driver's environment, the card (before
    anything touches CUDA), the worker context, then the host's loop."""
    t_main = time.time()
    _take_environment(environ)
    if card is not None:
        procs.take_card(card)
    ctx.set_worker_context(ctx.WorkerContext("actor", actor_id, card))
    host: List[ActorHost] = []

    wrap = _result_wrap(spill_dir)

    def build() -> ActorHost:
        host.append(ActorHost(payload, actor_id, opts, restore))
        host[0].result_wrap = wrap
        return host[0]

    procs.serve(conn, build, ready={"t_main": t_main}, load=_unspill,
                wrap=wrap, dumps=serialization.dumps,
                on_mailbox=lambda mb: host[0].bind(mb),
                idle=lambda: host[0].idle(),
                idle_s=float(flags.get("RTPU_CHECKPOINT_TICK_S")),
                loads=serialization.loads_delivered,
                uplink=_uplink(spill_dir))


class TaskHost:
    """What a task worker serves: :meth:`run` of the functions sent."""

    def run(self, _fn: Callable, /, *args, **kwargs) -> Any:
        _fn = getattr(_fn, "__rtpu_target__", _fn)  # a RemoteFunction
        try:
            return _run(_fn, args, kwargs)
        except Exception as e:  # noqa: BLE001 — the task's value
            return Raised(e, traceback.format_exc())


def _task_main(conn, card: Optional[int], spill_dir: str,
               environ: Optional[Dict[str, str]]) -> None:
    t_main = time.time()
    _take_environment(environ)
    if card is not None:
        procs.take_card(card)
    ctx.set_worker_context(ctx.WorkerContext("task", None, card))
    procs.serve(conn, TaskHost, ready={"t_main": t_main}, load=_unspill,
                wrap=_result_wrap(spill_dir), dumps=serialization.dumps,
                loads=serialization.loads_delivered,
                uplink=_uplink(spill_dir))


def _unspill(method: str, args: Tuple) -> Tuple:
    """A call's arguments from the driver, its files read back."""
    with serialization.delivering():
        return procs.unspill(method, args)


def _uplink(spill_dir: str):
    from . import api

    return api.client_uplink(spill_dir)


def fork_context(preload: Sequence[str]):
    """Multiprocessing's fork server, importing ``preload`` once where
    this call starts it (a server already running keeps its own list).
    The server never touches CUDA, so a forked child takes its card as a
    spawned one would."""
    c = multiprocessing.get_context("forkserver")
    c.set_forkserver_preload(list(preload))
    return c
