"""The replica: one copy of the user's deployment callable in a process
of its own (counterpart of the JAX package's ``serve/replica.py``).

:class:`ReplicaActor` keeps the JAX surface: it constructs the user class
(or wraps the function), executes requests, tracks the ongoing-request
count for the power-of-two router, and exposes health checks, stats and
``user_config`` reconfiguration.

Where the JAX package hosts it as an actor with ``max_concurrency =
max_ongoing_requests``, the port hosts it in a spawned process
(:func:`replica_main`, on ``util/procs.py``'s core): the controller holds
the process's pipe and sentinel, and the process listens on its own
``multiprocessing.connection.Listener`` (AF_UNIX, authenticated with the
processes' shared authkey). Each connection is one call, served on its
own thread:

- a request waits in a FIFO queue until fewer than
  ``max_ongoing_requests`` run (a request whose deadline passes there, or
  whose caller leaves, never runs), then runs;
- a streaming call sends its items as numbered messages, then an end or
  an error message;
- a second thread reads the connection: a cancel message, or the caller
  closing it, cancels the request (``context.Cancel``: its callbacks run
  at once, and the stream's generator is closed at its next item, so
  ``GeneratorExit`` reaches the user's ``finally``);
- replica-level calls (``stats``, ``queue_len``, ``check_health``,
  ``reconfigure``, ...) bypass the queue, so a saturated replica still
  answers its probes;
- a result holding 1 MiB or more of arrays or tensors travels as a file
  (``procs.Spilled``) that the caller reads back and removes; the
  connection carries its name.

A request's ``serve.replica`` hop (``serve/trace.py``) covers its
execution here, under the trace its call carried (``trace_ctx`` in the
call's meta); its attributes hold the seconds it waited in this
replica's queue (``replica_queue_s``) and upstream (``queue_wait_s``). A
stream's hop ends when its generator ends, after the user's own.
"""
from __future__ import annotations

import collections
import multiprocessing
import multiprocessing.connection as mpc
import os
import pickle
import sys
import threading
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from ..util import procs
from . import context as serve_context
from . import trace
from .admission import BackPressureError

# Results with at least this many bytes of arrays or tensors go as files.
SPILL_BYTES = 1 << 20


class ReplicaError(RuntimeError):
    """A call on a replica raised: the replica's traceback is in the
    message, the exception itself (where it unpickles) in ``cause``."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause


class ReplicaDiedError(RuntimeError):
    """The replica process went away before it answered (or could not be
    reached)."""


def authkey() -> bytes:
    """The key every process of one serve instance shares: spawned
    children inherit their parent's."""
    return bytes(multiprocessing.current_process().authkey)


# Connections a listener queues before it accepts them. Past its queue a
# connect either waits or, on some kernels, fails at once with EAGAIN:
# ``connect`` retries that for a while (the listener is alive, only busy).
LISTEN_BACKLOG = 128
_CONNECT_RETRY_S = 5.0


def listen(address: str):
    """An authenticated AF_UNIX listener on ``address``."""
    return mpc.Listener(address, family="AF_UNIX", authkey=authkey(),
                        backlog=LISTEN_BACKLOG)


def connect(address: str, retry_s: Optional[float] = None):
    """An authenticated connection to the listener on ``address``,
    retried for up to ``retry_s`` (default _CONNECT_RETRY_S) while its
    queue is full (``util/procs.py`` ``connect``)."""
    return procs.connect(address, _CONNECT_RETRY_S if retry_s is None
                         else retry_s)


def socket_address(directory: str, name: str) -> str:
    """An AF_UNIX address for ``name``: a file in ``directory``, or, where
    that path is too long for a socket, a name in Linux's abstract
    namespace."""
    path = os.path.join(directory, name)
    if len(path.encode()) <= 100:
        return path
    return "\0" + os.path.basename(directory) + "-" + name


# -------------------------------------------------------- the user object


class ReplicaActor:
    def __init__(self, func_or_class: Any, init_args: Tuple,
                 init_kwargs: Dict, user_config: Optional[Dict] = None):
        if isinstance(func_or_class, type):
            self._callable = func_or_class(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._callable = func_or_class
            self._is_function = True
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        # Set by the process around it: requests waiting for a turn, and
        # the process's own meter.
        self.waiting = 0
        self.meter: Dict[str, Any] = {}
        if user_config is not None:
            self.reconfigure(user_config)

    # ---------------------------------------------------------------- serving

    @staticmethod
    def _check_deadline(deadline_ts, where: str):
        """Pre-execution expiry gate: an expired request is dropped with
        the typed error instead of burning replica capacity."""
        if deadline_ts is not None and time.time() > deadline_ts:
            raise serve_context.DeadlineExceededError(
                f"request deadline passed {where}")

    def _target(self, method_name: str):
        if self._is_function or method_name == "__call__":
            return self._callable
        return getattr(self._callable, method_name)

    def handle_request(self, method_name: str, args: Tuple, kwargs: Dict,
                       multiplexed_model_id: str = "",
                       deadline_ts: Optional[float] = None,
                       start_ts: Optional[float] = None,
                       queue_wait_s: float = 0.0,
                       cancel: Optional[serve_context.Cancel] = None,
                       trace_ctx: Optional[Dict] = None,
                       replica_queue_s: float = 0.0):
        self._check_deadline(deadline_ts, "before replica execution")
        with self._lock:
            self._ongoing += 1
            self._total += 1
        token = serve_context.set_request_context(
            deadline_ts=deadline_ts, start_ts=start_ts,
            queue_wait_s=queue_wait_s,
            multiplexed_model_id=multiplexed_model_id, cancel=cancel,
            trace_ctx=trace_ctx)
        # Execution on this process's clock; the upstream wait it rode in
        # on and its wait in this replica's queue are attached.
        hop = trace.start_hop(
            "serve.replica", kind="replica",
            attributes={"method": method_name,
                        "queue_wait_s": round(queue_wait_s or 0.0, 6),
                        "replica_queue_s": round(replica_queue_s, 6)})
        try:
            return self._target(method_name)(*args, **kwargs)
        except BaseException as e:
            if hop is not None:
                hop.end(error=type(e).__name__)
            raise
        finally:
            if hop is not None:
                hop.end()
            serve_context.reset_request_context(token)
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method_name: str, args: Tuple,
                                 kwargs: Dict,
                                 multiplexed_model_id: str = "",
                                 deadline_ts: Optional[float] = None,
                                 start_ts: Optional[float] = None,
                                 queue_wait_s: float = 0.0,
                                 cancel: Optional[
                                     serve_context.Cancel] = None,
                                 trace_ctx: Optional[Dict] = None,
                                 replica_queue_s: float = 0.0):
        """Generator variant: the user handler returns a generator or
        iterable whose items stream to the caller one at a time. Closing
        this generator closes the user's (its ``finally`` runs)."""
        self._check_deadline(deadline_ts, "before replica execution")
        with self._lock:
            self._ongoing += 1
            self._total += 1
        token = serve_context.set_request_context(
            deadline_ts=deadline_ts, start_ts=start_ts,
            queue_wait_s=queue_wait_s,
            multiplexed_model_id=multiplexed_model_id, cancel=cancel,
            trace_ctx=trace_ctx)
        # The stream's whole life here: opened before the user generator
        # starts, ended once it has ended (exhausted, or closed by a
        # caller that walked away).
        hop = trace.start_hop(
            "serve.replica", kind="replica",
            attributes={"method": method_name, "stream": True,
                        "queue_wait_s": round(queue_wait_s or 0.0, 6),
                        "replica_queue_s": round(replica_queue_s, 6)})
        result = None
        items = 0
        error = None
        try:
            result = self._target(method_name)(*args, **kwargs)
            for item in result:
                items += 1
                yield item
        except BaseException as e:
            error = type(e).__name__
            raise
        finally:
            close = getattr(result, "close", None)
            if close is not None:
                close()
            if hop is not None:
                hop.end(items=items, **({"error": error} if error else {}))
            serve_context.reset_request_context(token)
            with self._lock:
                self._ongoing -= 1

    # ----------------------------------------------------------------- state

    def queue_len(self) -> int:
        return self._ongoing

    def stats(self) -> Dict[str, Any]:
        """Replica load snapshot: ongoing and total requests, requests
        waiting for a turn, the process's meter (``process``: pid, card,
        CUDA, threads, kernel launches, peak card memory, result files)
        and, where the user callable has ``serve_stats()`` (the LLM
        deployments: slot occupancy, blocked submitters, prefix-cache
        counters), its dict under ``serve``."""
        out: Dict[str, Any] = {"ongoing": self._ongoing,
                               "total": self._total,
                               "queued": self.waiting,
                               "process": process_info(self.meter)}
        fn = getattr(self._callable, "serve_stats", None)
        if callable(fn):
            try:
                out["serve"] = fn()
            except Exception:  # noqa: BLE001 — stats stay best effort
                pass
        return out

    def check_health(self) -> bool:
        user_check = getattr(self._callable, "check_health", None)
        if callable(user_check):
            user_check()
        return True

    def reconfigure(self, user_config: Dict) -> None:
        fn = getattr(self._callable, "reconfigure", None)
        if callable(fn):
            fn(user_config)

    def prepare_shutdown(self) -> None:
        fn = getattr(self._callable, "__del__", None)
        if callable(fn):
            try:
                fn()
            except Exception:  # noqa: BLE001 — shutting down regardless
                pass


def process_info(meter: Dict[str, Any]) -> Dict[str, Any]:
    """Where this process runs and what it spent: the meter's fields, and
    torch's state where torch is loaded (never loading it, never starting
    CUDA): threads, whether CUDA was initialised, the flash kernels'
    launches and the card's peak memory."""
    out = dict(meter)
    out["pid"] = os.getpid()
    torch = sys.modules.get("torch")
    out["cuda_initialized"] = bool(torch is not None
                                   and torch.cuda.is_initialized())
    out["num_threads"] = None if torch is None else torch.get_num_threads()
    fa = sys.modules.get("ray_tpu_torch.ops.flash_attention")
    if fa is not None:
        out["launches"] = {"flash_fwd": fa.flash_attention_fwd.launches,
                           "flash_bwd_dq": fa.flash_bwd_dq.launches,
                           "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
    if out["cuda_initialized"]:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


# ------------------------------------------------------- the wire format


def _array_bytes(value: Any) -> int:
    """Bytes of the arrays and tensors in a result (dicts, lists and
    tuples walked)."""
    if isinstance(value, dict):
        return sum(_array_bytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_array_bytes(v) for v in value)
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    numel = getattr(value, "numel", None)
    if callable(numel) and hasattr(value, "element_size"):
        return int(numel()) * int(value.element_size())
    return 0


def error_payload(exc: BaseException) -> Tuple[Optional[bytes], str]:
    tb = "".join(traceback.format_exception(exc))
    try:
        return pickle.dumps(exc), tb
    except Exception:  # noqa: BLE001 — an exception that cannot travel
        return None, tb


def raise_remote(payload: Tuple[Optional[bytes], str], where: str):
    """Raise what a replica reported: the deadline and back-pressure
    errors as themselves, anything else as a :class:`ReplicaError`."""
    exc_bytes, tb = payload
    exc = None
    if exc_bytes is not None:
        try:
            exc = pickle.loads(exc_bytes)
        except Exception:  # noqa: BLE001 — its class is not importable here
            exc = None
    if isinstance(exc, (serve_context.DeadlineExceededError,
                        BackPressureError)):
        raise exc
    raise ReplicaError(f"{where} raised:\n{tb}", exc)


class _Conn:
    """A server-side connection whose sends and close share one lock."""

    def __init__(self, conn):
        self.conn = conn
        self.lock = threading.Lock()

    def send(self, msg: Any) -> bool:
        data = pickle.dumps(msg)
        with self.lock:
            if self.conn is None:
                return False
            try:
                self.conn.send_bytes(data)
                return True
            except (OSError, ValueError):
                return False

    def close(self) -> None:
        with self.lock:
            if self.conn is not None:
                self.conn.close()
                self.conn = None


class _ReplicaServer:
    """The replica process's listener: one thread a connection, a FIFO
    queue in front of ``max_ongoing`` running requests."""

    def __init__(self, actor: ReplicaActor, listener, max_ongoing: int,
                 spill_dir: str, replica_id: str, card: Optional[int]):
        self.actor = actor
        self.card = card
        self.listener = listener
        self.max_ongoing = max(1, int(max_ongoing))
        self.spill_dir = spill_dir
        self.replica_id = replica_id
        self.cv = threading.Condition()
        self.running = 0
        self.queue: "collections.deque" = collections.deque()
        self.n_spilled = 0

    def serve_forever(self) -> None:
        # The listener stays open to the process's end (os._exit), so an
        # error here is one connection's: a caller that went away during
        # the authentication handshake raises an OSError out of accept().
        while True:
            try:
                conn = self.listener.accept()
            except OSError:
                time.sleep(0.001)  # no busy loop on a persistent error
                continue
            except Exception:  # noqa: BLE001 — a failed handshake
                continue
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True, name="replica-call").start()

    # -------------------------------------------------------------- a turn

    def _enter(self, cancel: serve_context.Cancel,
               deadline_ts: Optional[float]) -> bool:
        """Wait for this request's turn (FIFO, fewer than max_ongoing
        running). False where it was cancelled or its deadline passed
        first."""
        token = object()
        with self.cv:
            self.queue.append(token)
            self.actor.waiting = len(self.queue)
            try:
                while True:
                    if (self.queue[0] is token
                            and self.running < self.max_ongoing):
                        self.queue.popleft()
                        self.running += 1
                        return True
                    if cancel.event.is_set():
                        return False
                    wait = 0.1
                    if deadline_ts is not None:
                        left = deadline_ts - time.time()
                        if left <= 0:
                            return False
                        wait = min(wait, left)
                    self.cv.wait(wait)
            finally:
                if token in self.queue:
                    self.queue.remove(token)
                self.actor.waiting = len(self.queue)
                self.cv.notify_all()

    def _leave(self) -> None:
        with self.cv:
            self.running -= 1
            self.cv.notify_all()

    # --------------------------------------------------------- a connection

    def _watch(self, conn: _Conn, raw, cancel: serve_context.Cancel) -> None:
        """Read the caller's side until it closes: any message (a cancel)
        or the close cancels the request. This thread owns the close."""
        try:
            while True:
                raw.recv_bytes()
                cancel.set()
        except (EOFError, OSError):
            cancel.set()
        finally:
            conn.close()

    def _result(self, value: Any) -> Any:
        if _array_bytes(value) < SPILL_BYTES:
            return value
        t = time.perf_counter()
        with self.cv:
            self.n_spilled += 1
            n = self.n_spilled
        path = os.path.join(self.spill_dir, f"{self.replica_id}-{n}.out")
        spilled = procs.Spilled(path, value, tensors=True)
        with self.cv:
            m = self.actor.meter
            m["spill_files"] = m.get("spill_files", 0) + 1
            m["spill_bytes"] = m.get("spill_bytes", 0) + sum(spilled.sizes)
            m["spill_s"] = m.get("spill_s", 0.0) + time.perf_counter() - t
        return spilled

    def _handle(self, raw) -> None:
        conn = _Conn(raw)
        try:
            kind, method, args, kwargs, meta = pickle.loads(raw.recv_bytes())
        except Exception:  # noqa: BLE001 — nothing to answer
            conn.close()
            return
        if self.card is not None:
            # CUDA's current card is per thread: user code run here (a
            # prefill, an engine submit) lands on the replica's card.
            import torch

            try:
                torch.cuda.set_device(self.card)
            except Exception as e:  # noqa: BLE001 — to the caller
                conn.send(("err", error_payload(e)))
                conn.close()
                return
        if kind == "actor":
            try:
                conn.send(("ok", self._result(
                    getattr(self.actor, method)(*args, **kwargs))))
            except Exception as e:  # noqa: BLE001 — to the caller
                conn.send(("err", error_payload(e)))
            finally:
                conn.close()
            return
        cancel = serve_context.Cancel()
        threading.Thread(target=self._watch, args=(conn, raw, cancel),
                         daemon=True, name="replica-watch").start()
        deadline_ts = meta.get("deadline_ts")
        t_queue = time.monotonic()
        if not self._enter(cancel, deadline_ts):
            if not cancel.event.is_set():
                conn.send(("err", error_payload(
                    serve_context.DeadlineExceededError(
                        "request deadline passed while queued on the "
                        "replica"))))
            return
        meta = dict(meta, replica_queue_s=time.monotonic() - t_queue)
        try:
            if kind == "request":
                value = self.actor.handle_request(method, args, kwargs,
                                                  cancel=cancel, **meta)
                conn.send(("ok", self._result(value)))
                return
            gen = self.actor.handle_request_streaming(
                method, args, kwargs, cancel=cancel, **meta)
            try:
                for item in gen:
                    if not conn.send(("item", item)) or cancel.event.is_set():
                        return
                conn.send(("end", None))
            finally:
                gen.close()
        except Exception as e:  # noqa: BLE001 — to the caller
            conn.send(("err", error_payload(e)))
        finally:
            self._leave()


def replica_main(conn, payload: bytes, card: Optional[int],
                 num_threads: int, address: str, spill_dir: str,
                 replica_id: str, max_ongoing: int,
                 controller_address: str, environ: Dict[str, str]) -> None:
    """A replica process: take the driver's environment of the moment it
    was asked for (``environ``; a fork server's is older), take the card
    (or set the CPU threads), build the :class:`ReplicaActor` from the
    payload, listen on ``address``, answer ``(0, "ready", {...})`` on the
    pipe (or ``(0, "err", traceback)`` and leave), then serve until the
    controller sends None or goes away."""
    t_main = time.time()
    os.environ.clear()
    os.environ.update(environ)
    if card is not None:
        procs.take_card(card)
    else:
        os.environ["OMP_NUM_THREADS"] = str(num_threads)
    from ..core import sink
    from . import controller

    controller.set_address(controller_address)
    sink.set_route(address=controller_address)
    t = time.perf_counter()
    try:
        torch = sys.modules.get("torch")
        if card is None and torch is not None:
            torch.set_num_threads(num_threads)
        fc, args, kwargs, user_config = pickle.loads(payload)
        actor = ReplicaActor(fc, args, kwargs, user_config)
        listener = listen(address)
    except BaseException:  # noqa: BLE001 — reported to the controller
        conn.send_bytes(pickle.dumps((0, "err", traceback.format_exc())))
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    init_s = time.perf_counter() - t
    actor.meter.update({"replica_id": replica_id, "card": card,
                        "t_main": t_main, "init_s": init_s})
    server = _ReplicaServer(actor, listener, max_ongoing, spill_dir,
                            replica_id, card)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="replica-listener").start()
    conn.send_bytes(pickle.dumps((0, "ready", {
        "pid": os.getpid(), "init_s": init_s, "t_main": t_main,
        "t_ready": time.time()})))
    try:
        conn.recv_bytes()  # None: leave
    except (EOFError, OSError):
        pass  # the controller's process is gone
    actor.prepare_shutdown()
    final_flush()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def final_flush(timeout: float = 1.0) -> None:
    """Ship what this process's shipper (spans, ledger records, events)
    and metrics aggregator still buffer, each giving up after about
    ``timeout`` (os._exit skips atexit)."""
    from ..core import sink
    from ..util import metrics

    sink.flush(timeout=timeout)
    metrics._aggregator.flush(final=True)


# ------------------------------------------------------- the calling side


def load_value(value: Any) -> Tuple[Any, int, float]:
    """A reply's value with its file read back: (value, file bytes, read
    seconds)."""
    if not isinstance(value, procs.Spilled):
        return value, 0, 0.0
    t = time.perf_counter()
    nbytes = sum(value.sizes)
    return value.load(), nbytes, time.perf_counter() - t


class ReplicaClient:
    """One replica's address and the calls to it. Picklable: it goes to
    replica processes inside routers and as arguments (a prefix pull
    names its holder)."""

    def __init__(self, replica_id: str, address: str, deployment: str,
                 pid: Optional[int] = None, card: Optional[int] = None):
        self.replica_id = replica_id
        self.address = address
        self.deployment = deployment
        self.pid = pid
        self.card = card

    def __repr__(self) -> str:
        return f"ReplicaClient({self.replica_id}, pid={self.pid})"

    def open(self, kind: str, method: str, args: Tuple, kwargs: Dict,
             meta: Dict[str, Any]):
        """Connect and send one call; the connection carries its reply.
        Raises ReplicaDiedError where the replica cannot be reached (and
        what pickling raises, before connecting, for arguments that
        cannot travel)."""
        data = pickle.dumps((kind, method, tuple(args), kwargs, meta))
        try:
            conn = connect(self.address)
        except (OSError, EOFError) as e:
            raise ReplicaDiedError(
                f"replica {self.replica_id} cannot be reached: {e}") from e
        try:
            conn.send_bytes(data)
        except (OSError, EOFError) as e:
            conn.close()
            raise ReplicaDiedError(
                f"replica {self.replica_id} went away: {e}") from e
        return conn

    def call(self, method: str, *args, timeout: Optional[float] = 30.0,
             **kwargs) -> Any:
        """A replica-level method (``stats``, ``queue_len``,
        ``check_health``, ``handle_request``, ...), outside the request
        queue."""
        conn = self.open("actor", method, args, kwargs, {})
        try:
            status, value = read_reply(conn, timeout, self.replica_id)
        finally:
            conn.close()
        if status == "err":
            raise_remote(value, f"{self.deployment} replica "
                                f"{self.replica_id}: {method}")
        return load_value(value)[0]

    def handle_request(self, method: str, args: Tuple = (),
                       kwargs: Optional[Dict] = None,
                       timeout: Optional[float] = 30.0) -> Any:
        return self.call("handle_request", method, tuple(args),
                         kwargs or {}, timeout=timeout)


def read_reply(conn, timeout: Optional[float], replica_id: str
               ) -> Tuple[str, Any]:
    """One message ``(status, value)`` off a call's connection: raises
    TimeoutError where none came within ``timeout`` and
    ReplicaDiedError where the replica went away."""
    try:
        data = conn.recv_bytes() if conn.poll(timeout) else None
    except (EOFError, OSError) as e:
        raise ReplicaDiedError(
            f"replica {replica_id} died before it answered ({e!r})") from e
    if data is None:
        raise TimeoutError(f"replica {replica_id} did not answer within "
                           f"{timeout:g} s")
    return pickle.loads(data)
