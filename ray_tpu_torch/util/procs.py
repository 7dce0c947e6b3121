"""Worker processes: the core that the Train layer's workers, the data
layer's pool workers, RLlib's actors, Tune's trials and the core's actors
and task workers (``core/worker.py``) share.

Each is a process of one host, spawned by ``multiprocessing`` or forked
from its fork server (a fresh process that never touches CUDA: a forked
child of a process that did cannot use it), one card each where it runs
on the card, called over a pipe with numbered pickled messages and
watched through its sentinel:

- the calling process holds a :class:`Worker` for each: it sends
  ``(seq, method, args, kwargs)`` and :func:`wait` reads the replies
  ``(seq, "ok", result)`` or ``(seq, "err", traceback)`` of every worker
  and sees every worker that died;
- the worker process runs :func:`serve`: a reader thread takes the calls
  off the pipe while the main thread builds the object that answers
  them, says it is ready (seq 0), and then runs the calls in order. So a
  worker receives its next call while it runs one;
- :func:`stop` asks a set of workers to leave and makes sure none is
  left;
- a worker may also ask the calling process things over the same pipe
  (``serve``'s ``uplink``: the core's tasks and actors submit, get and
  put through their driver), the answers routed to the thread that
  waits for them;
- a call that must hold the worker's one call thread past its own answer
  (a compiled DAG's resident loop) answers itself through the worker's
  :class:`Mailbox` and takes the calls meant for it from there, while the
  others wait in order;
- large arrays leave the pipe: a call's argument or result wrapped in a
  :class:`Spilled` travels as a file, the pipe carrying its name
  (:func:`unspill` reads the arguments back on the worker's side). Through
  the pipe itself a 154 MB block arrived in 200 KB reads, each waiting for
  the interpreter lock held by the worker's other thread, at 15 MB/s on
  an H100's host.

Sequence numbers are unique in the calling process, so replies of many
workers can be kept in one table. This module imports nothing of torch
at the top: a pool worker that runs numpy UDFs on the CPU never loads
it.
"""
from __future__ import annotations

import collections
import itertools
import multiprocessing.connection as mpc
import os
import pickle
import queue
import sys
import threading
import time
import traceback
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

# Seconds ``stop`` waits for a worker to leave on its own before it
# terminates it, and then kills it.
JOIN_TIMEOUT_S = 10.0
TERMINATE_TIMEOUT_S = 5.0

_SEQ = itertools.count(1)

# Connections a listener queues before it accepts them. Past its queue a
# connect either waits or, on some kernels, fails at once with EAGAIN:
# ``connect`` retries that for a while (the listener is alive, only busy).
LISTEN_BACKLOG = 128


def listen(address: str):
    """An AF_UNIX listener on ``address``, authenticated with this
    process's authkey (which spawned and forked children share)."""
    import multiprocessing

    return mpc.Listener(
        address, family="AF_UNIX",
        authkey=bytes(multiprocessing.current_process().authkey),
        backlog=LISTEN_BACKLOG)


def socket_address(directory: str, name: str) -> str:
    """An AF_UNIX address for ``name``: a file in ``directory``, or, where
    that path is too long for a socket, a name in Linux's abstract
    namespace."""
    path = os.path.join(directory, name)
    if len(path.encode()) <= 100:
        return path
    return "\0" + os.path.basename(directory) + "-" + name


def connect(address: str, retry_s: float):
    """An authenticated connection (this process's authkey, which spawned
    and forked children share) to the AF_UNIX listener on ``address``,
    retried for up to ``retry_s`` while its queue is full: past its queue
    a connect either waits or, on some kernels, fails at once with EAGAIN
    (the listener is alive, only busy)."""
    import multiprocessing

    deadline = time.monotonic() + retry_s
    delay = 0.001
    while True:
        try:
            return mpc.Client(
                address, family="AF_UNIX",
                authkey=bytes(multiprocessing.current_process().authkey))
        except BlockingIOError:
            if time.monotonic() > deadline:
                raise
            time.sleep(delay)
            delay = min(2 * delay, 0.05)


def take_card(card: int) -> None:
    """Make ``card`` this process's CUDA card, before any CUDA work:
    ``device.py`` and ``MeshBootstrap`` read ``LOCAL_RANK``."""
    import torch

    os.environ["LOCAL_RANK"] = str(card)
    torch.cuda.set_device(card)


def dumps(obj: Any, what: str, where: str, hint: str) -> bytes:
    """``obj`` pickled for a worker process. Functions and classes go by
    plain pickle, by reference: one that cannot raises here, in the
    calling process, naming ``what`` and why."""
    try:
        return pickle.dumps(obj)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"{what} cannot be sent to the {where} ({e}). Functions and "
            f"classes go by pickle, by reference: {hint}") from e


def _tensor_from_numpy(arr, dtype: str):
    import torch

    t = torch.from_numpy(arr)
    return t.view(getattr(torch, dtype)) if dtype else t


class _TensorPickler(pickle.Pickler):
    """Pickles a CPU tensor (no grad) as its numpy view, so its bytes go
    out of band like an array's; bfloat16, which numpy lacks, as int16
    bits."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is None or type(obj) is not torch.Tensor
                or obj.device.type != "cpu" or obj.requires_grad):
            return NotImplemented
        t = obj.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return _tensor_from_numpy, (t.view(torch.int16).numpy(),
                                        "bfloat16")
        return _tensor_from_numpy, (t.numpy(), "")


def _dumps_oob(obj: Any, bufs: List[pickle.PickleBuffer],
               tensors: bool) -> bytes:
    if not tensors:
        return pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    import io as _io

    f = _io.BytesIO()
    _TensorPickler(f, protocol=5, buffer_callback=bufs.append).dump(obj)
    return f.getvalue()


class Spilled:
    """An object written to a file, for the other side of a pipe: its
    arrays' bytes go out of band (pickle protocol 5) in one write, and
    come back in one read into one buffer that the arrays then share; the
    pipe carries this handle. The reader removes the file. With
    ``tensors``, CPU tensors go out of band too (as numpy views: without
    their autograd state, each its own contiguous copy)."""

    def __init__(self, path: str, obj: Any, tensors: bool = False,
                 _parts: Optional[Tuple[bytes, List[memoryview]]] = None):
        if _parts is None:
            bufs: List[pickle.PickleBuffer] = []
            meta = _dumps_oob(obj, bufs, tensors)
            _parts = meta, [b.raw() for b in bufs]
        self.meta, raws = _parts
        self.sizes = [r.nbytes for r in raws]
        self.path = path
        with open(path, "wb", buffering=0) as f:
            for r in raws:
                done = 0
                while done < r.nbytes:
                    done += f.write(r[done:])

    def load(self) -> Any:
        buf = memoryview(bytearray(sum(self.sizes)))
        with open(self.path, "rb", buffering=0) as f:
            done = 0
            while done < len(buf):
                n = f.readinto(buf[done:])
                if not n:
                    raise EOFError(f"{self.path}: short spill file")
                done += n
        os.unlink(self.path)
        views, off = [], 0
        for n in self.sizes:
            views.append(buf[off:off + n])
            off += n
        return pickle.loads(self.meta, buffers=views)

    def discard(self) -> None:
        """Remove the file unread (a reply nobody waits for)."""
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def unspill(method: str, args: Tuple) -> Tuple:
    """A call's arguments with each :class:`Spilled` read back: the
    ``load`` of :func:`serve`."""
    return tuple(a.load() if isinstance(a, Spilled) else a for a in args)


def stop_fork_server() -> None:
    """Stop multiprocessing's fork server (started on first use and kept
    to the process's end), so the caller leaves no process behind."""
    from multiprocessing import forkserver

    server = forkserver._forkserver
    stop = getattr(server, "_stop", None)
    if stop is None:
        # A Python whose fork server has no _stop (a private method of
        # CPython 3.8 on): the server then outlives its users; say so.
        import logging

        logging.getLogger(__name__).warning(
            "multiprocessing's fork server has no _stop on this Python: "
            "its process (pid %s) lives on",
            getattr(server, "_forkserver_pid", None))
        return
    stop()


# ------------------------------------------------------ the calling process


class Worker:
    """The calling process's handle on one worker process: ``target(conn,
    *args)`` runs there, and ``target`` ends in :func:`serve`.
    ``encode(msg)`` pickles a call (it may raise, saying why a call
    cannot travel)."""

    def __init__(self, ctx, target: Callable, args: Sequence, name: str,
                 encode: Callable[[Any], bytes] = pickle.dumps):
        self.conn, child = ctx.Pipe()
        self.t_start = time.time()
        self.proc = ctx.Process(target=target, args=(child, *args),
                                name=name)
        self.proc.start()
        child.close()
        self.pid = self.proc.pid
        self.encode = encode
        # What the worker sent once its serving object was built, or the
        # traceback of the build that raised.
        self.ready: Optional[Dict[str, Any]] = None
        self.ready_error: Optional[str] = None
        # Seconds spent reading and unpickling replies.
        self.recv_s = 0.0

    def send(self, method: str, args: Sequence = (),
             kwargs: Optional[Dict[str, Any]] = None) -> int:
        """Number and send a call; return its number. A worker already
        dead drops it: its sentinel reports the death."""
        seq = next(_SEQ)
        data = self.encode((seq, method, tuple(args), kwargs or {}))
        try:
            self.conn.send_bytes(data)
        except (BrokenPipeError, ConnectionResetError):
            pass
        return seq

    def read(self) -> Optional[Tuple[int, str, Any]]:
        """One reply, ``(seq, status, value)``, or None where none is
        waiting or the pipe is closed."""
        try:
            if not self.conn.poll(0):
                return None
            t = time.perf_counter()
            reply = pickle.loads(self.conn.recv_bytes())
        except (EOFError, OSError):
            return None
        self.recv_s += time.perf_counter() - t
        return reply

    def exitcode(self) -> Optional[int]:
        self.proc.join(timeout=1.0)
        return self.proc.exitcode


Reply = Tuple[Worker, int, str, Any]


def wait(workers: Sequence[Worker], timeout: Optional[float] = None
         ) -> Tuple[List[Reply], List[Worker]]:
    """Wait until a worker replies or dies, or ``timeout`` passes. Return
    the replies read, as ``(worker, seq, status, value)``, and the
    workers whose process ended, their pipes read out first. A ready
    reply (seq 0) is kept on its worker's handle and not returned."""
    by_conn = {w.conn: w for w in workers}
    by_sentinel = {w.proc.sentinel: w for w in workers}
    ready = mpc.wait(list(by_conn) + list(by_sentinel), timeout)
    replies: List[Reply] = []

    def take(w: Worker) -> bool:
        reply = w.read()
        if reply is None:
            return False
        seq, status, value = reply
        if seq == 0:
            if status == "err":
                w.ready_error = value
            else:
                w.ready = value
        else:
            replies.append((w, seq, status, value))
        return True

    for obj in ready:
        if obj in by_conn:
            take(by_conn[obj])
    dead = [by_sentinel[o] for o in ready if o in by_sentinel]
    for w in dead:
        while take(w):
            pass
        w.proc.join(timeout=1.0)
    return replies, dead


def stop(workers: Iterable[Worker]) -> None:
    """Ask every worker to leave (a pickled ``None``); join each with a
    bounded timeout, then terminate it, then kill it; close the pipes. No
    process is left behind."""
    workers = list(workers)
    for w in workers:
        try:
            w.conn.send_bytes(pickle.dumps(None))
        except (OSError, ValueError):
            pass  # already gone
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for w in workers:
        w.proc.join(max(0.0, deadline - time.monotonic()))
    for w in workers:
        if w.proc.is_alive():
            w.proc.terminate()
            w.proc.join(TERMINATE_TIMEOUT_S)
        if w.proc.is_alive():
            w.proc.kill()
            w.proc.join()
        w.proc.close()
        w.conn.close()


# ---------------------------------------------------------- the worker side

# What a call returns that answered itself through its :class:`Mailbox`:
# :func:`serve` sends no second answer.
ANSWERED = object()


class Mailbox:
    """The calls a worker process has received and not yet run, for a call
    that holds the process's one call thread past its own answer (a
    compiled DAG's resident loop, ``dag/resident.py``): it answers its own
    call early (:meth:`answer`), takes the calls meant for it while it
    runs (:meth:`take`), and leaves every other call, in order, to
    :func:`serve`, which runs them once it returns."""

    def __init__(self, inbox: "queue.Queue[Any]",
                 answer: Callable[[int, str, Any], None]):
        self._inbox = inbox
        self._answer = answer
        self.deferred: "collections.deque" = collections.deque()
        self.seq = 0  # the number of the call running now
        self.leaving = False  # the caller asked this process to leave

    def answer(self, seq: int, status: str, value: Any) -> None:
        self._answer(seq, status, value)

    def take(self, match: Callable[[Tuple], bool], timeout: float = 0.0
             ) -> Optional[Tuple[int, str, Tuple, Dict[str, Any]]]:
        """The first waiting call ``(seq, method, args, kwargs)`` that
        ``match`` takes, waiting up to ``timeout`` seconds for one; None
        where none came. The calls passed over stay queued for
        :func:`serve`."""
        for i, msg in enumerate(self.deferred):
            if msg is not None and match(msg):
                del self.deferred[i]
                return msg
        deadline = time.monotonic() + timeout
        while True:
            try:
                msg = self._inbox.get(
                    timeout=max(0.0, deadline - time.monotonic())) \
                    if timeout > 0 else self._inbox.get_nowait()
            except queue.Empty:
                return None
            if msg is not None and match(msg):
                return msg
            if msg is None:
                self.leaving = True
            self.deferred.append(msg)

    def _next(self, timeout: Optional[float]) -> Any:
        if self.deferred:
            return self.deferred.popleft()
        return self._inbox.get(timeout=timeout)


def serve(conn, build: Callable[[], Any],
          ready: Optional[Dict[str, Any]] = None,
          load: Optional[Callable[[str, Tuple], Tuple]] = None,
          wrap: Optional[Callable[[int, str, Any], Any]] = None,
          io: Optional[Dict[str, float]] = None,
          dumps: Callable[[Any], bytes] = pickle.dumps,
          on_mailbox: Optional[Callable[[Mailbox], None]] = None,
          idle: Optional[Callable[[], None]] = None,
          idle_s: float = 0.25,
          loads: Callable[[bytes], Any] = pickle.loads,
          uplink: Optional[Callable[[Callable[[Any], None]],
                                    Callable[[Any], bool]]] = None) -> None:
    """A worker process's loop, to the end of the process.

    A reader thread takes the calls off ``conn`` (``load(method, args)``
    turns their arguments into what the method takes, there) while this
    thread builds the serving object with ``build()`` and answers ``(0,
    "ready", {**ready, "pid", "init_s", "t_ready"})`` (``t_ready``: the
    wall clock of the answer), or ``(0, "err", traceback)`` and leaves.
    Then it runs ``getattr(obj, method)(*args, **kwargs)`` for each call
    in order and answers ``(seq, "ok", wrap(seq, method,
    result))`` or ``(seq, "err", traceback)``, until the calling process
    sends None, after the call running then, or goes away, at once: no
    one will read an answer, and a worker whose caller was killed must
    not live on (a Tune trial's Train workers, say, whose trial process
    was). ``io`` accumulates the seconds spent reading (``recv_s``) and
    answering (``send_s``); ``dumps`` pickles the answers. Where
    ``on_mailbox`` is given it receives the process's :class:`Mailbox`
    once the object is built: a call that returns :data:`ANSWERED`
    answered itself through it. ``idle()`` runs between calls, at most
    every ``idle_s`` seconds, and so when calls stop. ``loads``
    unpickles what comes over ``conn``. Where ``uplink`` is given, this
    process also asks the calling process things over the same pipe:
    ``uplink(post)`` runs once, before the reader starts, and gets
    ``post(msg)``, which sends a message up (under the lock the answers
    take); it returns ``route(msg)``, which the reader offers every
    message first: one it takes (the answer to a request, for the thread
    that waits on it) never reaches the calls. The process leaves with
    ``os._exit``: the interpreter's own teardown (torch's modules, a
    thread left behind) would only cost the calling process its join."""
    io = io if io is not None else {}
    io.setdefault("recv_s", 0.0)
    io.setdefault("send_s", 0.0)
    inbox: "queue.Queue[Any]" = queue.Queue()
    send_lock = threading.Lock()

    def post(msg: Any) -> None:
        data = dumps(msg)
        with send_lock:
            conn.send_bytes(data)

    route = uplink(post) if uplink is not None else None

    def read() -> None:
        while True:
            try:
                conn.poll(None)  # waiting for the caller is not transfer
                t = time.perf_counter()
                msg = loads(conn.recv_bytes())
            except (EOFError, OSError):
                # The calling process is gone: leave now, whatever this
                # process's main thread is running.
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(0)
            except Exception:  # noqa: BLE001 — a call with no number
                # A call that does not unpickle here cannot be answered:
                # the worker leaves, and its sentinel tells the caller.
                traceback.print_exc()
                msg = None
            if msg is None:
                inbox.put(None)
                return
            if route is not None and route(msg):
                msg = None
                continue
            seq, method, args, kwargs = msg
            if load is not None:
                try:
                    args = load(method, args)
                except Exception:  # noqa: BLE001 — the call's error
                    method, args = None, traceback.format_exc()
            io["recv_s"] += time.perf_counter() - t
            inbox.put((seq, method, args, kwargs))
            # Hold no call while waiting for the next: a ref in it would
            # stay borrowed (``core/api.py``).
            msg = args = kwargs = None

    def answer(seq: int, status: str, value: Any) -> None:
        t = time.perf_counter()
        try:
            data = dumps((seq, status, value))
        except Exception:  # noqa: BLE001 — a result that cannot travel
            data = pickle.dumps((seq, "err", traceback.format_exc()))
        with send_lock:
            conn.send_bytes(data)
        io["send_s"] += time.perf_counter() - t

    mailbox = Mailbox(inbox, answer)
    threading.Thread(target=read, name="worker-reader", daemon=True).start()
    try:
        t = time.perf_counter()
        try:
            obj = build()
        except Exception:  # noqa: BLE001 — reported to the calling process
            answer(0, "err", traceback.format_exc())
            obj = None
        if obj is not None:
            if on_mailbox is not None:
                on_mailbox(mailbox)
            answer(0, "ready", {**(ready or {}), "pid": os.getpid(),
                                "init_s": time.perf_counter() - t,
                                "t_ready": time.time()})
        last_idle = time.monotonic()
        while obj is not None:
            if idle is not None and time.monotonic() - last_idle >= idle_s:
                idle()
                last_idle = time.monotonic()
            try:
                msg = mailbox._next(idle_s if idle is not None else None)
            except queue.Empty:
                continue
            if msg is None:
                break
            seq, method, args, kwargs = msg
            msg = None
            if method is None:  # its arguments did not load
                answer(seq, "err", args)
                continue
            mailbox.seq = seq
            try:
                value = getattr(obj, method)(*args, **kwargs)
                args = kwargs = None  # nothing of a call outlives it
                if value is ANSWERED:
                    continue
                if wrap is not None:
                    t = time.perf_counter()
                    value = wrap(seq, method, value)
                    io["send_s"] += time.perf_counter() - t
            except Exception:  # noqa: BLE001 — reported to the caller
                args = kwargs = None
                answer(seq, "err", traceback.format_exc())
                continue
            answer(seq, "ok", value)
            value = None
    except (BrokenPipeError, ConnectionResetError):
        pass  # the calling process is gone
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
