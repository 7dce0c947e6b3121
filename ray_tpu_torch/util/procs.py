"""Spawned worker processes: the core that the Train layer's workers and
the data layer's pool workers share.

Both are processes of one host started with ``multiprocessing``'s spawn
method (CUDA cannot be used in a forked child), one card each where they
run on the card, called over a pipe with numbered pickled messages and
watched through their sentinels:

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


class Spilled:
    """An object written to a file, for the other side of a pipe: its
    arrays' bytes go out of band (pickle protocol 5) in one write, and
    come back in one read into one buffer that the arrays then share; the
    pipe carries this handle. The reader removes the file."""

    def __init__(self, path: str, obj: Any):
        bufs: List[pickle.PickleBuffer] = []
        self.meta = pickle.dumps(obj, protocol=5,
                                 buffer_callback=bufs.append)
        raws = [b.raw() for b in bufs]
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


def serve(conn, build: Callable[[], Any],
          ready: Optional[Dict[str, Any]] = None,
          load: Optional[Callable[[str, Tuple], Tuple]] = None,
          wrap: Optional[Callable[[int, str, Any], Any]] = None,
          io: Optional[Dict[str, float]] = None) -> None:
    """A worker process's loop, to the end of the process.

    A reader thread takes the calls off ``conn`` (``load(method, args)``
    turns their arguments into what the method takes, there) while this
    thread builds the serving object with ``build()`` and answers ``(0,
    "ready", {**ready, "pid", "init_s", "t_ready"})`` (``t_ready``: the
    wall clock of the answer), or ``(0, "err", traceback)`` and leaves.
    Then it runs ``getattr(obj, method)(*args, **kwargs)`` for each call
    in order and answers ``(seq, "ok", wrap(seq, method,
    result))`` or ``(seq, "err", traceback)``, until the calling process
    sends None or goes away. ``io`` accumulates the seconds spent reading
    (``recv_s``) and answering (``send_s``). The process then leaves at
    once: the interpreter's own teardown (torch's modules, a thread left
    behind) would only cost the calling process its join."""
    io = io if io is not None else {}
    io.setdefault("recv_s", 0.0)
    io.setdefault("send_s", 0.0)
    inbox: "queue.Queue[Any]" = queue.Queue()

    def read() -> None:
        while True:
            try:
                conn.poll(None)  # waiting for the caller is not transfer
                t = time.perf_counter()
                msg = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                msg = None  # the calling process is gone
            except Exception:  # noqa: BLE001 — a call with no number
                # A call that does not unpickle here cannot be answered:
                # the worker leaves, and its sentinel tells the caller.
                traceback.print_exc()
                msg = None
            if msg is None:
                inbox.put(None)
                return
            seq, method, args, kwargs = msg
            if load is not None:
                try:
                    args = load(method, args)
                except Exception:  # noqa: BLE001 — the call's error
                    method, args = None, traceback.format_exc()
            io["recv_s"] += time.perf_counter() - t
            inbox.put((seq, method, args, kwargs))

    def answer(seq: int, status: str, value: Any) -> None:
        t = time.perf_counter()
        try:
            data = pickle.dumps((seq, status, value))
        except Exception:  # noqa: BLE001 — a result that cannot travel
            data = pickle.dumps((seq, "err", traceback.format_exc()))
        conn.send_bytes(data)
        io["send_s"] += time.perf_counter() - t

    threading.Thread(target=read, name="worker-reader", daemon=True).start()
    try:
        t = time.perf_counter()
        try:
            obj = build()
        except Exception:  # noqa: BLE001 — reported to the calling process
            answer(0, "err", traceback.format_exc())
            obj = None
        if obj is not None:
            answer(0, "ready", {**(ready or {}), "pid": os.getpid(),
                                "init_s": time.perf_counter() - t,
                                "t_ready": time.time()})
        while obj is not None:
            msg = inbox.get()
            if msg is None:
                break
            seq, method, args, kwargs = msg
            if method is None:  # its arguments did not load
                answer(seq, "err", args)
                continue
            try:
                value = getattr(obj, method)(*args, **kwargs)
                if wrap is not None:
                    t = time.perf_counter()
                    value = wrap(seq, method, value)
                    io["send_s"] += time.perf_counter() - t
            except Exception:  # noqa: BLE001 — reported to the caller
                answer(seq, "err", traceback.format_exc())
                continue
            answer(seq, "ok", value)
    except (BrokenPipeError, ConnectionResetError):
        pass  # the calling process is gone
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
