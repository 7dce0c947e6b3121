"""@serve.batch: request coalescing inside a replica (counterpart of the
JAX package's ``serve/batching.py``).

Calls queue until max_batch_size accumulate or batch_wait_timeout_s
elapses, then the wrapped function runs ONCE on the list of requests and
each caller gets its element back. A replica process runs each request
on its own thread (``serve/replica.py``), so concurrent requests meet
here; on the card this turns 4 one-prompt requests into one [4, S]
``generate_ragged``.

Each traced item's dwell in the queue, from its submit to the seal of
its batch, is shipped as a ``serve.batch_seal`` span of its request's
trace (``serve/trace.py``), on this process's monotonic clock.
"""
from __future__ import annotations

import functools
import queue
import threading
import time
import weakref
from typing import Any, Callable, List, Optional

from . import context as serve_context
from . import trace


class _Batcher:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self._queue: "queue.Queue" = queue.Queue()
        # The worker holds only a weakref to this batcher: a bound-method
        # target would keep batcher -> fn -> owner alive forever. With the
        # weakref the owner<->batcher cycle is ordinary GC fodder and the
        # thread exits once the batcher is collected.
        self._thread = threading.Thread(
            target=_batcher_loop, args=(weakref.ref(self),), daemon=True,
            name="serve-batcher")
        self._thread.start()

    def submit(self, item: Any) -> Any:
        # The caller's frame keeps `self` strongly referenced for the
        # duration, so the batcher cannot be collected mid-request. The
        # request deadline rides along so the seal can drop expired items,
        # and the trace's enqueue stamp so it can ship the queue dwell.
        tinfo = None
        if trace.enabled():
            tctx = trace.current_trace_ctx()
            if tctx is not None:
                tinfo = (tctx, time.monotonic(), time.time())
        slot: "queue.Queue" = queue.Queue(1)
        self._queue.put((item, slot, serve_context.get_request_deadline(),
                         tinfo))
        result = slot.get()
        if isinstance(result, _Err):
            raise result.exc
        return result


def _batcher_loop(ref: "weakref.ref[_Batcher]") -> None:
    while True:
        self = ref()
        if self is None:
            return
        q = self._queue
        timeout_s, max_bs = self.timeout_s, self.max_batch_size
        del self  # hold no strong ref (to batcher OR owner) while blocked
        try:
            entry = q.get(timeout=1.0)
        except queue.Empty:
            continue
        # A submitter's frame holds the batcher strongly for the duration
        # of its request, so ref() cannot die between enqueue and here.
        self = ref()
        if self is None:
            return
        fn = self.fn
        del self
        batch = [entry]
        # Coalesce: wait up to timeout_s for more, cap at max size.
        t_end = time.time() + timeout_s
        while len(batch) < max_bs:
            remaining = t_end - time.time()
            if remaining <= 0:
                break
            try:
                batch.append(q.get(timeout=remaining))
            except queue.Empty:
                break
        # Seal-time expiry sweep: an item whose request deadline has
        # already passed gets the typed error instead of a seat in the
        # batch: an expired request never consumes batch capacity.
        now = time.time()
        live = []
        for b in batch:
            dl = b[2]
            if dl is not None and now > dl:
                b[1].put(_Err(serve_context.DeadlineExceededError(
                    "request deadline passed while waiting in batch queue")))
            else:
                live.append(b)
        # Each traced item's dwell between its submit and this seal: the
        # waterfall's "time lost to coalescing" bar.
        seal_mono = time.monotonic()
        for b in batch:
            if b[3] is not None:
                trace.emit_span(
                    "serve.batch_seal", trace_ctx=b[3][0], kind="batch",
                    dwell_s=seal_mono - b[3][1], start_ts=b[3][2],
                    attributes={"batch_size": len(live),
                                "expired": b not in live})
        batch = live
        if not batch:
            del fn
            continue
        items = [b[0] for b in batch]
        try:
            results = fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"batch fn returned {len(results)} results for "
                    f"{len(items)} inputs")
            for b, r in zip(batch, results):
                b[1].put(r)
        except Exception as e:
            for b in batch:
                b[1].put(_Err(e))
        del fn


class _Err:
    def __init__(self, exc: BaseException):
        self.exc = exc


# Guards batcher creation: concurrent FIRST calls would otherwise each get
# a private batcher and nothing would ever coalesce.
_CREATE_LOCK = threading.Lock()

# Fallback batcher store for owners with __slots__ (no instance dict):
# weak-keyed so entries die with the instance.
_weak_state: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _weak_get(owner):
    try:
        return _weak_state.get(owner)
    except TypeError:  # not weakref-able
        return None


def _weak_set(owner, batcher) -> bool:
    try:
        _weak_state[owner] = batcher
        return True
    except TypeError:  # not weakref-able
        return False


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator for replica methods (or functions) taking a list of
    requests. A method's batcher lives on its instance; a function's, or
    a bound method's decorated at run time, on the wrapper."""

    def wrap(fn):
        state: dict = {}
        # Per-instance batchers live ON the instance (attribute keyed by
        # the wrapped method's name): id(owner) keys can be recycled after
        # GC; an instance attribute dies with the instance.
        attr = f"__rtpu_batcher_{fn.__qualname__.replace('.', '_')}"

        @functools.wraps(fn)
        def wrapper(*args):
            # Bound method: args = (self, item); function: (item,)
            if len(args) == 2:
                owner, item = args
                b = (getattr(owner, attr, None) or _weak_get(owner)
                     or state.get(id(owner)))
                if b is None:
                    with _CREATE_LOCK:
                        b = (getattr(owner, attr, None) or _weak_get(owner)
                             or state.get(id(owner)))
                        if b is None:
                            b = _Batcher(lambda items: fn(owner, items),
                                         max_batch_size, batch_wait_timeout_s)
                            try:
                                object.__setattr__(owner, attr, b)
                            except (AttributeError, TypeError):
                                if not _weak_set(owner, b):
                                    state[id(owner)] = b
            else:
                (item,) = args
                b = state.get(None)
                if b is None:
                    with _CREATE_LOCK:
                        b = state.get(None)
                        if b is None:
                            b = state[None] = _Batcher(
                                fn, max_batch_size, batch_wait_timeout_s)
            return b.submit(item)

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
