"""``multiprocessing.Pool``'s API over the core's tasks (counterpart of
the JAX package's ``util/multiprocessing.py``): map, map_async, starmap,
imap, imap_unordered, apply, apply_async and :class:`AsyncResult`.
``processes`` bounds the tasks in flight; the core's CPUs are the pool.

Divergence by design: the JAX package builds a nested ``@remote`` a call
and a lambda for ``kwds``, which travel by value. The port sends
functions by reference (``core/serialization.py``), so every call runs
one module-level task, :func:`_pool_call`, with ``(func, initializer,
initargs, args)``; a task worker runs a pool's initializer once (a
global of the worker marks it); ``kwds`` bind through
``functools.partial``. ``func`` and ``initializer`` must be module-level:
a lambda or a nested function raises ``TypeError`` naming itself before
any task is submitted.
"""
from __future__ import annotations

import functools
import pickle
from typing import Any, Callable, Iterable, List, Optional

from ..core import api
from . import procs

# The initializers this task worker has run: (initializer, initargs),
# pickled.
_INITIALISED: set = set()


@api.remote
def _pool_call(func: Callable, initializer: Optional[Callable],
               initargs: tuple, args: tuple) -> Any:
    if initializer is not None:
        key = pickle.dumps((initializer, initargs))
        if key not in _INITIALISED:
            initializer(*initargs)
            _INITIALISED.add(key)
    return func(*args)


def _sendable(fn: Callable, what: str) -> None:
    name = getattr(fn, "__qualname__", repr(fn))
    procs.dumps(fn, f"the Pool's {what} {name}", "task workers",
                "define it at module level, not inside a function or as a "
                "lambda")


class AsyncResult:
    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        out = api.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        api.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = api.wait(self._refs, num_returns=len(self._refs),
                            timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:  # noqa: BLE001 — not ready, or it raised
            return False


class Pool:
    """A process pool's semantics over the core's tasks: ``processes``
    bounds the tasks in flight."""

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), **_ignored):
        if not api.is_initialized():
            api.init()
        if initializer is not None:
            _sendable(initializer, "initializer")
        self._processes = processes or int(
            api.cluster_resources().get("CPU", 1))
        self._initializer = initializer
        self._initargs = tuple(initargs)
        self._closed = False

    def _chunked_submit(self, func, iterables) -> List[Any]:
        if self._closed:
            raise ValueError("Pool not running")
        _sendable(func, "function")
        refs: List[Any] = []
        window: List[Any] = []
        for args in iterables:
            if len(window) >= self._processes:
                _, window = api.wait(window, num_returns=1)
            ref = _pool_call.remote(func, self._initializer, self._initargs,
                                    tuple(args))
            refs.append(ref)
            window.append(ref)
        return refs

    # ------------------------------------------------------------------ api

    def apply(self, func, args=(), kwds=None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args=(), kwds=None) -> AsyncResult:
        bound = functools.partial(func, **kwds) if kwds else func
        refs = self._chunked_submit(bound, [tuple(args)])
        return AsyncResult(refs, single=True)

    def map(self, func, iterable) -> List[Any]:
        return self.map_async(func, iterable).get()

    def map_async(self, func, iterable) -> AsyncResult:
        refs = self._chunked_submit(func, ((x,) for x in iterable))
        return AsyncResult(refs, single=False)

    def starmap(self, func, iterable) -> List[Any]:
        refs = self._chunked_submit(func, (tuple(a) for a in iterable))
        return AsyncResult(refs, single=False).get()

    def imap(self, func, iterable) -> Iterable[Any]:
        refs = self._chunked_submit(func, ((x,) for x in iterable))
        for ref in refs:
            yield api.get(ref)

    def imap_unordered(self, func, iterable) -> Iterable[Any]:
        refs = self._chunked_submit(func, ((x,) for x in iterable))
        pending = list(refs)
        while pending:
            ready, pending = api.wait(pending, num_returns=1)
            yield api.get(ready[0])

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
