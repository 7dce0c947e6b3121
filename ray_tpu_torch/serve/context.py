"""Per-request serve context: the deadline that rides the whole path
(counterpart of the JAX package's ``serve/context.py``).

A handle's ``.options(deadline_s=...)`` stamps an ABSOLUTE wall-clock
deadline; every downstream hop (router assign, the replica's queue and
execution, the ``@batch`` seal, the LLM engine's slot wait) reads it from
here, so nested handle composition inherits the caller's budget without
threading kwargs through user code.

The port adds the request's cancellation (:class:`Cancel`, under the
context's ``cancel``): the replica process sets it when the caller
closes the call (a closed stream, a dropped response). User code can
poll :func:`cancelled`, or add a callback to the ``Cancel``, which runs
on the replica's connection thread the moment the cancel arrives (the
LLM deployments free the engine slot there).
"""
from __future__ import annotations

import contextvars
import threading
import time
from typing import Callable, Optional


class DeadlineExceededError(Exception):
    """The request's end-to-end deadline passed at a queue boundary or
    mid-execution; the work was dropped. The JAX package keeps it in its
    control plane (``ray_tpu.core.controller``); the port's serve package
    is its home."""


class Cancel:
    """A request's cancellation: an event, the time it was set
    (monotonic) and the callbacks to run when it is."""

    def __init__(self):
        self.event = threading.Event()
        self.at: Optional[float] = None
        self._lock = threading.Lock()
        self._callbacks = []

    def add(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if not self.event.is_set():
                self._callbacks.append(fn)
                return
        fn()

    def set(self) -> None:
        with self._lock:
            if self.event.is_set():
                return
            self.at = time.monotonic()
            self.event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a callback's own failure
                pass


_request_ctx: "contextvars.ContextVar[Optional[dict]]" = (
    contextvars.ContextVar("serve_request_ctx", default=None))


def set_request_context(*, deadline_ts: Optional[float] = None,
                        start_ts: Optional[float] = None,
                        queue_wait_s: float = 0.0,
                        multiplexed_model_id: str = "",
                        cancel: Optional[Cancel] = None):
    """Install the current request's context; returns a reset token.
    ``start_ts`` (epoch seconds) is when the request entered the system,
    stamped once at the outermost hop and inherited by nested handle
    calls. ``queue_wait_s`` is the time the request had already spent
    upstream, accumulated hop by hop with each process's own monotonic
    clock; latency accounting uses it plus the locally stamped
    ``arrival_mono`` delta, never a difference of epoch stamps."""
    c = {"deadline_ts": deadline_ts, "start_ts": start_ts,
         "queue_wait_s": max(0.0, float(queue_wait_s or 0.0)),
         "arrival_mono": time.monotonic(),
         "multiplexed_model_id": multiplexed_model_id,
         "cancel": cancel}
    return _request_ctx.set(c)


def reset_request_context(token) -> None:
    _request_ctx.reset(token)


def get_request_context() -> Optional[dict]:
    return _request_ctx.get()


def get_request_deadline() -> Optional[float]:
    """Absolute (epoch-seconds) deadline of the active request, or None."""
    c = _request_ctx.get()
    return c.get("deadline_ts") if c else None


def get_request_start() -> Optional[float]:
    """Epoch-seconds arrival time of the active request, or None."""
    c = _request_ctx.get()
    return c.get("start_ts") if c else None


def elapsed_s() -> Optional[float]:
    """Seconds the active request has spent in the system so far:
    upstream queue wait plus the time since it arrived in THIS process.
    None when no request context is installed."""
    c = _request_ctx.get()
    if c is None:
        return None
    return (c.get("queue_wait_s", 0.0)
            + max(0.0, time.monotonic() - c["arrival_mono"]))


def remaining_s(default: Optional[float] = None) -> Optional[float]:
    """Seconds left on the active request's deadline. Expired requests
    return 0.0 (never negative); no deadline returns ``default``."""
    dl = get_request_deadline()
    if dl is None:
        return default
    return max(0.0, dl - time.time())


def expired() -> bool:
    dl = get_request_deadline()
    return dl is not None and time.time() > dl


def cancelled() -> bool:
    """Has the caller closed the active request?"""
    c = _request_ctx.get()
    cancel = c.get("cancel") if c else None
    return cancel is not None and cancel.event.is_set()
