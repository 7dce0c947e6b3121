"""Per-request serving trace plane, RTPU_SERVE_TRACE (counterpart of the
JAX package's ``serve/trace.py``).

Every hop a request crosses (proxy ingress, router assign, replica
execution, ``@batch`` seal, engine slot wait, prefill, KV handoff, the
token stream itself) emits a *hop span* measured on its process's OWN
monotonic clock (wall-clock start for display, monotonic dwell for
attribution: clock skew between processes can shift a bar, never stretch
it). Trace identity is W3C ``traceparent`` (``util/tracing.py``
SpanContext) riding the serve request context (``serve/context.py``), so
nested handle composition and the disaggregated prefill -> decode
handoff share one trace id without threading kwargs through user code.

The process that CREATES a trace (the HTTP or gRPC proxy, or a bare
handle call from a driver) owns the request's *ledger record*: terminal
status (ok / error / shed / deadline / cancelled), end-to-end wall and
the SLO verdict. Spans and records buffer in the process's shipper
(``core/sink.py``), whose one daemon flusher ships them, one call each
RTPU_TASK_EVENTS_FLUSH_S, to the serve controller's request ledger; a
batch that never left is put back. A process with no controller keeps
them until one appears. The controller folds them into the ledger
(``util.state.list_serve_requests`` / ``serve_trace``).

Everything is gated on ``RTPU_SERVE_TRACE`` (default on): when off, each
hop pays one flag check and nothing is allocated, buffered or shipped.
No thread starts at import; after a ``fork`` the child's shipper starts
empty, with a fresh lock and no flusher, so a forked replica ships its
own spans.
"""
from __future__ import annotations

import secrets
import time
from typing import Any, Dict, Optional

from .. import flags
from . import context as serve_context

def enabled() -> bool:
    return bool(flags.get("RTPU_SERVE_TRACE"))


def new_request_id() -> str:
    return secrets.token_hex(8)


def _traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def current_trace_ctx() -> Optional[Dict[str, str]]:
    """Wire form of the active request's trace identity (what rides the
    replica call next to deadline_ts): {"traceparent", "request_id",
    "deployment"}. None when no traced request is active: the callee
    then roots its own trace if it is an ingress."""
    c = serve_context.get_request_context()
    if not c or not c.get("trace_id"):
        return None
    return {"traceparent": _traceparent(c["trace_id"],
                                        c.get("parent_span_id")
                                        or "0" * 16),
            "request_id": c.get("request_id") or "",
            "deployment": c.get("deployment") or ""}


# ---------------------------------------------------------------- shipping

def flush_serve_trace(timeout: float = 10.0) -> bool:
    """Force a flush of buffered spans/records (tests, shutdown hooks)."""
    from ..core import sink

    return sink.flush(timeout=timeout)


def _ship_span(d: Dict[str, Any]) -> None:
    from ..core import sink
    from ..util import tracing

    sink.ship("serve_spans", d)
    # With the generic tracing plane on, serve hops also land in the
    # per-process finished-span record, so get_cluster_spans(trace_id)
    # returns them.
    if tracing.enabled():
        sp = tracing.Span(
            name=d["name"],
            context=tracing.SpanContext(d["trace_id"], d["span_id"]),
            parent_span_id=d.get("parent_span_id", ""),
            kind=d.get("kind", "internal"),
            attributes=dict(d.get("attributes") or {}),
            start_time=d["start_ts"])
        sp.end_time = d["start_ts"] + d.get("dwell_s", 0.0)
        tracing.record_finished(sp)


# ------------------------------------------------------------------ metrics

_metrics_cache: Optional[Dict[str, Any]] = None


def _metrics() -> Dict[str, Any]:
    global _metrics_cache
    if _metrics_cache is None:
        from ..util import metrics

        _metrics_cache = {
            "requests": metrics.Counter(
                "rtpu_serve_requests_total",
                description="Finished serve requests by terminal status "
                            "(ok / error / shed / deadline / cancelled), "
                            "counted where the request's trace was "
                            "rooted (proxy or calling driver).",
                tag_keys=("deployment", "status")),
            "slo_miss": metrics.Counter(
                "rtpu_serve_slo_miss_total",
                description="Serve requests that missed the latency SLO: "
                            "end-to-end wall above RTPU_SERVE_SLO_MS, or "
                            "a shed / deadline-exceeded outcome. These "
                            "rows are retained ahead of LRU eviction in "
                            "the controller request ledger.",
                tag_keys=("deployment",)),
        }
    return _metrics_cache


# ------------------------------------------------------------------- spans

class Hop:
    """One in-flight hop span. ``end()`` stamps the dwell from this
    process's monotonic clock and ships the span; while open, child hops
    (and downstream trace_ctx) parent under it via the serve context."""

    __slots__ = ("name", "kind", "trace_id", "span_id", "parent_span_id",
                 "request_id", "deployment", "start_ts", "_mono0",
                 "attributes", "_ctx", "_prev_parent", "_done")

    def __init__(self, name: str, kind: str, trace_id: str,
                 parent_span_id: str, request_id: str, deployment: str,
                 attributes: Optional[Dict[str, Any]],
                 ctx: Optional[dict]) -> None:
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = secrets.token_hex(8)
        self.parent_span_id = parent_span_id
        self.request_id = request_id
        self.deployment = deployment
        self.start_ts = time.time()
        self._mono0 = time.monotonic()
        self.attributes = dict(attributes) if attributes else {}
        self._ctx = ctx
        self._prev_parent = None
        self._done = False
        if ctx is not None:
            self._prev_parent = ctx.get("parent_span_id")
            ctx["parent_span_id"] = self.span_id

    @property
    def trace_ctx(self) -> Dict[str, str]:
        return {"traceparent": _traceparent(self.trace_id, self.span_id),
                "request_id": self.request_id,
                "deployment": self.deployment}

    def end(self, **attrs: Any) -> None:
        if self._done:
            return
        self._done = True
        if self._ctx is not None:
            self._ctx["parent_span_id"] = self._prev_parent
        if attrs:
            self.attributes.update(attrs)
        _ship_span({
            "name": self.name, "kind": self.kind,
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_span_id": self.parent_span_id or "",
            "request_id": self.request_id, "deployment": self.deployment,
            "start_ts": self.start_ts,
            "dwell_s": max(0.0, time.monotonic() - self._mono0),
            "attributes": self.attributes,
        })

    def __enter__(self) -> "Hop":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


def start_hop(name: str, *, kind: str = "internal",
              attributes: Optional[Dict[str, Any]] = None,
              trace_ctx: Optional[Dict[str, str]] = None,
              deployment: str = "") -> Optional[Hop]:
    """Open a hop span under the active request's trace. Identity comes
    from ``trace_ctx`` (explicit wire context: proxies, batch items)
    when given, else the installed serve request context. Returns None
    (one flag/dict check, nothing else) when the plane is off or no
    trace is active."""
    if not enabled():
        return None
    if trace_ctx is not None:
        tp = (trace_ctx.get("traceparent") or "").split("-")
        if len(tp) != 4:
            return None
        return Hop(name, kind, tp[1], tp[2],
                   trace_ctx.get("request_id") or "",
                   deployment or trace_ctx.get("deployment") or "",
                   attributes, None)
    c = serve_context.get_request_context()
    if not c or not c.get("trace_id"):
        return None
    return Hop(name, kind, c["trace_id"],
               c.get("parent_span_id") or "",
               c.get("request_id") or "",
               deployment or c.get("deployment") or "",
               attributes, c)


def emit_span(name: str, *, trace_ctx: Optional[Dict[str, str]],
              dwell_s: float, start_ts: Optional[float] = None,
              kind: str = "internal",
              attributes: Optional[Dict[str, Any]] = None,
              deployment: str = "") -> None:
    """Ship a hop span measured out of band (the caller already holds
    the monotonic dwell: a batch-queue dwell between submit and seal).
    No-op when the plane is off or the wire context is absent or
    malformed."""
    if not enabled() or not trace_ctx:
        return
    tp = (trace_ctx.get("traceparent") or "").split("-")
    if len(tp) != 4:
        return
    dwell_s = max(0.0, float(dwell_s))
    _ship_span({
        "name": name, "kind": kind,
        "trace_id": tp[1], "span_id": secrets.token_hex(8),
        "parent_span_id": tp[2],
        "request_id": trace_ctx.get("request_id") or "",
        "deployment": deployment or trace_ctx.get("deployment") or "",
        "start_ts": (time.time() - dwell_s
                     if start_ts is None else start_ts),
        "dwell_s": dwell_s,
        "attributes": dict(attributes) if attributes else {},
    })


# ------------------------------------------------------------- trace roots

#: Terminal statuses a ledger record may carry.
STATUSES = ("ok", "error", "shed", "deadline", "cancelled")


class RootTrace:
    """The outermost hop of a request, owned by whichever process
    created the trace id (HTTP/gRPC proxy, or Router.assign for a bare
    driver-side handle call). ``finish()`` emits the root span AND the
    ledger record (terminal status, end-to-end wall, SLO verdict) and
    bumps rtpu_serve_requests_total / rtpu_serve_slo_miss_total."""

    __slots__ = ("trace_id", "span_id", "request_id", "deployment",
                 "proto", "method", "start_ts", "_mono0", "attributes",
                 "_done")

    def __init__(self, request_id: str, deployment: str, proto: str,
                 method: str) -> None:
        self.trace_id = secrets.token_hex(16)
        self.span_id = secrets.token_hex(8)
        self.request_id = request_id or new_request_id()
        self.deployment = deployment
        self.proto = proto
        self.method = method
        self.start_ts = time.time()
        self._mono0 = time.monotonic()
        self.attributes: Dict[str, Any] = {}
        self._done = False

    @property
    def trace_ctx(self) -> Dict[str, str]:
        return {"traceparent": _traceparent(self.trace_id, self.span_id),
                "request_id": self.request_id,
                "deployment": self.deployment}

    def finish(self, status: str = "ok", error: str = "",
               **attrs: Any) -> None:
        """Idempotent: the first terminal outcome wins (a streaming
        response closed after exhaustion stays "ok")."""
        if self._done:
            return
        self._done = True
        wall = max(0.0, time.monotonic() - self._mono0)
        if attrs:
            self.attributes.update(attrs)
        _ship_span({
            "name": f"serve.{self.proto}", "kind": "ingress",
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_span_id": "",
            "request_id": self.request_id, "deployment": self.deployment,
            "start_ts": self.start_ts, "dwell_s": wall,
            "attributes": self.attributes,
        })
        slo_ms = flags.get("RTPU_SERVE_SLO_MS")
        miss = (status in ("shed", "deadline")
                or (slo_ms and slo_ms > 0 and wall * 1e3 > slo_ms))
        record = {
            "request_id": self.request_id, "trace_id": self.trace_id,
            "deployment": self.deployment, "method": self.method,
            "proto": self.proto, "status": status,
            "error": (error or "")[:512],
            "start_ts": self.start_ts, "wall_s": wall,
            "slo_miss": bool(miss),
        }
        m = _metrics()
        dep = self.deployment or "unknown"
        m["requests"].inc(1, tags={"deployment": dep, "status": status})
        if miss:
            m["slo_miss"].inc(1, tags={"deployment": dep})
        from ..core import sink

        sink.ship("serve_records", record)


def start_request(*, request_id: str = "", deployment: str = "",
                  proto: str = "python",
                  method: str = "") -> Optional[RootTrace]:
    """Root a new trace at an ingress. None when the plane is off."""
    if not enabled():
        return None
    return RootTrace(request_id, deployment, proto, method)


# ------------------------------------------------------------ stall stacks

def capture_stacks(max_chars: int = 16384) -> str:
    """All-thread stack capture for STREAM_STALLED events."""
    import sys
    import traceback

    out = []
    try:
        frames = sys._current_frames()
        for tid, frame in list(frames.items()):
            out.append(f"--- thread {tid} ---")
            out.append("".join(traceback.format_stack(frame)))
    except Exception as e:  # noqa: BLE001 — never raise into the hot path
        out.append(f"<stack capture failed: {e}>")
    return "\n".join(out)[:max_chars]
