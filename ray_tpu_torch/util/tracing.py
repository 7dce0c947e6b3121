"""Spans with OpenTelemetry-compatible context propagation (counterpart
of the JAX package's ``util/tracing.py``).

The wire format is W3C ``traceparent`` (:class:`SpanContext`), the one
the serve trace plane (``serve/trace.py``) carries across processes. A
built-in tracer provides the surface: a thread-local current span, child
spans (:func:`start_span`), and a bounded per-process record of finished
spans (4096) read by :func:`get_finished_spans`. With tracing on, each
finished span is also shipped to the sink (``core/sink.py``'s shipper),
and :func:`get_cluster_spans` merges this process's record with the
spans the sink received from every process. Where the
``opentelemetry-sdk`` package imports, :func:`setup_tracing` also installs
its TracerProvider and the caller's span processor.

Everything is gated on ``RTPU_TRACING`` (set by :func:`setup_tracing`;
processes started afterwards inherit it through the environment). With it
on, every serve hop also lands here, so one trace id yields the hops of
every process.

The JAX module's task spans (a PRODUCER span at submission, a CONSUMER
span around the task) have no counterpart: the port has no tasks.
"""
from __future__ import annotations

import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .. import flags

# Bound of this process's finished-span record.
FINISHED_MAX = 4096

_local = threading.local()
_finished: List["Span"] = []
_finished_lock = threading.Lock()
_otel_sdk = None  # resolved once by setup_tracing


def enabled() -> bool:
    return bool(flags.get("RTPU_TRACING"))


@dataclass
class SpanContext:
    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars

    @property
    def is_valid(self) -> bool:
        return bool(int(self.trace_id, 16))

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, tp: str) -> Optional["SpanContext"]:
        parts = tp.split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        return cls(trace_id=parts[1], span_id=parts[2])


@dataclass
class Span:
    name: str
    context: SpanContext
    parent_span_id: str = ""
    kind: str = "internal"
    attributes: Dict[str, Any] = field(default_factory=dict)
    start_time: float = field(default_factory=time.time)
    end_time: float = 0.0

    def end(self) -> None:
        self.end_time = time.time()
        record_finished(Span(**{f: getattr(self, f) for f in (
            "name", "context", "parent_span_id", "kind", "attributes",
            "start_time", "end_time")}))


def record_finished(span: Span) -> None:
    """Add a finished span to this process's bounded record and, with
    tracing on, to the shipper's buffer for the sink (``core/sink.py``)."""
    with _finished_lock:
        _finished.append(span)
        del _finished[:-FINISHED_MAX]
    if enabled():
        from ..core import sink

        sink.ship("spans", span_to_dict(span))


def current_span_context() -> Optional[SpanContext]:
    return getattr(_local, "ctx", None)


def current_trace_id() -> str:
    ctx = current_span_context()
    return ctx.trace_id if ctx is not None else ""


def get_finished_spans() -> List[Span]:
    with _finished_lock:
        return list(_finished)


def drain_finished_spans() -> List[Span]:
    """Pop (and clear) this process's finished-span records: after a
    drain, ``get_finished_spans()`` in this process no longer returns
    them (the copies shipped to the sink stay there)."""
    with _finished_lock:
        spans, _finished[:] = list(_finished), []
    return spans


def span_to_dict(s: Span) -> Dict[str, Any]:
    """Wire/JSON form of a span (what get_cluster_spans returns)."""
    return {
        "name": s.name,
        "trace_id": s.context.trace_id,
        "span_id": s.context.span_id,
        "parent_span_id": s.parent_span_id,
        "kind": s.kind,
        "attributes": dict(s.attributes),
        "start_time": s.start_time,
        "end_time": s.end_time,
    }


def flush_spans(timeout: float = 10.0) -> bool:
    """Ship what the process's shipper holds now, these spans included;
    False where some batch never left (it stays buffered)."""
    from ..core import sink

    return sink.flush(timeout=timeout)


def get_cluster_spans(trace_id: Optional[str] = None,
                      timeout: float = 10.0) -> List[Dict[str, Any]]:
    """Finished spans of every process, as dicts sorted by start time:
    this process's records merged with the spans the sink received (the
    serve controller's where serve runs). Filter with ``trace_id``."""
    from ..core import sink

    by_id: Dict[str, Dict[str, Any]] = {
        d["span_id"]: d for d in (span_to_dict(s)
                                  for s in get_finished_spans())}
    for d in sink.ask("get_spans", trace_id, timeout=timeout) or ():
        by_id.setdefault(d["span_id"], d)
    spans = list(by_id.values())
    if trace_id:
        spans = [d for d in spans if d["trace_id"] == trace_id]
    spans.sort(key=lambda d: d["start_time"])
    return spans


class _SpanScope:
    """start span -> set thread-local context -> restore + record."""

    def __init__(self, name: str, kind: str,
                 attributes: Optional[Dict[str, Any]] = None,
                 parent: Optional[SpanContext] = None):
        self.name = name
        self.kind = kind
        self.attributes = dict(attributes or {})
        self.parent = parent
        self.span: Optional[Span] = None
        self._prev: Optional[SpanContext] = None

    def __enter__(self) -> Span:
        parent = self.parent or current_span_context()
        trace_id = parent.trace_id if parent else secrets.token_hex(16)
        ctx = SpanContext(trace_id=trace_id, span_id=secrets.token_hex(8))
        self.span = Span(name=self.name, context=ctx, kind=self.kind,
                         parent_span_id=parent.span_id if parent else "",
                         attributes=self.attributes)
        self._prev = current_span_context()
        _local.ctx = ctx
        return self.span

    def __exit__(self, et, ev, tb):
        if getattr(_local, "ctx", None) is (
                self.span.context if self.span else None):
            _local.ctx = self._prev
        if self.span is not None:
            if et is not None:
                self.span.attributes["error"] = repr(ev)
            self.span.end()
        return False


def start_span(name: str, kind: str = "internal",
               attributes: Optional[Dict[str, Any]] = None,
               parent: Optional[SpanContext] = None) -> _SpanScope:
    """Application-facing span context manager: a child of ``parent``,
    else of this thread's current span, else the root of a new trace."""
    return _SpanScope(name, kind, attributes, parent)


def setup_tracing(span_processor: Optional[Any] = None) -> None:
    """Enable tracing in this process (processes started afterwards
    inherit it through the environment).

    With ``opentelemetry-sdk`` importable, a TracerProvider is installed
    (where the global one is still the no-op default) and
    ``span_processor`` registered; otherwise the built-in tracer carries
    everything."""
    global _otel_sdk
    try:
        from opentelemetry import trace as otel_trace
        from opentelemetry.sdk.trace import TracerProvider

        provider = otel_trace.get_tracer_provider()
        if not isinstance(provider, TracerProvider):
            provider = TracerProvider()
            otel_trace.set_tracer_provider(provider)
        if span_processor is not None:
            provider.add_span_processor(span_processor)
        _otel_sdk = otel_trace
    except ImportError:
        _otel_sdk = None  # the built-in tracer carries the spans
    os.environ["RTPU_TRACING"] = "1"
