"""The sink: where the app metrics, events and finished tracing spans of
a serve instance land (the JAX package keeps these in its cluster
controller, ``core/controller.py``; the port has none, so a sink lives in
the process that runs the serve controller, which owns it).

Four pieces of the JAX controller:

- the app-metric ingest (``_h_metric_update``, ``core/controller.py:
  1462-1500``): :meth:`MetricsSink.metric_update`: counters accumulate,
  gauges overwrite, histogram bucket counts merge;
- the families and the Prometheus text exposition (``_metrics_text``,
  ``:4628-4660``): :meth:`MetricsSink.families` and :func:`metrics_text`;
- the ``GET /metrics`` responder (``:4663``): a ``http.server`` on an
  ephemeral port of 127.0.0.1, served by a thread of this process
  (:meth:`MetricsSink.start`; :meth:`MetricsSink.stop` frees the port);
- a :class:`~.telemetry.MetricsTSDB` that samples the families once a
  second, read by :meth:`MetricsSink.query_metrics` (``:3226-3241``).

Beside them: the event ring (``core/events.py`` ``EventLog``) and a
bounded ring of finished tracing spans (``get_cluster_spans``).

:func:`deliver` is how a process's two flushers (the metrics
aggregator of ``util/metrics.py`` and this module's :class:`_Shipper`,
which carries serve spans and ledger records, events and tracing spans)
reach a sink, one call a payload: along the route the owning layer set
(:func:`set_route`): the sink's owner where this process holds it (a
direct call), else its address (a call over AF_UNIX, given up after
``timeout``), else this process's own sink (:func:`local_sink`, which has
no responder and no sampler and takes no ledger records). A payload is
sent at most once.
"""
from __future__ import annotations

import collections
import http.server
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .events import BUF_MAX as EVENTS_BUF_MAX, EventLog
from .telemetry import MetricsTSDB

# Finished tracing spans the sink keeps, events, TSDB points a series.
SPANS_MAX = 20000
EVENTS_MAX = 10000
TSDB_STEP_S = 1.0
TSDB_RETAIN = 600


def _esc(v) -> str:
    # Prometheus label-value escaping: one bad value must not corrupt the
    # whole scrape payload.
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def metrics_text(families: Dict[str, dict]) -> str:
    """Prometheus text exposition of ``families`` ({name: {"type",
    "help", "boundaries", "data": {tags_tuple: value}}}), as the JAX
    controller's ``_metrics_text`` renders it."""
    lines: List[str] = []
    for name, m in families.items():
        if m["help"]:
            lines.append(f"# HELP {name} {m['help']}")
        ptype = "histogram" if m["type"] == "histogram" else m["type"]
        lines.append(f"# TYPE {name} {ptype}")
        for tags, v in sorted(m["data"].items()):
            lbl = ",".join(f'{k}="{_esc(val)}"' for k, val in tags)
            if m["type"] == "histogram":
                cum = 0
                for i, b in enumerate(m["boundaries"]):
                    cum += v["buckets"][i]
                    le = (lbl + "," if lbl else "") + f'le="{b}"'
                    lines.append(f"{name}_bucket{{{le}}} {cum}")
                le_inf = (lbl + "," if lbl else "") + 'le="+Inf"'
                lines.append(f"{name}_bucket{{{le_inf}}} {v['count']}")
                suffix = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{name}_sum{suffix} {v['sum']}")
                lines.append(f"{name}_count{suffix} {v['count']}")
            else:
                suffix = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{name}{suffix} {v}")
    return "\n".join(lines) + "\n"


class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 — the base's name
        pass

    def do_GET(self):
        if self.path.split("?")[0] != "/metrics":
            self.send_error(404)
            return
        body = metrics_text(self.server.sink.families()).encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True


class MetricsSink:
    """App metrics, events and spans of every process of a serve
    instance, with the ``/metrics`` responder and the TSDB sampler once
    :meth:`start` ran."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.app_metrics: Dict[str, dict] = {}
        self.events = EventLog(maxlen=EVENTS_MAX)
        self.spans: "collections.deque[dict]" = collections.deque(
            maxlen=SPANS_MAX)
        self.tsdb = MetricsTSDB(step_s=TSDB_STEP_S, retain=TSDB_RETAIN)
        self._server: Optional[_Server] = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -------------------------------------------------------------- ingest

    def metric_update(self, metrics: List[dict]) -> None:
        """App-metric deltas of one flush (util/metrics.py): counters
        accumulate, gauges overwrite, histogram bucket counts merge
        elementwise (overflowing into the +Inf bucket on a length
        mismatch)."""
        with self._lock:
            for m in metrics:
                st = self.app_metrics.setdefault(
                    m["name"], {"type": m["type"], "help": m.get("help", ""),
                                "boundaries": m.get("boundaries") or [],
                                "data": {}})
                for tags_list, value in m.get("data", []):
                    tags = tuple(tuple(t) for t in tags_list)
                    if m["type"] == "gauge":
                        st["data"][tags] = value
                    elif m["type"] == "counter":
                        st["data"][tags] = st["data"].get(tags, 0.0) + value
                    else:
                        h = st["data"].setdefault(
                            tags, {"buckets": [0] * (len(st["boundaries"])
                                                     + 1),
                                   "sum": 0.0, "count": 0})
                        for i, c in enumerate(value.get("buckets", ())):
                            if c:
                                h["buckets"][min(i, len(h["buckets"]) - 1)] \
                                    += c
                        h["sum"] += value.get("sum", 0.0)
                        h["count"] += value.get("count", 0)

    def cluster_events(self, events: List[dict]) -> None:
        for ev in events:
            self.events.append(ev)

    def cluster_spans(self, spans: List[dict]) -> None:
        with self._lock:
            self.spans.extend(spans)

    # --------------------------------------------------------------- reads

    def families(self) -> Dict[str, dict]:
        """Every family, sorted by name (a copy: the exposition and the
        sampler read it while flushes land)."""
        with self._lock:
            return {name: {"type": m["type"], "help": m["help"],
                           "boundaries": list(m["boundaries"]),
                           "data": {k: (dict(v, buckets=list(v["buckets"]))
                                        if isinstance(v, dict) else v)
                                    for k, v in m["data"].items()}}
                    for name, m in sorted(self.app_metrics.items())}

    def get_spans(self, trace_id: Optional[str] = None,
                  limit: int = 10000) -> List[dict]:
        with self._lock:
            spans = list(self.spans)
        if trace_id:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        return spans[-limit:]

    def get_events(self, **filters: Any) -> List[dict]:
        return self.events.query(**filters)

    def query_metrics(self, name: Optional[str] = None,
                      prefix: Optional[str] = None,
                      tags: Optional[Dict[str, str]] = None,
                      since: Optional[float] = None,
                      stat: Optional[str] = None,
                      window_s: float = 60.0,
                      limit_series: int = 64) -> Dict[str, Any]:
        """Metrics history: plottable series from the TSDB ring, counters
        as rates and histograms as p50/p99/mean/rate."""
        with self._lock:
            series = self.tsdb.query(
                name=name, prefix=prefix, tags=tags, since=since, stat=stat,
                window_s=float(window_s), limit_series=int(limit_series))
        return {"enabled": True, "series": series, "now": time.time(),
                "step_s": self.tsdb.step_s, "retain": self.tsdb.retain}

    def sample(self, now: Optional[float] = None) -> None:
        """One TSDB point a series (the sampler does this every
        TSDB_STEP_S)."""
        fams = self.families()
        with self._lock:
            self.tsdb.sample(time.time() if now is None else now, fams)

    @property
    def address(self) -> Optional[str]:
        """host:port of the ``/metrics`` responder (None before start)."""
        if self._server is None:
            return None
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    # ------------------------------------------------------------ lifetime

    def start(self) -> None:
        """Serve ``GET /metrics`` on an ephemeral port and sample the
        TSDB once a second, on threads of this process."""
        self._server = _Server(("127.0.0.1", 0), _Handler)
        self._server.sink = self
        self._threads = [
            threading.Thread(target=self._server.serve_forever,
                             kwargs={"poll_interval": 0.1}, daemon=True,
                             name="rtpu-metrics-http"),
            threading.Thread(target=self._sample_loop, daemon=True,
                             name="rtpu-metrics-tsdb")]
        for t in self._threads:
            t.start()

    def _sample_loop(self) -> None:
        while not self._stop.wait(self.tsdb.step_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — history never hurts serve
                pass

    def stop(self) -> None:
        """Stop the responder (its port is free again) and the sampler."""
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []
        self.events.close()


_local_sink: Optional[MetricsSink] = None
_local_lock = threading.Lock()
# What the process's own sink takes (no ledger: records wait for a
# controller).
_LOCAL_METHODS = ("metric_update", "cluster_events", "cluster_spans",
                  "get_spans")


def local_sink() -> MetricsSink:
    """This process's own sink, for a process with no serve controller."""
    global _local_sink
    with _local_lock:
        if _local_sink is None:
            _local_sink = MetricsSink()
        return _local_sink


# ---------------------------------------------------------------- the route

# The sink's owner in this process (its methods are called directly) and
# the owner's address (a call over AF_UNIX). The layer that owns a sink
# sets them (:func:`set_route`); this module imports nothing above core.
_route_obj: Any = None
_route_address: Optional[str] = None


def set_route(obj: Any = None, address: Optional[str] = None) -> None:
    """Where :func:`deliver` and :func:`ask` go: ``obj``, the sink's owner
    in this process, else ``address``, the owner's listener in another
    process, else this process's own sink. The serve controller sets
    both when it starts and clears them when it stops; a replica sets the
    address it was given. A forked child keeps only the address."""
    global _route_obj, _route_address
    _route_obj, _route_address = obj, address


# What a call to the owner's address came to: answered ("ok", or "err"
# where the method raised), never sent, or sent and not answered in time.
OK, ERR, UNSENT, LOST = "ok", "err", "unsent", "lost"


class _Remote:
    """One connection to the owner's address, kept (under a lock) and
    opened again after a failure; a call that gets no answer within its
    timeout drops the connection."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.address: Optional[str] = None
        self.conn = None

    def call(self, address: str, method: str, args: Tuple,
             timeout: float) -> Tuple[str, Any]:
        from ..util import procs

        deadline = time.monotonic() + timeout
        if not self.lock.acquire(timeout=timeout):
            return UNSENT, None
        try:
            try:
                if self.address != address:
                    self._drop()
                    self.address = address
                if self.conn is None:
                    self.conn = procs.connect(address, retry_s=timeout)
                self.conn.send_bytes(pickle.dumps((method, args)))
            except (OSError, EOFError, pickle.PickleError):
                self._drop()
                return UNSENT, None
            try:
                if not self.conn.poll(max(0.0,
                                          deadline - time.monotonic())):
                    self._drop()
                    return LOST, None
                status, value = pickle.loads(self.conn.recv_bytes())
            except (OSError, EOFError, pickle.PickleError):
                self._drop()
                return LOST, None
            return (OK if status == "ok" else ERR), value
        finally:
            self.lock.release()

    def _drop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        self.conn = None


_remote = _Remote()


def _call(method: str, args: Tuple, timeout: float) -> Tuple[str, Any]:
    if _route_obj is not None:
        return OK, getattr(_route_obj, method)(*args)
    if _route_address:
        return _remote.call(_route_address, method, args, timeout)
    if method in _LOCAL_METHODS:
        return OK, getattr(local_sink(), method)(*args)
    return UNSENT, None


def deliver(method: str, *args: Any, timeout: float = 10.0) -> bool:
    """Hand ``method(*args)`` to the sink this process reaches (see the
    module's docstring). False only where the payload never left (no
    route for it, no connection, a failed send): the caller keeps it and
    tries again at its next flush. A payload that left is never sent
    again, answered in time or not, so a slow owner applies it at most
    once (the JAX package's flushers send without waiting)."""
    return _call(method, args, timeout)[0] != UNSENT


def ask(method: str, *args: Any, timeout: float = 10.0) -> Any:
    """``method(*args)``'s answer from the sink this process reaches, or
    None where there was none."""
    status, value = _call(method, args, timeout)
    return value if status == OK else None


# -------------------------------------------------------------- the shipper


class _Shipper:
    """The list-valued payloads of this process (serve hop spans and
    ledger records, events, tracing spans): one bounded buffer each, one
    lock, and one daemon flusher that, every RTPU_TASK_EVENTS_FLUSH_S,
    makes one :func:`deliver` call for each sink method with something
    to send. A batch that never left goes back, oldest first. (Metric
    deltas merge rather than append: ``util/metrics.py`` keeps them.)"""

    # Each sink method with the buffers that are its arguments.
    CALLS = (("serve_request_events", ("serve_spans", "serve_records")),
             ("cluster_events", ("events",)),
             ("cluster_spans", ("spans",)))
    CAPS = {"serve_spans": 4096, "serve_records": 4096,
            "events": EVENTS_BUF_MAX, "spans": 4096}

    def __init__(self) -> None:
        self._reset()

    def _reset(self) -> None:
        self.lock = threading.Lock()
        self.buffers: Dict[str, "collections.deque[dict]"] = {}
        self._thread: Optional[threading.Thread] = None

    def _buffer_locked(self, name: str) -> "collections.deque[dict]":
        buf = self.buffers.get(name)
        if buf is None:
            buf = self.buffers[name] = collections.deque(
                maxlen=self.CAPS[name])
        return buf

    def add(self, name: str, item: dict) -> None:
        with self.lock:
            self._buffer_locked(name).append(item)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="rtpu-torch-ship", daemon=True)
                self._thread.start()

    def _run(self) -> None:
        from .. import flags

        while True:
            time.sleep(flags.get("RTPU_TASK_EVENTS_FLUSH_S"))
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — never take a process down
                pass

    def flush(self, timeout: float = 10.0) -> bool:
        """Ship everything buffered; False where some batch never left
        (it is buffered again)."""
        with self.lock:
            batch = {name: list(buf) for name, buf in self.buffers.items()}
            for buf in self.buffers.values():
                buf.clear()
        ok = True
        for method, names in self.CALLS:
            args = [batch.get(name, []) for name in names]
            if not any(args) or deliver(method, *args, timeout=timeout):
                continue
            ok = False
            with self.lock:
                for name, items in zip(names, args):
                    self._buffer_locked(name).extendleft(reversed(items))
        return ok


_shipper = _Shipper()


def ship(name: str, item: dict) -> None:
    """Buffer ``item`` in the shipper's buffer ``name`` (see
    :attr:`_Shipper.CAPS`); the flusher starts at the first."""
    _shipper.add(name, item)


def flush(timeout: float = 10.0) -> bool:
    """Ship every buffered span, record and event now (tests, a process's
    last flush); False where some batch never left."""
    return _shipper.flush(timeout=timeout)


def _after_fork() -> None:
    global _remote, _local_sink, _local_lock, _route_obj
    _remote = _Remote()
    _local_sink = None
    _local_lock = threading.Lock()
    _route_obj = None
    _shipper._reset()


os.register_at_fork(after_in_child=_after_fork)
