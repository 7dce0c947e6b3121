"""Cluster event subsystem: structured events (counterpart of the JAX
package's ``core/events.py``).

Lifecycle transitions and faults become structured records (ts,
severity, source, kind, entity ids, message, data) instead of lines on
stderr. Three pieces:

- :func:`make_event`: the one record shape every producer emits;
- :class:`EventLog`: the sink's store (``core/sink.py``): a bounded ring
  with severity/kind/entity/since/seq filters, JSONL persistence when a
  path is given (the ring's tail and the seq counter reload from it), and
  per-(source, severity) counts. The JAX log's long-poll follow belongs
  to its controller's event loop, which the port does not have: a reader
  polls with ``after_seq``;
- shipping: :func:`emit` buffers events in the process's shipper
  (``core/sink.py``, which also carries the serve trace's spans and
  records), whose one daemon flusher delivers them in batches to the
  serve controller's sink where this process has a route to one, else
  to the process's own. A batch that never left is put back.

The serve engine's STREAM_STALLED event goes through :func:`emit`, and
so do the compiled DAG's DAG_PARTICIPANT_DIED, DAG_RECOVERING,
DAG_RECOVERED and DAG_RECOVERY_FAILED (``dag/compiled_dag.py``).
Everything is gated on ``RTPU_EVENTS``: when off, emit sites pay one flag
check and nothing is stored or shipped. No thread starts at import; a
forked child starts with an empty buffer and no flusher.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .. import flags

# The shipper's bound for events (oldest events drop first while the
# sink is unreachable): the JAX package's flag default.
BUF_MAX = 2048

# Severity ladder. Filters treat a requested severity as the MINIMUM
# level to return.
SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


def severity_rank(severity: Optional[str]) -> int:
    """Rank for min-severity filtering; unknown severities rank as INFO."""
    return _SEV_RANK.get((severity or "INFO").upper(), 1)


def enabled() -> bool:
    return bool(flags.get("RTPU_EVENTS"))


def make_event(severity: str, source: str, kind: str, message: str, *,
               node_id: Optional[str] = None,
               worker_id: Optional[str] = None,
               actor_id: Optional[str] = None,
               task_id: Optional[str] = None,
               data: Optional[Dict[str, Any]] = None,
               ts: Optional[float] = None) -> Dict[str, Any]:
    """One structured event. ``kind`` is a stable SCREAMING_SNAKE
    identifier (STREAM_STALLED, ...); ``message`` is the human line;
    ``data`` carries kind-specific payload (e.g. the captured stack)."""
    return {
        "ts": ts if ts is not None else time.time(),
        "severity": (severity or "INFO").upper(),
        "source": source,
        "kind": kind,
        "message": message,
        "node_id": node_id,
        "worker_id": worker_id,
        "actor_id": actor_id,
        "task_id": task_id,
        "data": data or {},
    }


class EventLog:
    """The sink's event store: bounded ring + JSONL persistence.

    Events get a monotonically increasing ``seq``, the follow cursor for
    ``query(after_seq=...)``. With a persist path, every event appends one
    JSON line and a new log on the same path reloads the ring's tail (seq
    continues from the persisted maximum)."""

    def __init__(self, maxlen: int = 10000,
                 persist_path: Optional[str] = None):
        self.ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=max(16, int(maxlen)))
        self.persist_path = persist_path
        self.seq = 0
        # (source, severity) -> count since start/restore.
        self.counts: Dict[tuple, int] = {}
        self._file: Any = None  # lazily opened; False = disabled on error
        self._lock = threading.Lock()
        self._restore()

    # ------------------------------------------------------------ persistence

    def _restore(self) -> None:
        if not self.persist_path or not os.path.exists(self.persist_path):
            return
        tail: "collections.deque[str]" = collections.deque(
            maxlen=self.ring.maxlen)
        try:
            with open(self.persist_path, "r", encoding="utf-8",
                      errors="replace") as f:
                for line in f:
                    if line.strip():
                        tail.append(line)
        except OSError:
            return
        for line in tail:
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # a torn write at a kill: skip the line
            if not isinstance(ev, dict) or "kind" not in ev:
                continue
            self.seq = max(self.seq, int(ev.get("seq", 0)))
            self.ring.append(ev)
            key = (ev.get("source", "?"), ev.get("severity", "INFO"))
            self.counts[key] = self.counts.get(key, 0) + 1

    def _persist(self, ev: Dict[str, Any]) -> None:
        if not self.persist_path:
            return
        if self._file is None:
            try:
                self._file = open(self.persist_path, "a", buffering=1,
                                  encoding="utf-8")
            except OSError:
                self._file = False
        if self._file is False:
            return
        try:
            self._file.write(json.dumps(ev, default=str) + "\n")
        except Exception:  # noqa: BLE001 — never hurt the plane
            self._file = False

    def close(self) -> None:
        if self._file:
            self._file.close()
        self._file = False

    # ----------------------------------------------------------------- append

    def append(self, ev: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self.seq += 1
            ev["seq"] = self.seq
            self.ring.append(ev)
            key = (ev.get("source", "?"), ev.get("severity", "INFO"))
            self.counts[key] = self.counts.get(key, 0) + 1
            self._persist(ev)
        return ev

    def emit(self, severity: str, kind: str, message: str,
             source: str = "controller", **entities: Any) -> None:
        if not enabled():
            return
        self.append(make_event(severity, source, kind, message, **entities))

    # ------------------------------------------------------------------ query

    def query(self, severity: Optional[str] = None,
              kinds: Optional[List[str]] = None,
              task_id: Optional[str] = None,
              actor_id: Optional[str] = None,
              node_id: Optional[str] = None,
              worker_id: Optional[str] = None,
              since: Optional[float] = None,
              after_seq: Optional[int] = None,
              limit: int = 1000) -> List[Dict[str, Any]]:
        """Filtered view of the ring, oldest first. ``severity`` is a
        minimum level; ``kinds`` matches exactly (case-insensitive);
        entity ids match on PREFIX; ``since`` is a wall-clock lower bound;
        ``after_seq`` the follow cursor."""
        min_rank = severity_rank(severity) if severity else 0
        want_kinds = {k.upper() for k in kinds} if kinds else None
        out: List[Dict[str, Any]] = []
        with self._lock:
            ring = list(self.ring)
        for ev in ring:
            if after_seq is not None and ev.get("seq", 0) <= after_seq:
                continue
            if since is not None and ev.get("ts", 0.0) < since:
                continue
            if min_rank and severity_rank(ev.get("severity")) < min_rank:
                continue
            if want_kinds and (ev.get("kind") or "").upper() not in want_kinds:
                continue
            if task_id and not (ev.get("task_id") or "").startswith(task_id):
                continue
            if actor_id and not (ev.get("actor_id") or "").startswith(
                    actor_id):
                continue
            if node_id and not (ev.get("node_id") or "").startswith(node_id):
                continue
            if worker_id and not (ev.get("worker_id") or "").startswith(
                    worker_id):
                continue
            out.append(ev)
        return out[-max(1, int(limit)):]


# ------------------------------------------------------------ shipping


def emit(severity: str, kind: str, message: str, source: str = "worker",
         **entities: Any) -> None:
    """Buffer one event in this process's shipper (``core/sink.py``),
    whose flusher ships it to the sink."""
    if not enabled():
        return
    from . import sink

    sink.ship("events", make_event(severity, source, kind, message,
                                   **entities))


def flush_events(timeout: float = 10.0) -> bool:
    """Force a flush of the shipper (tests, shutdown hooks)."""
    from . import sink

    return sink.flush(timeout=timeout)
