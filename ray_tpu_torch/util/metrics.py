"""Application-defined metrics: Counter / Gauge / Histogram (counterpart
of the JAX package's ``util/metrics.py``).

Code in any process of a serve instance (the driver, a replica, the
engine's ticker thread) defines metrics and records values; they surface
on the sink's Prometheus endpoint (``core/sink.py``). Each process
buffers its updates and a daemon flusher ships the deltas every
RTPU_METRICS_FLUSH_S as ONE call along ``core/sink.py``'s route: to
the serve controller where the process has its address (a replica is
given it; the controller's own process folds them straight in), else
into the process's own sink. A batch that never left is re-buffered,
merged with what was recorded meanwhile; one that left is never sent
again, answered in time or not (at most once). Histograms are aggregated into bucket counts at record time,
so both the pending buffer and the wire message stay O(buckets) whatever
the observation rate.

Nothing runs at import: the flusher starts at the first record. After a
``fork`` the child starts with an empty buffer, a fresh lock and no
flusher (``os.register_at_fork``), so a forked replica ships its own
deltas and never a copy of its parent's.

Usage::

    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

    requests = Counter("app_requests", description="...", tag_keys=("route",))
    requests.inc(1.0, tags={"route": "/infer"})
    Gauge("app_inflight").set(3)
    Histogram("app_latency_s", boundaries=[0.01, 0.1, 1.0]).observe(0.03)
"""
from __future__ import annotations

import atexit
import bisect
import os
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from .. import flags

_TagTuple = Tuple[Tuple[str, str], ...]

# A flush's delivery gives up after this long (the final one, at exit,
# after FINAL_FLUSH_TIMEOUT_S: a stopped controller must not hang exit).
FLUSH_TIMEOUT_S = 10.0
FINAL_FLUSH_TIMEOUT_S = 2.0


def _tags_tuple(tags: Optional[Dict[str, str]]) -> _TagTuple:
    return tuple(sorted((tags or {}).items()))


def _hist_state(boundaries: Sequence[float]) -> dict:
    return {"buckets": [0] * (len(boundaries) + 1), "sum": 0.0, "count": 0}


def _hist_merge(dst: dict, src: dict) -> None:
    if len(dst["buckets"]) != len(src["buckets"]):
        # Clamp-merging mismatched bucket grids silently corrupts
        # quantiles; boundary mismatches are refused at record time, so
        # reaching here is a programming error.
        raise ValueError(
            f"histogram bucket count mismatch: {len(dst['buckets'])} != "
            f"{len(src['buckets'])}")
    for i, c in enumerate(src["buckets"]):
        dst["buckets"][i] += c
    dst["sum"] += src["sum"]
    dst["count"] += src["count"]


class _Aggregator:
    """Per-process buffer of metric updates, flushed to the sink."""

    def __init__(self) -> None:
        self._reset()

    def _reset(self) -> None:
        self.lock = threading.Lock()
        # name -> {"type", "help", "boundaries", "data": {tags: value}}
        # counters/histogram buckets accumulate deltas; gauges keep last.
        self.pending: Dict[str, dict] = {}
        self._thread: Optional[threading.Thread] = None

    def record(self, name: str, mtype: str, help_: str, tags: _TagTuple,
               value: float, boundaries: Sequence[float] = ()) -> None:
        with self.lock:
            m = self.pending.setdefault(
                name, {"type": mtype, "help": help_,
                       "boundaries": list(boundaries), "data": {}})
            if mtype == "histogram" and m["boundaries"] != list(boundaries):
                # Two Histograms sharing a name but not a bucket grid:
                # merging them would clamp-corrupt quantiles in the sink.
                raise ValueError(
                    f"histogram {name!r} re-registered with different "
                    f"boundaries {list(boundaries)} (existing: "
                    f"{m['boundaries']})")
            if mtype == "gauge":
                m["data"][tags] = value
            elif mtype == "counter":
                m["data"][tags] = m["data"].get(tags, 0.0) + value
            else:
                h = m["data"].get(tags)
                if h is None:
                    h = m["data"][tags] = _hist_state(m["boundaries"])
                i = min(bisect.bisect_left(m["boundaries"], value),
                        len(m["boundaries"]))
                h["buckets"][i] += 1
                h["sum"] += value
                h["count"] += 1
            # Under the lock: two first-record threads racing the alive
            # check outside it could each start a flusher.
            self._ensure_flusher_locked()

    def _ensure_flusher_locked(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._run, name="rtpu-torch-metrics-flush",
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            time.sleep(flags.get("RTPU_METRICS_FLUSH_S"))
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — never take a process down
                pass

    def flush(self, final: bool = False) -> bool:
        """Ship the pending deltas (one call); False where they never
        left and were re-buffered."""
        from ..core import sink

        # Out-of-band samplers first: they record into the pending buffer,
        # so their samples ride the very flush that triggered them.
        for fn in list(_flush_samplers):
            try:
                fn()
            except Exception:  # noqa: BLE001 — a sampler's own failure
                pass
        with self.lock:
            if not self.pending:
                return True
            batch, self.pending = self.pending, {}
        wire = [
            {"name": name, "type": m["type"], "help": m["help"],
             "boundaries": m["boundaries"],
             "data": [(list(k), v) for k, v in m["data"].items()]}
            for name, m in batch.items()
        ]
        if sink.deliver("metric_update", wire,
                        timeout=(FINAL_FLUSH_TIMEOUT_S if final
                                 else FLUSH_TIMEOUT_S)):
            return True
        self._requeue(batch)
        return False

    def _requeue(self, batch: Dict[str, dict]) -> None:
        """Put a batch that was not delivered back, merged with what was
        recorded meanwhile (which must not shadow it)."""
        with self.lock:
            for name, m in batch.items():
                cur = self.pending.get(name)
                if cur is None:
                    self.pending[name] = m
                    continue
                for tags, v in m["data"].items():
                    if m["type"] == "counter":
                        cur["data"][tags] = cur["data"].get(tags, 0.0) + v
                    elif m["type"] == "histogram":
                        ch = cur["data"].get(tags)
                        if ch is None:
                            cur["data"][tags] = v
                        else:
                            _hist_merge(ch, v)
                    else:  # gauge: the newer pending value wins
                        cur["data"].setdefault(tags, v)


_aggregator = _Aggregator()
os.register_at_fork(after_in_child=_aggregator._reset)

# Callables run at the top of every flush: subsystems that keep raw
# counters off the metrics path register one that folds them into
# instruments at flush cadence.
_flush_samplers: list = []


def register_flush_sampler(fn) -> None:
    """Register ``fn`` to run at the start of every metrics flush (the
    flusher starts now, so a process that records nothing directly still
    samples). ``fn`` must be cheap; its errors are swallowed."""
    if fn not in _flush_samplers:
        _flush_samplers.append(fn)
    with _aggregator.lock:
        _aggregator._ensure_flusher_locked()


def unregister_flush_sampler(fn) -> None:
    try:
        _flush_samplers.remove(fn)
    except ValueError:
        pass


def flush_metrics() -> bool:
    """Force a flush (tests, shutdown hooks)."""
    return _aggregator.flush()


def _atexit_flush() -> None:
    try:
        _aggregator.flush(final=True)
    except Exception:  # noqa: BLE001 — interpreter teardown
        pass


# The flusher is a daemon thread: without this hook a short-lived process
# that records and exits inside one flush period drops its last batch.
atexit.register(_atexit_flush)


class _Metric:
    mtype = ""

    def __init__(self, name: str, *, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)

    def _record(self, value: float, tags: Optional[Dict[str, str]],
                boundaries: Sequence[float] = ()) -> None:
        _aggregator.record(self.name, self.mtype, self.description,
                           _tags_tuple(tags), value, boundaries)


class Counter(_Metric):
    mtype = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        self._record(value, tags)


class Gauge(_Metric):
    mtype = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        self._record(float(value), tags)


class Histogram(_Metric):
    mtype = "histogram"

    def __init__(self, name: str, *, description: str = "",
                 boundaries: Sequence[float] = (0.01, 0.1, 1, 10),
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description=description, tag_keys=tag_keys)
        self.boundaries = tuple(sorted(boundaries))

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self._record(float(value), tags, self.boundaries)
