"""The compiled-DAG channel meter (RTPU_DAG_METER): sources, sampling and
``attribute_bottleneck`` (counterpart of the JAX package's
``dag/meter.py``).

The hot path never touches an instrument: ring writers and readers bump
raw u64 counter lines inside their ``SlotRing`` (``core/object_store.py``),
and each resident stage adds its phase times (``PHASES``) to its line of
the DAG's :class:`StageBlock`,
a shm segment the driver creates. On one host the driver maps both, so
the cold half runs there: the driver registers each compiled DAG as a
source, and :func:`sample_now`, run at every metrics flush
(``util/metrics.register_flush_sampler``) and on demand, folds the raw
counters into

- ``rtpu_dag_edge_items_total`` / ``rtpu_dag_edge_bytes_total`` (counter
  deltas, epoch-aware), ``rtpu_dag_edge_occupancy`` /
  ``rtpu_dag_edge_lag_seqs`` (from the live cursors), and
  ``rtpu_dag_edge_blocked_fraction`` (the writer's wait for ring space);
- ``rtpu_dag_stage_busy_fraction{phase=recv|compute|send}`` and
  ``rtpu_dag_stage_steps_total``;
- the DAG's registry row (``util/state.list_compiled_dags()``): the
  stages' busy fractions over the last sample window, the edges' counters,
  steps a second, the bottleneck and the recoveries. The JAX package
  keeps the row in its cluster controller; the port keeps it in the
  driver, as its serve ledger.

**Epoch consistency.** A recovery rebuilds the affected rings under a
bumped epoch with zeroed counters, and replays skip the counters
(``record=False``): the sampler keys each edge's baseline on the ring's
epoch, so rates never go negative and replayed items never count twice.

:func:`attribute_bottleneck` is the one attribution rule: the bottleneck
is the stage whose compute + send saturation bounds the steady state.
recv (starved) time marks a victim of an upstream bottleneck, and a
writer's blocked time the victim of a downstream one: neither scores.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..core import object_store
from ..util import metrics as um

_EDGE_ITEMS = um.Counter(
    "rtpu_dag_edge_items_total",
    description="Items published into a compiled-DAG channel edge "
                "(sampled from the ring's counter lines)",
    tag_keys=("dag", "edge"))
_EDGE_BYTES = um.Counter(
    "rtpu_dag_edge_bytes_total",
    description="Payload bytes published into a compiled-DAG channel "
                "edge (the size before a sidecar spill)",
    tag_keys=("dag", "edge"))
_EDGE_OCC = um.Gauge(
    "rtpu_dag_edge_occupancy",
    description="Items in flight in a compiled-DAG edge ring (write seq "
                "minus the slowest reader's cursor; depth bounds it)",
    tag_keys=("dag", "edge"))
_EDGE_LAG = um.Gauge(
    "rtpu_dag_edge_lag_seqs",
    description="Worst consumer lag on a compiled-DAG edge in seqs",
    tag_keys=("dag", "edge"))
_EDGE_BLOCKED = um.Gauge(
    "rtpu_dag_edge_blocked_fraction",
    description="Share of wall time the edge's writer spent blocked on "
                "ring space since the last sample (consumer backpressure)",
    tag_keys=("dag", "edge"))
_STAGE_BUSY = um.Gauge(
    "rtpu_dag_stage_busy_fraction",
    description="Share of wall time a resident DAG stage spent in each "
                "phase since the last sample (recv = starved on inputs, "
                "compute = decoding them and the method, send = encoding "
                "and publishing minus backpressure)",
    tag_keys=("dag", "stage", "phase"))
_STAGE_STEPS = um.Counter(
    "rtpu_dag_stage_steps_total",
    description="Microbatches a resident DAG stage finished",
    tag_keys=("dag", "stage"))

# A stage's counters (``dag/resident.py`` ``_run_stage``): recv, compute
# and send ns (the busy phases), the writer's blocked ns, steps, and the
# ns spent decoding the inputs and encoding the output (parts of compute
# and send: a CUDA tensor's copies between card and host).
PHASES = ("recv", "compute", "send", "blocked", "steps", "decode",
          "encode")


class StageBlock:
    """The phase counters of one DAG's stages in shared memory: a 64-byte
    line of u64 (``PHASES``) a stage, each line written by its stage's
    loop alone and read by the driver's sampler."""

    LINE = 64

    def __init__(self, seg: object_store.Segment, n: int):
        self._seg = seg
        self.n = n
        self._q = seg.buf.cast("Q")
        object_store.track_channel_segment(seg.name, seg.size)

    @classmethod
    def create(cls, name: str, n_stages: int) -> "StageBlock":
        seg = object_store.Segment(name, create=True,
                                   size=max(1, n_stages) * cls.LINE)
        return cls(seg, n_stages)

    @classmethod
    def attach(cls, name: str) -> "StageBlock":
        seg = object_store.Segment(name)
        return cls(seg, seg.size // cls.LINE)

    @property
    def name(self) -> str:
        return self._seg.name

    def add(self, idx: int, recv: int, compute: int, send: int,
            blocked: int, decode: int, encode: int) -> None:
        q, i = self._q, idx * (self.LINE // 8)
        q[i] += recv
        q[i + 1] += compute
        q[i + 2] += send
        q[i + 3] += blocked
        q[i + 4] += 1
        q[i + 5] += decode
        q[i + 6] += encode

    def read(self) -> Dict[int, Dict[str, int]]:
        q, w = self._q, self.LINE // 8
        return {idx: {p: int(q[idx * w + k]) for k, p in enumerate(PHASES)}
                for idx in range(self.n)}

    def close(self) -> None:
        object_store.untrack_channel_segment(self._seg.name)
        try:
            self._q.release()
            self._seg.close()
        except Exception:  # noqa: BLE001 — already closed
            pass

    def unlink(self) -> None:
        name = self._seg.name
        self.close()
        object_store.unlink_segment(name)


# Registered sources: objects with ``dag_id`` and any of ``rings`` (edge
# id -> SlotRing) and ``stage_ns`` (stage idx -> phase counters). The
# driver's compiled DAG registers one (``compiled_dag._MeterSource``).
_lock = threading.Lock()
_sources: List[Any] = []
_edge_base: Dict[Any, Dict[str, Any]] = {}
_stage_base: Dict[Any, Dict[str, Any]] = {}
_rows: Dict[str, Dict[str, Any]] = {}
_hooked = False


def register_source(src: Any) -> None:
    global _hooked
    with _lock:
        if src not in _sources:
            _sources.append(src)
        if not _hooked:
            _hooked = True
            um.register_flush_sampler(sample_now)


def unregister_source(src: Any) -> None:
    """Stop sampling ``src`` (returns once no sample of it is running)."""
    with _lock:
        try:
            _sources.remove(src)
        except ValueError:
            pass


def sample_now() -> None:
    """Fold every registered source's raw counters into the instruments
    and the rows. Runs at every metrics flush; callable directly for a
    sample now."""
    now = time.monotonic()
    with _lock:
        for src in list(_sources):
            try:
                _sample_source(src, now)
            except Exception:  # noqa: BLE001 — a source closing meanwhile
                pass


def _sample_source(src: Any, now: float) -> None:
    dag = str(src.dag_id)[:12]
    row = _rows.get(src.dag_id)
    rings = dict(getattr(src, "rings", None) or {})
    edge_stats: Dict[str, Dict[str, Any]] = {}
    for eid, ring in rings.items():
        try:
            c = ring.counters()
        except Exception:  # noqa: BLE001 — the ring closed mid-sample
            continue
        key = (dag, eid)
        base = _edge_base.get(key)
        if base is None or base["epoch"] != c["epoch"]:
            # A fresh ring incarnation: its counters start at zero, so
            # the baseline does too.
            base = {"epoch": c["epoch"], "items": 0, "bytes": 0,
                    "blocked_ns": 0, "t": None}
        tags = {"dag": dag, "edge": eid}
        _EDGE_ITEMS.inc(max(0, c["items"] - base["items"]), tags)
        _EDGE_BYTES.inc(max(0, c["bytes"] - base["bytes"]), tags)
        _EDGE_OCC.set(float(c["occupancy"]), tags)
        lag = max((r["lag"] for r in c["readers"]), default=0)
        _EDGE_LAG.set(float(lag), tags)
        blocked_frac = None
        if base["t"] is not None and now > base["t"]:
            wall_ns = (now - base["t"]) * 1e9
            d_blocked = max(0, c["blocked_ns"] - base["blocked_ns"])
            blocked_frac = min(1.0, d_blocked / wall_ns)
            _EDGE_BLOCKED.set(blocked_frac, tags)
        _edge_base[key] = {"epoch": c["epoch"], "items": c["items"],
                           "bytes": c["bytes"],
                           "blocked_ns": c["blocked_ns"], "t": now}
        edge_stats[eid] = {"epoch": c["epoch"], "items": c["items"],
                           "bytes": c["bytes"], "occupancy": c["occupancy"],
                           "depth": c["depth"], "lag": lag,
                           "blocked_fraction": blocked_frac}
    busy: Dict[str, Dict[str, float]] = {}
    steps_per_s: Dict[str, float] = {}
    for idx, stc in list((getattr(src, "stage_ns", None) or {}).items()):
        snap = dict(stc)
        key = (dag, idx)
        base = _stage_base.get(key)
        stage = f"s{idx}"
        _STAGE_STEPS.inc(
            max(0, snap["steps"] - (base["steps"] if base else 0)),
            {"dag": dag, "stage": stage})
        if base is not None and now > base["t"]:
            wall_ns = (now - base["t"]) * 1e9
            fr = {}
            for phase in ("recv", "compute", "send"):
                fr[phase] = min(1.0, max(0, snap[phase] - base[phase])
                                / wall_ns)
                _STAGE_BUSY.set(fr[phase], {"dag": dag, "stage": stage,
                                            "phase": phase})
            busy[stage] = fr
            steps_per_s[stage] = (max(0, snap["steps"] - base["steps"])
                                  / (wall_ns / 1e9))
        snap["t"] = now
        _stage_base[key] = snap
    if row is not None:
        if edge_stats:
            row["edge_stats"] = edge_stats
        if busy and any(s for s in steps_per_s.values()):
            row["stage_busy"] = busy
            row["steps_per_s"] = steps_per_s
            row["bottleneck"] = attribute_bottleneck(busy)


def attribute_bottleneck(
        busy: Dict[str, Dict[str, float]]) -> Optional[str]:
    """The attribution rule: given ``{stage: {phase: busy fraction}}``,
    name the stage whose compute-or-send saturation bounds the steady
    state. recv (starved) time marks a victim and never scores; ties go
    to the earliest stage, so the verdict is deterministic."""
    best: Optional[str] = None
    best_score = -1.0
    for stage in sorted(busy):
        phases = busy[stage]
        score = (float(phases.get("compute", 0.0))
                 + float(phases.get("send", 0.0)))
        if score > best_score + 1e-12:
            best, best_score = stage, score
    return best


def busy_between(before: Dict[int, Dict[str, int]],
                 after: Dict[int, Dict[str, int]], wall_s: float
                 ) -> Dict[str, Dict[str, float]]:
    """The stages' busy fractions between two reads of a
    :class:`StageBlock` ``wall_s`` seconds apart."""
    out: Dict[str, Dict[str, float]] = {}
    for idx, a in after.items():
        b = before.get(idx) or dict.fromkeys(PHASES, 0)
        out[f"s{idx}"] = {p: min(1.0, max(0, a[p] - b[p]) / (wall_s * 1e9))
                          for p in ("recv", "compute", "send")}
    return out


# ------------------------------------------------------- the registry rows


def note_compiled(dag_id: str, stages: List[Dict[str, Any]],
                  edges: Dict[str, str], depth: int) -> None:
    with _lock:
        _rows[dag_id] = {"dag_id": dag_id, "stages": stages,
                         "edges": edges, "depth": depth,
                         "t_compiled": time.time(), "recoveries": 0,
                         "last_cause": None, "last_recovery_s": None}


def note_recovery(dag_id: str, cause: str, seconds: float) -> None:
    with _lock:
        row = _rows.get(dag_id)
        if row is not None:
            row["recoveries"] += 1
            row["last_cause"] = cause
            row["last_recovery_s"] = seconds


def note_torndown(dag_id: str) -> None:
    with _lock:
        _rows.pop(dag_id, None)
        dag = dag_id[:12]
        for table in (_edge_base, _stage_base):
            for key in [k for k in table if dag in k]:
                del table[key]


def rows() -> List[Dict[str, Any]]:
    """The live compiled DAGs' rows (copies)."""
    with _lock:
        return [dict(r) for r in _rows.values()]
