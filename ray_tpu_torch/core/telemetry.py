"""Metrics history and alert rules (counterpart of the JAX package's
``core/telemetry.py``).

- :class:`MetricsTSDB`: a fixed-step ring of every metric family the sink
  can see, one deque of ``(t, value)`` points a (name, tags) series.
  Counters are stored cumulative and read back as per-second rates
  (clamped at zero, so a counter reset never shows as a negative spike);
  histograms are stored as cumulative bucket states and read back as
  p50/p99/mean/rate over a trailing window, by differencing the
  cumulative state across the window and interpolating inside the winning
  bucket (``_hist_delta``, ``_hist_quantile``: the PromQL
  ``histogram_quantile`` scheme; ``ray_tpu/core/telemetry.py:53``,
  ``:72``, ``:144``, ``:202``, ``:212``). The serve autoscaler's private
  ring and
  the sink's (``core/sink.py``, ``query_metrics``) are both of this class;
  the TTFT trigger reads its p99 through it.
- :class:`AlertEngine`: per (rule, series) state machine over the ring:
  condition true -> pending; pending for ``for_s`` -> ``ALERT_FIRING``
  (once); condition false or series gone -> ``ALERT_RESOLVED`` (once, only
  if it fired).

The JAX package's persistence beside the controller's state file and its
default rule set belong to its cluster controller, which the port does
not have.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

_TagTuple = Tuple[Tuple[str, str], ...]
_SeriesKey = Tuple[str, _TagTuple]

# Backstop against unbounded label cardinality: once the ring holds this
# many distinct series, new keys are dropped rather than grown.
MAX_SERIES = 4096

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


def _hist_quantile(bounds: List[float], h: Dict[str, Any], q: float) -> float:
    """Quantile ``q`` of a bucketed histogram, interpolated linearly inside
    the bucket that holds it (0 for an empty one; the last bound where
    the quantile falls in the +Inf bucket)."""
    total = h.get("count", 0)
    if not total:
        return 0.0
    target = q * total
    cum = 0.0
    lo = 0.0
    for i, b in enumerate(bounds):
        c = h["buckets"][i]
        if c and cum + c >= target:
            return lo + (b - lo) * ((target - cum) / c)
        cum += c
        lo = b
    return bounds[-1] if bounds else 0.0


def _hist_delta(new: Dict[str, Any], old: Optional[Dict[str, Any]]) -> dict:
    """Cumulative histogram state difference new - old (old=None => new).
    A reset (fewer observations than before, or another bucket grid) is
    read as the full new state."""
    if old is None:
        return {"buckets": list(new["buckets"]), "sum": new["sum"],
                "count": new["count"]}
    if (len(old["buckets"]) != len(new["buckets"])
            or new["count"] < old["count"]):
        return {"buckets": list(new["buckets"]), "sum": new["sum"],
                "count": new["count"]}
    return {
        "buckets": [max(0, n - o)
                    for n, o in zip(new["buckets"], old["buckets"])],
        "sum": max(0.0, new["sum"] - old["sum"]),
        "count": new["count"] - old["count"],
    }


class MetricsTSDB:
    """Fixed-step ring of metric families, ``retain`` points a series.

    ``sample(now, families)`` appends one point per (name, tags) series of
    ``{name: {"type", "boundaries", "data": {tags_tuple: value}}}``;
    ``query(...)`` returns plottable ``[t, value]`` series with
    counter->rate and histogram->p50/p99/mean/rate derivation done here,
    so readers (the TTFT trigger, alert rules) never touch bucket math."""

    def __init__(self, step_s: float = 1.0, retain: int = 600) -> None:
        self.step_s = max(0.05, float(step_s))
        self.retain = max(2, int(retain))
        # key -> {"type", "boundaries", "points": deque[(ts, value)]}
        # gauge/counter points hold floats; histogram points hold the
        # cumulative {"buckets", "sum", "count"} state at sample time.
        self.series: Dict[_SeriesKey, dict] = {}

    def sample(self, now: float, families: Dict[str, dict]) -> None:
        for name, fam in families.items():
            ftype = fam.get("type", "gauge")
            bounds = list(fam.get("boundaries") or ())
            for tags, value in fam.get("data", {}).items():
                key = (name, tuple(tags))
                ser = self.series.get(key)
                if ser is None:
                    if len(self.series) >= MAX_SERIES:
                        continue
                    ser = self.series[key] = {
                        "type": ftype, "boundaries": bounds,
                        "points": deque(maxlen=self.retain)}
                if isinstance(value, dict):
                    # A histogram's state is mutated in place by its
                    # owner: snapshot a copy, or every point aliases "now".
                    value = {"buckets": list(value.get("buckets", ())),
                             "sum": float(value.get("sum", 0.0)),
                             "count": int(value.get("count", 0))}
                else:
                    value = float(value)
                ser["points"].append((now, value))

    def query(self, name: Optional[str] = None,
              prefix: Optional[str] = None,
              tags: Optional[Dict[str, str]] = None,
              since: Optional[float] = None,
              stat: Optional[str] = None,
              window_s: float = 60.0,
              limit_series: int = 64) -> List[dict]:
        """Plottable series. ``stat`` picks the derived statistic for
        histograms ("p50" | "p99" | "mean" | "rate"; default emits p50 and
        p99 series) and is ignored for gauges; counters always emit their
        per-second rate plus a final cumulative "total" field."""
        out: List[dict] = []
        want_tags = tuple(sorted((tags or {}).items()))
        for (mname, mtags), ser in self.series.items():
            if name is not None and mname != name:
                continue
            if prefix is not None and not mname.startswith(prefix):
                continue
            if want_tags and not set(want_tags) <= set(mtags):
                continue
            pts = [p for p in ser["points"]
                   if since is None or p[0] >= since]
            if not pts:
                continue
            base = {"name": mname, "tags": dict(mtags),
                    "type": ser["type"]}
            if ser["type"] == "counter":
                out.append(dict(base, stat="rate", total=pts[-1][1],
                                points=self._rate_points(pts)))
            elif ser["type"] == "histogram":
                for st in ([stat] if stat else ["p50", "p99"]):
                    out.append(dict(base, stat=st,
                                    points=self._hist_points(
                                        ser, pts, st, window_s)))
            else:
                out.append(dict(base, stat="value",
                                points=[[t, v] for t, v in pts]))
            if len(out) >= limit_series:
                break
        out.sort(key=lambda s: (s["name"], sorted(s["tags"].items()),
                                s.get("stat", "")))
        return out

    def latest(self, name: str, tags: Optional[Dict[str, str]] = None,
               stat: Optional[str] = None,
               window_s: float = 60.0) -> List[Tuple[dict, float]]:
        """(series descriptor, latest value) pairs: the alert engine's
        view. Histograms default to p99 here, not the p50+p99 pair."""
        return [(ser, ser["points"][-1][1])
                for ser in self.query(name=name, tags=tags,
                                      stat=stat or "p99",
                                      window_s=window_s)
                if ser["points"]]

    def _rate_points(self, pts: List[Tuple[float, float]]) -> List[list]:
        out = []
        for i in range(1, len(pts)):
            dt = pts[i][0] - pts[i - 1][0]
            if dt <= 0:
                continue
            out.append([pts[i][0],
                        max(0.0, (pts[i][1] - pts[i - 1][1]) / dt)])
        return out

    def _hist_points(self, ser: dict, pts: List[Tuple[float, Any]],
                     stat: str, window_s: float) -> List[list]:
        bounds = ser["boundaries"]
        out = []
        for i, (t, cum) in enumerate(pts):
            # Trailing window: difference against the newest point at or
            # before t - window_s (absent for early points: since start).
            old = None
            for j in range(i - 1, -1, -1):
                if pts[j][0] <= t - window_s:
                    old = pts[j]
                    break
            d = _hist_delta(cum, old[1] if old else None)
            if stat == "rate":
                dt = (t - old[0]) if old else window_s
                v = d["count"] / dt if dt > 0 else 0.0
            elif stat == "mean":
                v = d["sum"] / d["count"] if d["count"] else 0.0
            elif stat == "p50":
                v = _hist_quantile(bounds, d, 0.5)
            else:
                v = _hist_quantile(bounds, d, 0.99)
            out.append([t, v])
        return out


class AlertEngine:
    """Evaluates rules (``{"name", "metric", "tags", "op", "threshold",
    "for_s", "severity", "message"}``) over the ring; ``emit_fn(severity,
    event, message, data=...)`` receives ``ALERT_FIRING`` and
    ``ALERT_RESOLVED``."""

    def __init__(self, rules: List[dict],
                 emit_fn: Callable[..., None]) -> None:
        self.rules = rules
        self.emit = emit_fn
        # (rule_name, tags_tuple) -> {"pending_since": ts|None,
        #                             "firing": bool, "value": float}
        self.state: Dict[Tuple[str, _TagTuple], dict] = {}

    def evaluate(self, now: float, tsdb: MetricsTSDB) -> None:
        for rule in self.rules:
            op = _OPS.get(rule.get("op", ">"), _OPS[">"])
            thresh = float(rule["threshold"])
            for_s = float(rule.get("for_s", 0.0))
            seen = set()
            for ser, value in tsdb.latest(
                    rule["metric"], tags=rule.get("tags"),
                    stat=rule.get("stat"),
                    window_s=float(rule.get("window_s", 60.0))):
                key = (rule["name"], tuple(sorted(ser["tags"].items())))
                seen.add(key)
                st = self.state.setdefault(
                    key, {"pending_since": None, "firing": False,
                          "value": 0.0})
                st["value"] = value
                if op(value, thresh):
                    if st["pending_since"] is None:
                        st["pending_since"] = now
                    if (not st["firing"]
                            and now - st["pending_since"] >= for_s):
                        st["firing"] = True
                        self._emit_firing(rule, ser, value)
                else:
                    self._clear(rule, key, st)
            # A series that stopped reporting resolves rather than staying
            # firing forever.
            for key, st in self.state.items():
                if key[0] == rule["name"] and key not in seen:
                    self._clear(rule, key, st)

    def _clear(self, rule: dict, key, st: dict) -> None:
        st["pending_since"] = None
        if st["firing"]:
            st["firing"] = False
            tags = dict(key[1])
            self.emit("INFO", "ALERT_RESOLVED",
                      f"alert {rule['name']} resolved "
                      f"({self._series_label(rule, tags)})",
                      data={"alert": rule["name"], "tags": tags,
                            "value": st.get("value", 0.0)})

    def _emit_firing(self, rule: dict, ser: dict, value: float) -> None:
        msg = rule.get("message") or (
            f"{rule['metric']} {rule.get('op', '>')} {rule['threshold']}")
        self.emit(rule.get("severity", "WARNING"), "ALERT_FIRING",
                  f"alert {rule['name']}: {msg} "
                  f"({self._series_label(rule, ser['tags'])}, "
                  f"value={value:.4g})",
                  data={"alert": rule["name"], "tags": ser["tags"],
                        "value": value, "threshold": rule["threshold"],
                        "metric": rule["metric"]})

    @staticmethod
    def _series_label(rule: dict, tags: dict) -> str:
        inner = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
        return f"{rule['metric']}{{{inner}}}" if inner else rule["metric"]
