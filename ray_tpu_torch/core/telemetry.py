"""Metrics history and alert rules (counterpart of the JAX package's
``core/telemetry.py``), as far as the serve autoscaler uses them.

- :class:`MetricsTSDB`: a fixed-step ring of gauge samples, one deque of
  ``(t, value)`` points a (name, tags) series, read back by name and tags
  (``query``, ``latest``);
- :class:`AlertEngine`: per (rule, series) state machine over the ring:
  condition true -> pending; pending for ``for_s`` -> ``ALERT_FIRING``
  (once); condition false or series gone -> ``ALERT_RESOLVED`` (once, only
  if it fired).

The JAX package's counters and histograms, the persistence beside the
controller's state file and the default rule set belong to the metrics
plane, which the port does not have yet.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

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


class MetricsTSDB:
    """A ring of gauge series, ``retain`` points each.

    ``sample(now, families)`` appends one point per (name, tags) series of
    ``{name: {"type": "gauge", "data": {tags_tuple: value}}}``;
    ``query(...)`` returns plottable ``[t, value]`` series."""

    def __init__(self, retain: int) -> None:
        self.retain = max(2, int(retain))
        # key -> {"type", "points": deque[(ts, value)]}
        self.series: Dict[_SeriesKey, dict] = {}

    def sample(self, now: float, families: Dict[str, dict]) -> None:
        for name, fam in families.items():
            ftype = fam.get("type", "gauge")
            if ftype != "gauge":
                raise ValueError(f"{name}: only gauges are sampled here, "
                                 f"not {ftype}s")
            for tags, value in fam.get("data", {}).items():
                key = (name, tuple(tags))
                ser = self.series.get(key)
                if ser is None:
                    if len(self.series) >= MAX_SERIES:
                        continue
                    ser = self.series[key] = {
                        "type": ftype, "points": deque(maxlen=self.retain)}
                ser["points"].append((now, float(value)))

    def query(self, name: Optional[str] = None,
              tags: Optional[Dict[str, str]] = None,
              since: Optional[float] = None) -> List[dict]:
        """Series of ``name`` whose tags include ``tags``, with their
        points since ``since``."""
        out: List[dict] = []
        want_tags = tuple(sorted((tags or {}).items()))
        for (mname, mtags), ser in self.series.items():
            if name is not None and mname != name:
                continue
            if want_tags and not set(want_tags) <= set(mtags):
                continue
            pts = [p for p in ser["points"]
                   if since is None or p[0] >= since]
            if not pts:
                continue
            out.append({"name": mname, "tags": dict(mtags),
                        "type": ser["type"], "stat": "value",
                        "points": [[t, v] for t, v in pts]})
        out.sort(key=lambda s: (s["name"], sorted(s["tags"].items())))
        return out

    def latest(self, name: str, tags: Optional[Dict[str, str]] = None
               ) -> List[Tuple[dict, float]]:
        """(series descriptor, latest value) pairs: the alert engine's
        view."""
        return [(ser, ser["points"][-1][1])
                for ser in self.query(name=name, tags=tags)
                if ser["points"]]


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
            for ser, value in tsdb.latest(rule["metric"],
                                          tags=rule.get("tags")):
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
