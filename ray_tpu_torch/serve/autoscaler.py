"""Signal-driven serve autoscaler: pool sizes follow serving signals
(counterpart of the JAX package's ``serve/autoscaler.py``).

Driven by the serving signals of the controller's replica stats poll —
queue depth (submitters blocked on a slot), slot occupancy and TTFT p99
(the controller reads it from its sink's TSDB, ``_ttft_p99``) — and
evaluated through ``core/telemetry.py``'s AlertEngine, so scaling
triggers get the same threshold + for-duration semantics (and the same
state machine) as alert rules.

Each deployment that sets a ``scaling_policy`` gets a private rule set:

- scale_up_queue: queue depth >= queue_depth_high for up_for_s
- scale_up_occ:   slot occupancy >= occupancy_high for up_for_s
- scale_up_ttft:  TTFT p99 >= ttft_p99_high_s for up_for_s (optional)
- scale_down:     queue <= queue_depth_low AND occupancy <=
                  occupancy_low, sustained for down_for_s (the AND is
                  folded into one derived idle gauge so the engine's
                  per-rule machinery stays unchanged)

A firing rule becomes a ±1 replica step (a per-deployment cooldown bounds
churn); the fired state is then reset so SUSTAINED pressure fires again
after another full for-duration window: stepwise scaling, not one-shot.
The controller applies up-steps through the deployment path and
down-steps by draining a replica: it leaves the routed set at once and
stops only once idle, so no stream is cut. Each step taken counts into
``rtpu_serve_scale_events_total`` (direction up or down).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Tuple

from .. import flags
from ..core.telemetry import AlertEngine, MetricsTSDB

logger = logging.getLogger(__name__)

_scale_metrics_cache = None


def _scale_metrics():
    global _scale_metrics_cache
    if _scale_metrics_cache is None:
        from ..util.metrics import Counter

        _scale_metrics_cache = {
            "events": Counter(
                "rtpu_serve_scale_events_total",
                description="Serve autoscaler replica-count steps taken "
                            "(direction label: up | down)",
                tag_keys=("deployment", "direction")),
        }
    return _scale_metrics_cache


@dataclasses.dataclass
class ScalingPolicy:
    """Per-deployment autoscaling policy (the ``scaling_policy`` config
    key; dicts coerce through ``ScalingPolicy(**d)``)."""

    min_replicas: int = 1
    max_replicas: int = 4
    queue_depth_high: float = 4.0
    queue_depth_low: float = 0.5
    occupancy_high: float = 0.95
    occupancy_low: float = 0.5
    # <= 0 disables the TTFT trigger.
    ttft_p99_high_s: float = 0.0
    up_for_s: float = 2.0
    down_for_s: float = 10.0
    # < 0 defers to the RTPU_SERVE_SCALE_COOLDOWN_S flag.
    cooldown_s: float = -1.0


def check_policy(name: str, policy) -> Optional[ScalingPolicy]:
    """``policy`` coerced to a ScalingPolicy (None stays None; a dict
    with a field ScalingPolicy lacks raises, at deploy)."""
    if not policy:
        return None
    if isinstance(policy, dict):
        policy = ScalingPolicy(**policy)
    return policy


def _tags(name: str) -> Tuple[Tuple[str, str], ...]:
    return (("deployment", name),)


class ServeAutoscaler:
    """Owns a private MetricsTSDB ring + AlertEngine evaluated over the
    controller's per-deployment signal polls. ``step()`` returns the
    replica deltas to apply this tick."""

    def __init__(self, retain: int = 600):
        self._tsdb = MetricsTSDB(step_s=1.0, retain=retain)
        self._policies: Dict[str, ScalingPolicy] = {}
        self._engine = AlertEngine([], self._on_event)
        self._pending: List[Tuple[str, int]] = []
        self._reset_keys: List[Any] = []
        self._last_action: Dict[str, float] = {}
        self._now = 0.0

    # ---------------------------------------------------------- policies

    def configure(self, name: str, policy) -> Optional[ScalingPolicy]:
        """Register/refresh a deployment's policy (dict or ScalingPolicy;
        None/falsy forgets it). Returns the coerced policy."""
        policy = check_policy(name, policy)
        if policy is None:
            self.forget(name)
            return None
        self._policies[name] = policy
        self._engine.rules = self._build_rules()
        return policy

    def forget(self, name: str) -> None:
        if self._policies.pop(name, None) is not None:
            self._engine.rules = self._build_rules()
            self._last_action.pop(name, None)

    def policy(self, name: str) -> Optional[ScalingPolicy]:
        return self._policies.get(name)

    def _build_rules(self) -> List[dict]:
        rules: List[dict] = []
        for name, p in self._policies.items():
            tags = {"deployment": name}
            rules.append({
                "name": f"scale_up_queue:{name}",
                "metric": "serve_queue_depth", "tags": tags, "op": ">=",
                "threshold": p.queue_depth_high, "for_s": p.up_for_s,
                "severity": "INFO",
                "message": "queue depth sustained above policy high"})
            rules.append({
                "name": f"scale_up_occ:{name}",
                "metric": "serve_slot_occupancy", "tags": tags,
                "op": ">=", "threshold": p.occupancy_high,
                "for_s": p.up_for_s, "severity": "INFO",
                "message": "slot occupancy sustained above policy high"})
            if p.ttft_p99_high_s > 0:
                rules.append({
                    "name": f"scale_up_ttft:{name}",
                    "metric": "serve_ttft_p99_s", "tags": tags,
                    "op": ">=", "threshold": p.ttft_p99_high_s,
                    "for_s": p.up_for_s, "severity": "INFO",
                    "message": "TTFT p99 sustained above policy high"})
            rules.append({
                "name": f"scale_down:{name}",
                "metric": "serve_idle", "tags": tags, "op": ">=",
                "threshold": 1.0, "for_s": p.down_for_s,
                "severity": "INFO",
                "message": "pool idle (low queue + low occupancy)"})
        return rules

    # ------------------------------------------------------------- events

    def _on_event(self, severity: str, event: str, msg: str,
                  data: Optional[dict] = None) -> None:
        if event != "ALERT_FIRING" or not data:
            return
        alert = str(data.get("alert", ""))
        tags = dict(data.get("tags") or {})
        name = tags.get("deployment")
        if not name or name not in self._policies:
            return
        delta = 1 if alert.startswith("scale_up") else -1
        # Re-arm regardless of cooldown: the state machine must be able
        # to fire again after another full for-duration window.
        self._reset_keys.append((alert, tuple(sorted(tags.items()))))
        p = self._policies[name]
        cooldown = (p.cooldown_s if p.cooldown_s >= 0
                    else flags.get("RTPU_SERVE_SCALE_COOLDOWN_S"))
        last = self._last_action.get(name, -1e18)
        if self._now - last < cooldown:
            return
        self._last_action[name] = self._now
        self._pending.append((name, delta))
        _scale_metrics()["events"].inc(
            1.0, tags={"deployment": name,
                       "direction": "up" if delta > 0 else "down"})
        logger.info("serve autoscaler: %s %+d (%s: %s)", name, delta,
                    alert, msg)

    # --------------------------------------------------------------- step

    def step(self, now: float,
             signals: Dict[str, Dict[str, float]]) -> Dict[str, int]:
        """One control tick. ``signals`` maps deployment name ->
        {"queue_depth", "occupancy", optional "ttft_p99_s"} from the
        controller's replica stats poll. Returns {name: ±1} deltas (the
        controller clamps to the policy's min/max and applies them)."""
        if not flags.get("RTPU_SERVE_AUTOSCALE") or not self._policies:
            return {}
        fams: Dict[str, dict] = {
            "serve_queue_depth": {"type": "gauge", "data": {}},
            "serve_slot_occupancy": {"type": "gauge", "data": {}},
            "serve_ttft_p99_s": {"type": "gauge", "data": {}},
            "serve_idle": {"type": "gauge", "data": {}},
        }
        for name, p in self._policies.items():
            sig = signals.get(name)
            if sig is None:
                continue
            t = _tags(name)
            q = float(sig.get("queue_depth", 0.0))
            occ = float(sig.get("occupancy", 0.0))
            fams["serve_queue_depth"]["data"][t] = q
            fams["serve_slot_occupancy"]["data"][t] = occ
            ttft = sig.get("ttft_p99_s")
            if ttft is not None:
                fams["serve_ttft_p99_s"]["data"][t] = float(ttft)
            idle = 1.0 if (q <= p.queue_depth_low
                           and occ <= p.occupancy_low) else 0.0
            fams["serve_idle"]["data"][t] = idle
        self._tsdb.sample(now, fams)
        self._now = now
        self._pending = []
        self._reset_keys = []
        self._engine.evaluate(now, self._tsdb)
        for key in self._reset_keys:
            self._engine.state.pop(key, None)
        out: Dict[str, int] = {}
        for name, delta in self._pending:
            out[name] = max(-1, min(1, out.get(name, 0) + delta))
        return {n: d for n, d in out.items() if d}
