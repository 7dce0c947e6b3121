"""Admission control for the serve router: bounded queues, per-replica
circuit breakers, and a retry budget (counterpart of the JAX package's
``serve/admission.py``).

Serve's ``max_queued_requests`` (handle-side queue bound shedding with
BackPressureError), with the classic overload pair: a consecutive-failure
circuit breaker per replica (open → cooldown → half-open probe) that the
power-of-two picker skips, and a token-bucket retry budget capped as a
fraction of admitted traffic so retries cannot amplify an outage.
Everything here is gated by ``RTPU_SERVE_ADMISSION``.

The JAX package also counts sheds, deadlines, cancels and open breakers on
its metrics plane; the port has none, so a breaker's trip and recovery go
to the log.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from .. import flags

logger = logging.getLogger(__name__)


class BackPressureError(Exception):
    """The deployment's queue bound (max_queued_requests) is exhausted:
    the request was shed WITHOUT executing. Carries ``retry_after_s``."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s

    def __reduce__(self):
        return (BackPressureError, (str(self), self.retry_after_s))


class CircuitBreaker:
    """Per-replica consecutive-failure breaker.

    closed → (threshold consecutive failures) → open → (cooldown) →
    half-open: ONE probe request passes; its success closes the breaker,
    its failure re-opens with a fresh cooldown.
    """

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.failures = 0
        self.state = "closed"
        self.opened_at = 0.0
        self._probe_inflight = False

    def allow(self, now: Optional[float] = None) -> bool:
        """May the router send this replica a request right now?"""
        if self.state == "closed":
            return True
        now = time.time() if now is None else now
        if (now - self.opened_at >= self.cooldown_s
                and not self._probe_inflight):
            # Half-open: exactly one probe at a time.
            self.state = "half_open"
            self._probe_inflight = True
            return True
        return False

    def on_success(self) -> bool:
        """Returns True when this success CLOSED an open breaker."""
        was_open = self.state != "closed"
        self.failures = 0
        self.state = "closed"
        self._probe_inflight = False
        return was_open

    def on_failure(self, now: Optional[float] = None) -> bool:
        """Returns True when this failure TRIPPED the breaker open."""
        now = time.time() if now is None else now
        self.failures += 1
        self._probe_inflight = False
        if self.state == "half_open":
            # Failed probe: straight back to open, fresh cooldown.
            self.state = "open"
            self.opened_at = now
            return False
        if self.state == "closed" and self.failures >= self.threshold:
            self.state = "open"
            self.opened_at = now
            return True
        if self.state == "open":
            self.opened_at = now
        return False


class RetryBudget:
    """Token-bucket retry budget: each ADMITTED request earns ``ratio``
    tokens (bucket capped at ``cap``); each retry spends one. During an
    outage the bucket drains and retries stop."""

    def __init__(self, ratio: Optional[float] = None, cap: float = 10.0):
        self.ratio = (flags.get("RTPU_SERVE_RETRY_BUDGET")
                      if ratio is None else float(ratio))
        self.cap = float(cap)
        self.tokens = self.cap  # start full: cold-start retries allowed
        self._lock = threading.Lock()

    def on_admitted(self) -> None:
        with self._lock:
            self.tokens = min(self.cap, self.tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False


class BreakerBoard:
    """All replica breakers of one deployment."""

    def __init__(self, deployment: str):
        self.deployment = deployment
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def _get(self, replica_id: str) -> CircuitBreaker:
        b = self._breakers.get(replica_id)
        if b is None:
            b = self._breakers[replica_id] = CircuitBreaker(
                flags.get("RTPU_SERVE_BREAKER_THRESHOLD"),
                flags.get("RTPU_SERVE_BREAKER_COOLDOWN_S"))
        return b

    def would_allow(self, replica_id: str) -> bool:
        """Non-mutating pick-time filter: closed, or open with its
        cooldown elapsed and no probe already in flight."""
        with self._lock:
            b = self._breakers.get(replica_id)
            if b is None or b.state == "closed":
                return True
            return (not b._probe_inflight
                    and time.time() - b.opened_at >= b.cooldown_s)

    def admit(self, replica_id: str) -> bool:
        """Mutating admission: an open breaker past cooldown transitions
        to half-open and claims THIS request as its single probe."""
        with self._lock:
            return self._get(replica_id).allow()

    def on_success(self, replica_id: str) -> None:
        with self._lock:
            closed = self._get(replica_id).on_success()
        if closed:
            logger.info("replica %s of %s recovered: breaker closed",
                        replica_id, self.deployment)

    def on_failure(self, replica_id: str) -> None:
        with self._lock:
            tripped = self._get(replica_id).on_failure()
        if tripped:
            logger.warning(
                "replica %s of %s tripped its circuit breaker (%s "
                "consecutive failures): routing around it", replica_id,
                self.deployment, flags.get("RTPU_SERVE_BREAKER_THRESHOLD"))

    def prune(self, live_ids) -> None:
        """Drop breakers of replicas that left the deployment."""
        live = set(live_ids)
        with self._lock:
            for rid in [r for r in self._breakers if r not in live]:
                self._breakers.pop(rid, None)
