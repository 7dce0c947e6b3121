"""DeploymentHandle + Router (counterpart of the JAX package's
``serve/handle.py``).

The router keeps a local in-flight counter per replica and picks the less
loaded of two random candidates: queue-length probing without an extra
call per request. Replica lists are cached and refreshed from the
controller when they are 3 s old or a call fails.

A handle pickles to its deployment's name and the controller's address:
inside a replica process (model composition, the disaggregated plane) it
asks the controller over that address for the replica set, and then
connects straight to a replica, so request and result bytes never pass
through the driver. A call is one connection to the replica
(``serve/replica.py``): :class:`DeploymentResponse` reads its one reply,
:class:`DeploymentStreamingResponse` its items; closing either before
its end sends the replica a cancel.

The trace plane (``serve/trace.py``): ``Router.assign`` opens the
``serve.assign`` hop (ended at dispatch), under the ingress's root
(``options(trace_ctx=...)``), the enclosing request's trace (a nested
call), or, for a bare call from a driver, a root it opens itself; the
response then owns that root's ledger record and closes it with the
call's terminal status. The router also counts sheds, deadlines and
cancels (``admission.py``).
"""
from __future__ import annotations

import hashlib
import pickle
import random
import threading
import time
from typing import Any, Dict, List, Optional

from .. import flags
from . import admission
from . import context as serve_context
from . import controller as serve_controller
from . import trace
from .context import DeadlineExceededError
from .replica import (ReplicaClient, ReplicaDiedError, ReplicaError,
                      load_value, raise_remote, read_reply)


class DeploymentNotFoundError(Exception):
    """The handle's deployment no longer exists on the controller."""


class DeploymentResponse:
    """Future-like result of ``handle.remote()``: ``.result()`` blocks
    for the reply. ``file_bytes`` and ``file_load_s`` say what reading a
    result that came as a file took."""

    def __init__(self, conn, router: "Router", replica_key: str,
                 deadline_ts: Optional[float] = None, admit: bool = True):
        self._conn = conn
        self._router = router
        self._replica_key = replica_key
        self._deadline_ts = deadline_ts
        self._admit = admit
        self._done = False
        self._reply = None
        # The root trace this call owns (a bare driver call), if any.
        self._root = None
        self.file_bytes = 0
        self.file_load_s = 0.0

    def _read(self, timeout: Optional[float]):
        if self._reply is None:
            status, value = read_reply(self._conn, timeout, self._replica_key)
            if status == "ok":
                value, self.file_bytes, self.file_load_s = load_value(value)
            self._reply = (status, value)
            self._close()
        return self._reply

    def result(self, timeout: Optional[float] = None) -> Any:
        if timeout is None and self._deadline_ts is not None:
            # Default the wait to the request's remaining budget.
            timeout = max(0.0, self._deadline_ts - time.time())
        try:
            status, value = self._read(timeout)
            if status == "err":
                raise_remote(value, f"{self._router.name} replica "
                                    f"{self._replica_key}")
        except TimeoutError as e:
            if (self._deadline_ts is not None
                    and time.time() >= self._deadline_ts):
                # The request's own budget ran out: the client's
                # deadline, not a replica fault (no breaker strike).
                admission.deadline_exceeded(self._router.name)
                self._finish("deadline", error=str(e))
                raise DeadlineExceededError(
                    f"request to {self._router.name} deadline exceeded "
                    f"while awaiting the result") from e
            self._note(e)
            self._finish("error", error=str(e))
            raise
        except Exception as e:
            self._note(e)
            self._finish("deadline" if isinstance(e, DeadlineExceededError)
                         else "error", error=str(e))
            raise
        else:
            self._note(None)
            self._finish("ok")
            return value
        finally:
            self._release()

    def cancel(self) -> None:
        """Cancel the call: a request still queued on the replica never
        runs; a running one sees ``serve.context.cancelled()``."""
        self._close(cancel=True)
        admission.cancelled(self._router.name)
        self._finish("cancelled")
        self._release()

    def _finish(self, status: str, **attrs) -> None:
        if self._root is not None:
            self._root.finish(status, **attrs)

    def _close(self, cancel: bool = False) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        if cancel:
            try:
                conn.send_bytes(pickle.dumps("cancel"))
            except (OSError, ValueError):
                pass
        conn.close()

    def _note(self, err: Optional[BaseException]) -> None:
        if self._admit:
            self._router._note_result(self._replica_key, err)

    def _release(self) -> None:
        if not self._done:
            self._done = True
            self._router._on_done(self._replica_key)
            # A fire-and-forget caller never sees the outcome: its record
            # closes as ok here (the first finish wins).
            self._finish("ok")

    def __del__(self):
        # Fire-and-forget callers never call result(): without this the
        # router's in-flight count for the replica leaks and power-of-two
        # routing starves it.
        try:
            if self._reply is None and self._conn is not None:
                self._close(cancel=True)
            self._release()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


class DeploymentStreamingResponse:
    """Iterator over a streaming deployment call's items."""

    def __init__(self, conn, router: "Router", replica_key: str,
                 deadline_ts: Optional[float] = None, admit: bool = True):
        self._conn = conn
        self._router = router
        self._replica_key = replica_key
        self._deadline_ts = deadline_ts
        self._admit = admit
        self._done = False
        self._exhausted = False
        self._items = 0
        self._root = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        timeout = None
        if self._deadline_ts is not None:
            timeout = self._deadline_ts - time.time()
        try:
            if timeout is not None and timeout <= 0:
                raise TimeoutError
            status, value = read_reply(self._conn, timeout,
                                       self._replica_key)
            if status == "err":
                raise_remote(value, f"{self._router.name} replica "
                                    f"{self._replica_key}")
        except TimeoutError:
            # The consumer's budget ran out mid-stream: stop pulling and
            # close the producer (frees its engine slot).
            admission.deadline_exceeded(self._router.name)
            self._finish("deadline")
            self._release()
            raise DeadlineExceededError(
                f"stream from {self._router.name} deadline exceeded") from None
        except Exception as e:
            self._note(e)
            self._exhausted = True
            self._finish("deadline" if isinstance(e, DeadlineExceededError)
                         else "error", error=str(e))
            self._release()
            raise
        if status == "end":
            self._exhausted = True
            self._note(None)
            self._finish("ok")
            self._release()
            raise StopIteration
        self._items += 1
        return load_value(value)[0]

    def close(self) -> None:
        """The client walked away: the replica closes its producer
        generator (``GeneratorExit`` aborts the engine request, freeing
        its KV slot)."""
        if not self._done and not self._exhausted:
            admission.cancelled(self._router.name)
            self._finish("cancelled")
        self._release()

    def _finish(self, status: str, **attrs) -> None:
        if self._root is not None:
            self._root.finish(status, items=self._items, **attrs)

    def _note(self, err: Optional[BaseException]) -> None:
        if self._admit:
            self._router._note_result(self._replica_key, err)

    def _release(self) -> None:
        if self._done:
            return
        self._done = True
        # Dropped without an outcome (__del__): before its end a
        # cancellation (the first finish wins).
        self._finish("ok" if self._exhausted else "cancelled")
        conn, self._conn = self._conn, None
        if conn is not None:
            if not self._exhausted:
                try:
                    conn.send_bytes(pickle.dumps("cancel"))
                except (OSError, ValueError):
                    pass
            conn.close()
        self._router._on_done(self._replica_key)

    def __del__(self):
        try:
            self._release()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


class Router:
    REFRESH_PERIOD_S = 3.0

    def __init__(self, deployment_name: str,
                 controller_address: Optional[str] = None):
        self.name = deployment_name
        self._controller_address = controller_address
        self._lock = threading.Lock()
        self._version = -1
        self._replicas: List[ReplicaClient] = []
        self._inflight: Dict[str, int] = {}
        self._controller = None
        self._last_refresh = 0.0
        # Admission control (RTPU_SERVE_ADMISSION): per-replica circuit
        # breakers, the retry token bucket, and the deployment's queue
        # bound (refreshed with the replica list; None until fetched).
        self._board = admission.BreakerBoard(deployment_name)
        self._budget = admission.RetryBudget()
        self._max_ongoing = 16
        self._max_queued: Optional[int] = None
        # Hot-prefix routing table from the controller's PrefixIndex:
        # prefix hash -> replica ids already holding that prefix's K/V.
        self._prefix_routes: Dict[str, List[str]] = {}

    def _ctrl(self):
        if self._controller is None:
            self._controller = serve_controller.controller_at(
                self._controller_address)
        return self._controller

    def _refresh(self, force: bool = False) -> None:
        now = time.time()
        with self._lock:
            fresh = (self._replicas
                     and now - self._last_refresh < self.REFRESH_PERIOD_S)
            if fresh and not force:
                return
        try:
            version, replicas = self._ctrl().get_replicas(self.name)
        except KeyError as e:
            with self._lock:
                self._replicas = []
            raise DeploymentNotFoundError(self.name) from e
        rcfg = self._ctrl().get_routing_config(self.name)
        with self._lock:
            self._version = version
            self._replicas = replicas
            self._inflight = {r.replica_id: self._inflight.get(
                r.replica_id, 0) for r in replicas}
            self._last_refresh = now
            self._max_ongoing = int(rcfg.get("max_ongoing_requests", 16))
            mq = rcfg.get("max_queued_requests")
            self._max_queued = (flags.get("RTPU_SERVE_MAX_QUEUED")
                                if mq is None else int(mq))
            self._prefix_routes = rcfg.get("prefix_routes", {})
        self._board.prune([r.replica_id for r in replicas])

    def _breaker_filter(self, reps: List[ReplicaClient]
                        ) -> List[ReplicaClient]:
        ok = [r for r in reps if self._board.would_allow(r.replica_id)]
        if not ok:
            admission.shed(self.name, "breaker_open")
            raise admission.BackPressureError(
                f"all replicas of {self.name} have open circuit breakers",
                retry_after_s=flags.get("RTPU_SERVE_BREAKER_COOLDOWN_S"))
        return ok

    def _pick(self, use_breaker: bool = False,
              exclude: Optional[set] = None) -> ReplicaClient:
        """Power-of-two-choices over local in-flight counts; replicas that
        already failed this call are out of the draw while any other is
        left, and (admission on) so are replicas with open breakers."""
        with self._lock:
            reps = [r for r in self._replicas
                    if not exclude or r.replica_id not in exclude] \
                or self._replicas
            if not reps:
                raise RuntimeError(f"no replicas for {self.name}")
            if use_breaker:
                reps = self._breaker_filter(reps)
            if len(reps) == 1:
                r = reps[0]
            else:
                a, b = random.sample(reps, 2)
                r = a if (self._inflight.get(a.replica_id, 0)
                          <= self._inflight.get(b.replica_id, 0)) else b
            self._inflight[r.replica_id] = self._inflight.get(
                r.replica_id, 0) + 1
            return r

    def _on_done(self, key: str) -> None:
        with self._lock:
            if key in self._inflight and self._inflight[key] > 0:
                self._inflight[key] -= 1

    def _pick_affine(self, model_id: str, exclude: Optional[set] = None,
                     use_breaker: bool = False) -> ReplicaClient:
        """Model-affine pick: rendezvous hash over replicas, so one
        model's (or prefix's) requests land where it is already loaded;
        where the controller's prefix index names live replicas that
        hold this prefix's K/V, the hash runs over those alone.
        ``exclude`` holds replicas that already failed this call: the
        deterministic hash would otherwise retry the same dead one."""
        with self._lock:
            reps = [r for r in self._replicas
                    if not exclude or r.replica_id not in exclude]
            if use_breaker and reps:
                # Breaker-open replicas leave the hash ring too (affinity
                # is a preference; a tripped replica is not).
                reps = self._breaker_filter(reps)
            if not reps:
                raise RuntimeError(f"no replicas for {self.name}")
            holders = self._prefix_routes.get(model_id)
            if holders:
                reps = [r for r in reps if r.replica_id in holders] or reps
            r = max(reps, key=lambda rep: hashlib.md5(
                f"{model_id}|{rep.replica_id}".encode()).digest())
            self._inflight[r.replica_id] = self._inflight.get(
                r.replica_id, 0) + 1
            return r

    def _note_result(self, key: str, err: Optional[BaseException]) -> None:
        """Result-side accounting: successes close breakers, replica
        faults strike them; deadlines are the client's, never a
        replica's fault (they go to their counter)."""
        if err is None:
            self._board.on_success(key)
        elif isinstance(err, DeadlineExceededError):
            admission.deadline_exceeded(self.name)
        elif isinstance(err, (ReplicaDiedError, ReplicaError,
                              TimeoutError)):
            self._board.on_failure(key)

    def _admit(self) -> None:
        """Bounded-queue admission: total locally tracked in-flight
        beyond num_replicas*max_ongoing + max_queued sheds with
        BackPressureError."""
        with self._lock:
            n = len(self._replicas)
            total = sum(self._inflight.values())
            max_q = self._max_queued
            if max_q is None:
                max_q = flags.get("RTPU_SERVE_MAX_QUEUED")
        if n == 0 or max_q < 0:
            # Cold start (no replicas yet: the pick path retries) or
            # explicitly unbounded.
            self._budget.on_admitted()
            return
        cap = n * self._max_ongoing + max_q
        if total >= cap:
            admission.shed(self.name, "queue_full")
            raise admission.BackPressureError(
                f"deployment {self.name} is at capacity: {total} requests "
                f"in flight >= {n} replicas x {self._max_ongoing} ongoing "
                f"+ {max_q} queued", retry_after_s=1.0)
        self._budget.on_admitted()

    def assign(self, method_name: str, args, kwargs,
               retries: int = 3, stream: bool = False,
               multiplexed_model_id: str = "",
               deadline_ts: Optional[float] = None,
               request_id: str = "",
               trace_ctx: Optional[dict] = None):
        """Route one request: pick a replica, connect and send the call.
        A replica that cannot be reached is struck and the call goes to
        another (at most ``retries`` attempts, spending the retry
        budget).

        ``trace_ctx`` is an ingress's wire trace context; without one, a
        nested call inherits the enclosing request's trace from the serve
        context, and a bare driver call ROOTS a new trace here (named
        ``request_id``; its response then owns the ledger record)."""
        root = hop = None
        if trace.enabled():
            wire = trace_ctx or trace.current_trace_ctx()
            if wire is None:
                root = trace.start_request(
                    request_id=request_id, deployment=self.name,
                    proto="python", method=method_name)
                wire = root.trace_ctx
            hop = trace.start_hop("serve.assign", kind="router",
                                  trace_ctx=wire, deployment=self.name)
            # Downstream spans parent under the CALLER (the root or the
            # enclosing replica), not the assign hop: assign ends at
            # dispatch, so execution nested under it would be counted
            # twice in the waterfall's exclusive times.
            trace_ctx = wire
        else:
            trace_ctx = None
        try:
            resp = self._assign(method_name, args, kwargs, retries, stream,
                                multiplexed_model_id, deadline_ts,
                                trace_ctx, hop)
        except BaseException as e:
            if hop is not None:
                hop.end(error=type(e).__name__)
            if root is not None:
                root.finish("shed"
                            if isinstance(e, admission.BackPressureError)
                            else "deadline"
                            if isinstance(e, DeadlineExceededError)
                            else "error", error=str(e))
            raise
        if hop is not None:
            hop.end()
        resp._root = root
        return resp

    def _assign(self, method_name: str, args, kwargs, retries: int,
                stream: bool, multiplexed_model_id: str,
                deadline_ts: Optional[float],
                trace_ctx: Optional[dict], hop):
        if deadline_ts is None:
            # Nested composition: a handle call made INSIDE a serve
            # request inherits the enclosing request's budget.
            deadline_ts = serve_context.get_request_deadline()
        # Arrival stamp: set once at the outermost hop, inherited by
        # nested calls. The wait is forwarded as a per-process monotonic
        # delta, never as an epoch difference.
        start_ts = serve_context.get_request_start()
        assign_mono = time.monotonic()
        if start_ts is None:
            start_ts = time.time()
        if deadline_ts is not None and time.time() > deadline_ts:
            admission.deadline_exceeded(self.name)
            raise DeadlineExceededError(
                f"request to {self.name} expired before assignment")
        self._refresh()
        admit = bool(flags.get("RTPU_SERVE_ADMISSION"))
        if admit:
            self._admit()
        last_err: Optional[Exception] = None
        failed: set = set()
        for attempt in range(retries):
            if attempt > 0:
                if admit and not self._budget.try_spend():
                    break  # retry budget exhausted: surface the error
                # Jittered exponential backoff, never past the deadline.
                delay = min(0.1 * (2 ** (attempt - 1)), 2.0)
                delay *= 0.5 + random.random()
                if deadline_ts is not None:
                    delay = min(delay, max(0.0, deadline_ts - time.time()))
                time.sleep(delay)
                self._refresh(force=True)
                if deadline_ts is not None and time.time() > deadline_ts:
                    admission.deadline_exceeded(self.name)
                    raise DeadlineExceededError(
                        f"request to {self.name} expired while retrying")
            try:
                if multiplexed_model_id:
                    replica = self._pick_affine(multiplexed_model_id, failed,
                                                use_breaker=admit)
                else:
                    replica = self._pick(use_breaker=admit, exclude=failed)
            except RuntimeError as e:
                last_err = e
                continue
            rid = replica.replica_id
            if admit and not self._board.admit(rid):
                # Lost the half-open probe race: a failed attempt.
                self._on_done(rid)
                last_err = RuntimeError(f"replica {rid} breaker open")
                continue
            queue_wait = serve_context.elapsed_s()
            if queue_wait is None:
                queue_wait = time.monotonic() - assign_mono
            if hop is not None:
                hop.attributes.update(attempts=attempt + 1, replica=rid,
                                      queue_wait_s=round(queue_wait, 6))
            meta = {"multiplexed_model_id": multiplexed_model_id,
                    "deadline_ts": deadline_ts, "start_ts": start_ts,
                    "queue_wait_s": queue_wait, "trace_ctx": trace_ctx}
            try:
                conn = replica.open("stream" if stream else "request",
                                    method_name, args, kwargs, meta)
            except ReplicaDiedError as e:  # dead replica: drop + refresh
                last_err = e
                failed.add(rid)
                self._on_done(rid)
                if admit:
                    self._board.on_failure(rid)
                self._refresh(force=True)
                continue
            except BaseException:
                self._on_done(rid)
                raise
            cls = DeploymentStreamingResponse if stream else DeploymentResponse
            return cls(conn, self, rid, deadline_ts, admit)
        raise RuntimeError(
            f"could not assign request to {self.name}: {last_err}")


class DeploymentHandle:
    def __init__(self, deployment_name: str, method_name: str = "__call__",
                 stream: bool = False, multiplexed_model_id: str = "",
                 deadline_s: Optional[float] = None,
                 controller_address: Optional[str] = None,
                 request_id: str = "",
                 trace_ctx: Optional[dict] = None):
        self.deployment_name = deployment_name
        self._method_name = method_name
        self._stream = stream
        self._multiplexed_model_id = multiplexed_model_id
        self._deadline_s = deadline_s
        self._request_id = request_id
        self._trace_ctx = trace_ctx
        self._controller_address = (controller_address
                                    or serve_controller.current_address())
        self._router: Optional[Router] = None

    # Routers hold runtime state; rebuild lazily after pickling (handles
    # are injected into replica constructors for composition).
    def __getstate__(self):
        return {"deployment_name": self.deployment_name,
                "_method_name": self._method_name,
                "_stream": self._stream,
                "_multiplexed_model_id": self._multiplexed_model_id,
                "_deadline_s": self._deadline_s,
                "_controller_address": self._controller_address}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._request_id = ""
        self._trace_ctx = None
        self._router = None

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                deadline_s: Optional[float] = None,
                request_id: Optional[str] = None,
                trace_ctx: Optional[dict] = None) -> "DeploymentHandle":
        """``request_id`` names the trace a bare call roots; ``trace_ctx``
        hands over an already rooted trace (a proxy's root span), making
        the proxy, not the response, the owner of the ledger record."""
        h = DeploymentHandle(
            self.deployment_name,
            method_name if method_name is not None else self._method_name,
            stream if stream is not None else self._stream,
            (multiplexed_model_id if multiplexed_model_id is not None
             else self._multiplexed_model_id),
            deadline_s if deadline_s is not None else self._deadline_s,
            self._controller_address,
            request_id if request_id is not None else self._request_id,
            trace_ctx if trace_ctx is not None else self._trace_ctx)
        h._router = self._ensure_router()
        return h

    @property
    def method(self):
        return self._method_name

    def _ensure_router(self) -> Router:
        if self._router is None:
            self._router = Router(self.deployment_name,
                                  self._controller_address)
        return self._router

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        # Cache method handles and share THIS handle's router: a fresh
        # router per attribute access would ask the controller on every
        # call and lose the in-flight counts power-of-two depends on.
        cache = self.__dict__.setdefault("_method_cache", {})
        h = cache.get(name)
        if h is None:
            h = DeploymentHandle(self.deployment_name, name,
                                 controller_address=self._controller_address)
            h._router = self._ensure_router()
            cache[name] = h
        return h

    def remote(self, *args, **kwargs):
        deadline_ts = (None if self._deadline_s is None
                       else time.time() + self._deadline_s)
        return self._ensure_router().assign(
            self._method_name, args, kwargs, stream=self._stream,
            multiplexed_model_id=self._multiplexed_model_id,
            deadline_ts=deadline_ts, request_id=self._request_id,
            trace_ctx=self._trace_ctx)
