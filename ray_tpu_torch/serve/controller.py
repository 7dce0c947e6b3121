"""ServeController: the control plane (counterpart of the JAX package's
``serve/controller.py``).

It holds the target state of each deployment, keeps its replica
processes at that target (spawning them, one card each where they ask
for one, and replacing one that dies), and answers routing queries
(replica lists, versioned so routers refresh cheaply; the route table
the HTTP and gRPC proxies read).

Where the JAX package runs it as a named actor, the port runs it in the
process that called ``serve.run``, as threads: one watches every replica
process's pipe (its ready answer) and sentinel (its death); one listens
on an AF_UNIX address of the serve instance's temporary directory, so a
handle inside a replica process (model composition, the disaggregated
plane) can ask it for a deployment's replicas; one runs the signal plane
once a second. Bytes of requests and results never pass through it:
handles connect straight to replicas.

The signal plane (the JAX package's control loop):

- ``_poll_stats``: every ready replica's ``stats()``, read with a
  timeout (a replica that misses it counts as saturated), gives each
  deployment its queue depth and slot occupancy and feeds the
  deployment's cluster ``PrefixIndex`` (replicas that have gone drop
  out of it);
- ``_autoscale``: ``autoscaling_config``, by ongoing requests a replica;
- ``_autoscale_signals``: ``scaling_policy`` through ``ServeAutoscaler``,
  clamped to the policy's replica range;
- ``_reap_draining``: a scaled-down replica leaves the routed set at once
  and is stopped once idle (no request running or waiting, and every
  router has refreshed since), or after RTPU_SERVE_DRAIN_DEADLINE_S; its
  card is freed only then;
- ``_promote_prefixes``: a prefix hit RTPU_PREFIX_CACHE_PROMOTE_HITS
  times across the cluster is pulled, replica to replica, by the replicas
  that lack it; routers read the holders (``prefix_routes``) and send a
  request where its K/V already lives.

Pending replicas (a divergence by design): where a deployment's target
asks for more cards than are free, the replicas past the free cards are
pending: nothing is spawned for them and no error is recorded. They are
dropped first when the target falls, and spawned when a card frees. This
is the counterpart of a JAX actor that waits for a chip.

A replica's health is its process: its sentinel.

The trace and metrics plane (a divergence by design: the JAX package keeps
it in its cluster controller) lives here too: the controller owns a
``core/sink.py`` ``MetricsSink`` (app metrics from every process of the
instance, events, spans, the ``GET /metrics`` responder on an ephemeral
port, a TSDB sampled once a second) and the request ledger
(:class:`RequestLedger`), both reached over its address. The signal plane
sets the serve plane's gauges (queue depth, replicas, slot occupancy) and
reads each TTFT-triggered deployment's p99 from the TSDB
(:meth:`ServeController._ttft_p99`), as the JAX serve controller does
(``ray_tpu/serve/controller.py:34-57``, ``:350``, ``:419-438``).
"""
from __future__ import annotations

import collections
import itertools
import logging
import multiprocessing
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import flags
from ..core import sink as core_sink
from ..core.sink import MetricsSink
from ..util import procs
from ..util.procs import listen, socket_address
from .autoscaler import ServeAutoscaler
from .replica import (ReplicaClient, ReplicaDiedError, connect,
                      error_payload, replica_main)

logger = logging.getLogger(__name__)

# Seconds between control passes when nothing happens, and the least
# time between two spawns of one deployment after a failed one.
_PASS_S = 0.2
_RESPAWN_BACKOFF_S = 1.0
# The signal plane's period, and how long it waits for a replica's stats.
_SIGNAL_S = 1.0
_STATS_TIMEOUT_S = 2.0
# A draining replica stays up at least this long: routers refresh their
# replica lists every 3 s (handle.Router.REFRESH_PERIOD_S), so a request
# a router sent from its old list still finds it.
_DRAIN_MIN_S = 3.5

# Replica processes fork from a server process that imported torch and the
# LLM side once (seconds a process otherwise). The server never starts
# CUDA, so a forked replica takes its card as a spawned one would; each
# replica gets the environment of the moment it is asked for.
_PRELOAD = ["ray_tpu_torch.serve.llm", "ray_tpu_torch.serve.disagg"]


def _replica_context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    return ctx


# This process's controller (the driver's), or, in a replica process,
# the controller's address.
_local: Optional["ServeController"] = None
_address: Optional[str] = None


def set_address(address: Optional[str]) -> None:
    global _address
    _address = address


def current_address() -> Optional[str]:
    """The address of this serve instance's controller, as seen from this
    process (None where serve is not running)."""
    if _local is not None:
        return _local.address
    return _address


def replica_cards(num_replicas: int, options: Dict[str, Any]) -> int:
    """Cards ``num_replicas`` replicas with ``ray_actor_options`` take;
    raises where the port cannot give them (a replica takes 0 or 1
    card)."""
    gpus = (options or {}).get("num_gpus", 0) or 0
    if gpus not in (0, 1):
        raise ValueError(
            f"a replica asks for {gpus} cards: the port runs one process a "
            "card, so num_gpus is 0 or 1")
    return int(gpus) * int(num_replicas)


def check_cards(needed: int, held: int = 0) -> None:
    """Raise, before any spawn, where the visible cards cannot give
    ``needed`` more replicas a card each (``held`` taken already)."""
    if not needed:
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass num_gpus=0 to run "
                           "the replicas on the CPU")
    cards = torch.cuda.device_count()
    if needed + held > cards:
        raise ValueError(
            f"{needed} replicas need {needed} cards, {cards - held} of "
            f"{cards} visible are free: each replica takes one card")


_plane_metrics_cache = None


def _plane_metrics():
    """The serve plane's gauges, set by the signal plane's stats poll:
    the autoscaler's inputs, on the shared metrics plane."""
    global _plane_metrics_cache
    if _plane_metrics_cache is None:
        from ..util.metrics import Gauge

        _plane_metrics_cache = {
            "queue": Gauge(
                "rtpu_serve_queue_depth",
                description="Requests queued for a generation slot across "
                            "a deployment's replicas (serve controller "
                            "stats poll)",
                tag_keys=("model",)),
            "replicas": Gauge(
                "rtpu_serve_replicas",
                description="Live replica count per serve deployment "
                            "(pool label: prefill | decode | main)",
                tag_keys=("deployment", "pool")),
            "occupancy": Gauge(
                "rtpu_serve_slot_occupancy",
                description="Continuous-batching slot occupancy in [0,1] "
                            "across a deployment's replicas",
                tag_keys=("model",)),
        }
    return _plane_metrics_cache


class RequestLedger:
    """Finished (and in-flight) serve requests with their hop spans: the
    JAX controller's ``_serve_ledger_row``, ``_serve_ledger_evict``,
    ``_h_serve_request_events`` and ``_h_serve_requests``
    (``ray_tpu/core/controller.py:4146-4243``)."""

    def __init__(self) -> None:
        self.serve_ledger: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()

    def _row(self, request_id: str) -> Dict[str, Any]:
        """Fetch-or-create one row. A row created by an early span (its
        record still in flight from another process) starts
        "inflight"."""
        row = self.serve_ledger.get(request_id)
        if row is None:
            row = self.serve_ledger[request_id] = {
                "request_id": request_id, "trace_id": "",
                "deployment": "", "method": "", "proto": "",
                "status": "inflight", "error": "", "start_ts": None,
                "wall_s": None, "slo_miss": False, "retained": False,
                "spans": [],
            }
            self._evict(keep=request_id)
        return row

    def _evict(self, keep: str) -> None:
        """LRU with slow-request capture: the oldest UNFLAGGED row goes
        first; retained rows (SLO miss / shed / deadline) are reclaimed
        only once every unflagged row is gone. The row just created
        (``keep``) is never the victim: the JAX controller's could pick
        it where every other row is retained, and its ingest then raised
        a KeyError on the row it was filling."""
        cap = max(16, int(flags.get("RTPU_SERVE_LEDGER_MAX")))
        while len(self.serve_ledger) > cap:
            victim = None
            for rid, row in self.serve_ledger.items():
                if not row.get("retained") and rid != keep:
                    victim = rid
                    break
            if victim is None:  # every row is retained: evict the oldest
                self.serve_ledger.popitem(last=False)
            else:
                self.serve_ledger.pop(victim, None)

    def ingest(self, spans: Sequence[dict], records: Sequence[dict]) -> None:
        """One shipped batch of hop spans and ledger records
        (``serve/trace.py``): spans fold into their request's row (128 a
        row at most), ``serve.stream`` spans contribute the token stats,
        a record sets the terminal fields and the retention flag."""
        with self._lock:
            for d in spans:
                rid = d.get("request_id")
                if not rid:
                    continue
                row = self._row(rid)
                if not row["trace_id"]:
                    row["trace_id"] = d.get("trace_id") or ""
                if len(row["spans"]) < 128:
                    row["spans"].append(d)
                if d.get("name") == "serve.stream":
                    a = d.get("attributes") or {}
                    for k in ("tokens", "ttft_s", "itl_mean_s", "itl_p50_s",
                              "itl_p99_s", "itl_max_s", "abort_cause",
                              "sent"):
                        if a.get(k) not in (None, ""):
                            row[k] = a[k]
            for r in records:
                rid = r.get("request_id")
                if not rid:
                    continue
                row = self._row(rid)
                row.update({k: r[k] for k in
                            ("trace_id", "deployment", "method", "proto",
                             "status", "error", "start_ts", "wall_s",
                             "slo_miss") if k in r})
                row["retained"] = bool(
                    r.get("slo_miss")
                    or r.get("status") in ("shed", "deadline"))
                self.serve_ledger.move_to_end(rid)

    def query(self, model: Optional[str] = None,
              status: Optional[str] = None,
              min_latency_s: Optional[float] = None,
              since: Optional[float] = None,
              request_id: Optional[str] = None,
              with_spans: bool = False,
              limit: int = 100) -> List[Dict[str, Any]]:
        """Rows, newest first. Filters: ``model`` (deployment prefix),
        ``status``, ``min_latency_s``, ``since`` (start_ts lower bound),
        ``request_id`` (prefix; includes the hop spans)."""
        with_spans = bool(with_spans or request_id)
        out = []
        with self._lock:
            for row in reversed(self.serve_ledger.values()):
                if model and not (row.get("deployment") or "").startswith(
                        model):
                    continue
                if status and row.get("status") != status:
                    continue
                if min_latency_s is not None and (
                        row.get("wall_s") is None
                        or row["wall_s"] < float(min_latency_s)):
                    continue
                if since is not None and (
                        row.get("start_ts") is None
                        or row["start_ts"] < float(since)):
                    continue
                if request_id and not row["request_id"].startswith(
                        request_id):
                    continue
                r = dict(row)
                if with_spans:
                    r["spans"] = list(row.get("spans") or ())
                else:
                    r.pop("spans", None)
                    r["n_spans"] = len(row.get("spans") or ())
                out.append(r)
                if len(out) >= int(limit):
                    break
        return out


class _Replica:
    """The controller's record of one replica process."""

    def __init__(self, worker: procs.Worker, client: ReplicaClient):
        self.worker = worker
        self.client = client
        self.ready = False
        self.stopped = False
        # Monotonic time its drain began (None: not draining).
        self.draining_since: Optional[float] = None


class _DeploymentInfo:
    def __init__(self, name: str, payload: bytes, config: Dict[str, Any]):
        self.name = name
        self.payload = payload
        self.config = config
        self.target_replicas: int = int(config["num_replicas"])
        self.replicas: List[_Replica] = []  # starting and ready
        # Scale-down victims mid-drain: out of the routed set (version
        # bump) but alive until idle or the drain deadline.
        self.draining: List[_Replica] = []
        self.version = 0
        self.last_error: Optional[str] = None
        self.last_failure = 0.0
        self.spawned = 0
        self.promotions = 0
        # Ready replicas' start: spawn to ready, and the constructor's.
        self.starts: List[Dict[str, Any]] = []
        # Drained replicas' last stats (their process meters).
        self.retired: List[Dict[str, Any]] = []
        # The latest stats poll: signals, ongoing requests, replicas read.
        self.signals: Dict[str, float] = {}
        self.ongoing = 0.0
        self.polled = 0
        # autoscaling_config bookkeeping: when the metric FIRST crossed
        # the threshold (None = currently on the other side).
        self.above_since: Optional[float] = None
        self.below_since: Optional[float] = None

    def ready(self) -> List[_Replica]:
        return [r for r in self.replicas if r.ready]

    def autoscaled(self) -> bool:
        return bool(self.config.get("autoscaling_config")
                    or self.config.get("scaling_policy"))

    def pending(self) -> int:
        """Replicas the target counts that have no process: they wait
        for a card."""
        return max(0, self.target_replicas - len(self.replicas))


class ServeController:
    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="rtpu-serve-")
        self.address = socket_address(self.dir, "controller")
        self._listener = listen(self.address)
        self._ctx = _replica_context()
        self._deployments: Dict[str, _DeploymentInfo] = {}
        self._route_prefixes: Dict[str, str] = {}  # prefix -> deployment
        self._cards: Dict[int, str] = {}  # card -> replica id
        self._sockets = itertools.count(1)
        self._lock = threading.Condition(threading.RLock())
        # Held around every wait on and stop of replica processes: two
        # threads reaping one process race in waitpid.
        self._procs_lock = threading.Lock()
        self._stop = threading.Event()
        # The listener outlives the deployments' stop: a stopping replica
        # flushes its trace and metrics over it.
        self._stop_listening = threading.Event()
        # Signal-driven pool scaling and the cluster prefix index (one a
        # deployment), both fed by the signal plane's stats poll; its
        # replica calls run on the pool.
        self._autoscaler = ServeAutoscaler()
        self._prefix_index: Dict[str, Any] = {}
        # The trace and metrics plane: the sink (with /metrics and its
        # TSDB) and the request ledger.
        self.sink = MetricsSink()
        self.sink.start()
        self.ledger = RequestLedger()
        # Every flush of this process now comes here, directly.
        core_sink.set_route(self, self.address)
        self._pool = ThreadPoolExecutor(max_workers=16,
                                        thread_name_prefix="serve-signals")
        self._loop = threading.Thread(target=self._control_loop,
                                      daemon=True, name="serve-controller")
        self._signal = threading.Thread(target=self._signal_loop,
                                        daemon=True,
                                        name="serve-controller-signals")
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="serve-controller-listener")
        self._loop.start()
        self._signal.start()
        self._accept.start()

    # ------------------------------------------------------------ deploy API

    def cards_held(self, excluding: Sequence[str] = ()) -> int:
        """Cards the deployments other than ``excluding`` hold: their
        replicas' (draining ones too) and, for a deployment of a fixed
        size, its target's."""
        with self._lock:
            held = 0
            for n, info in self._deployments.items():
                if n in excluding:
                    continue
                cards = sum(r.client.card is not None
                            for r in info.replicas + info.draining)
                if not info.autoscaled():
                    cards = max(cards, replica_cards(
                        info.target_replicas,
                        info.config.get("ray_actor_options")))
                held += cards
            return held

    def deploy(self, name: str, payload: bytes, config: Dict[str, Any],
               route_prefix: Optional[str] = None) -> None:
        """Set ``name``'s target (an in-place redeploy stops the old
        replicas first), route ``route_prefix`` to it, and spawn its
        replicas (those past the free cards stay pending)."""
        with self._lock:
            self._autoscaler.configure(name, config.get("scaling_policy"))
            prev = self._deployments.pop(name, None)
            if prev is not None:
                self._release_cards(prev.replicas + prev.draining)
        if prev is not None:
            self._stop_replicas(prev.replicas + prev.draining)
        with self._lock:
            info = _DeploymentInfo(name, payload, config)
            if prev is not None:
                info.version = prev.version + 1
            self._deployments[name] = info
            if route_prefix:
                self._route_prefixes[route_prefix] = name
            try:
                for _ in range(info.target_replicas):
                    card = self._card_for(info)
                    if card is False:
                        break
                    self._spawn_locked(info, card)
            except BaseException as e:
                # A spawn that fails here is the caller's to see.
                del self._deployments[name]
                self._drop_routes(name)
                self._release_cards(info.replicas)
                failed, error = info.replicas, e
            else:
                return
        self._stop_replicas(failed)
        raise error

    def wait_ready(self, names: Sequence[str], timeout: float) -> None:
        """Until every deployment of ``names`` has its spawned replicas
        ready (pending ones aside); raises with the last replica error
        after ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                short = [n for n in names
                         if n in self._deployments
                         and len(self._deployments[n].ready())
                         < max(1, self._deployments[n].target_replicas
                               - self._deployments[n].pending())]
                if not short:
                    return
                left = deadline - time.monotonic()
                if left <= 0:
                    info = self._deployments[short[0]]
                    raise RuntimeError(
                        f"deployment {info.name!r} has {len(info.ready())} "
                        f"of {info.target_replicas} replicas ready after "
                        f"{timeout:g}s; last replica error: "
                        f"{info.last_error}")
                self._lock.wait(min(left, 0.5))

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            info = self._deployments.pop(name, None)
            self._drop_routes(name)
            self._autoscaler.forget(name)
            self._prefix_index.pop(name, None)
            if info is None:
                return
            self._release_cards(info.replicas + info.draining)
        self._stop_replicas(info.replicas + info.draining)

    def shutdown(self) -> None:
        """Delete every deployment (no replica process is left), stop the
        threads, remove the temporary directory."""
        self._stop.set()
        with self._lock:
            names = list(self._deployments)
        for n in names:
            self.delete_deployment(n)
        self._stop_listening.set()
        try:
            # Wake the accept thread (it then sees the stop), then close.
            connect(self.address).close()
        except OSError:
            pass
        self._accept.join(timeout=10)
        self._listener.close()
        self._loop.join(timeout=10)
        self._signal.join(timeout=10)
        self._pool.shutdown(wait=True, cancel_futures=True)
        core_sink.set_route()
        self.sink.stop()
        procs.stop_fork_server()
        shutil.rmtree(self.dir, ignore_errors=True)

    def _drop_routes(self, name: str) -> None:
        self._route_prefixes = {p: d for p, d in self._route_prefixes.items()
                                if d != name}

    # -------------------------------------------------------------- routing

    def get_replicas(self, name: str) -> Tuple[int, List[ReplicaClient]]:
        """(version, ready replicas) — routers cache until version bumps."""
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                raise KeyError(f"no deployment {name!r}")
            return info.version, [r.client for r in info.ready()]

    def get_routing_config(self, name: str) -> Dict[str, Any]:
        """Admission-relevant config: replica concurrency bound and the
        queued-request bound (None defers to RTPU_SERVE_MAX_QUEUED; -1
        means unbounded); where the deployment's replicas report a
        prefix cache, the hot-prefix table ``prefix_routes`` (hash ->
        holder replica ids)."""
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                raise KeyError(f"no deployment {name!r}")
            out = {"max_ongoing_requests": int(
                       info.config.get("max_ongoing_requests", 16) or 16),
                   "max_queued_requests":
                       info.config.get("max_queued_requests")}
            idx = self._prefix_index.get(name)
        if idx is not None:
            out["prefix_routes"] = idx.routes()
        return out

    def get_deployment_names(self) -> List[str]:
        with self._lock:
            return list(self._deployments)

    def get_route_table(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._route_prefixes)

    def get_route_info(self) -> Dict[str, Dict[str, Any]]:
        """The route table with what the proxies need of each deployment
        (its stream flag: chunked responses)."""
        with self._lock:
            out = {}
            for prefix, name in self._route_prefixes.items():
                info = self._deployments.get(name)
                out[prefix] = {"name": name, "stream": bool(
                    info and info.config.get("stream"))}
            return out

    def get_last_error(self, name: str) -> Optional[str]:
        with self._lock:
            info = self._deployments.get(name)
            return info.last_error if info else None

    def get_replica_starts(self, name: str) -> List[Dict[str, Any]]:
        """Each ready replica's start: replica id, pid, card, spawn to
        ready seconds and the constructor's seconds."""
        with self._lock:
            info = self._deployments.get(name)
            return [dict(s) for s in info.starts] if info else []

    def get_retired(self, name: str) -> List[Dict[str, Any]]:
        """Each drained replica's id, drain seconds and last stats."""
        with self._lock:
            info = self._deployments.get(name)
            return [dict(s) for s in info.retired] if info else []

    def get_serve_stats(self) -> Dict[str, Any]:
        """Per deployment: replica counts (live, ready, target, pending,
        draining, spawned so far), the pool label, prefix promotions and
        the latest polled signals."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, info in self._deployments.items():
                d = {"replicas": len(info.replicas),
                     "ready": len(info.ready()),
                     "target": info.target_replicas,
                     "pending": info.pending(),
                     "draining": len(info.draining),
                     "spawned": info.spawned,
                     "pool": info.config.get("pool") or "main",
                     "promotions": info.promotions}
                d.update(info.signals)
                out[name] = d
        return out

    # --------------------------------------------- the trace/metrics plane

    def metric_update(self, metrics: List[dict]) -> None:
        self.sink.metric_update(metrics)

    def cluster_events(self, events: List[dict]) -> None:
        self.sink.cluster_events(events)

    def cluster_spans(self, spans: List[dict]) -> None:
        self.sink.cluster_spans(spans)

    def get_spans(self, trace_id: Optional[str] = None,
                  limit: int = 10000) -> List[dict]:
        return self.sink.get_spans(trace_id, limit)

    def query_metrics(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.sink.query_metrics(*args, **kwargs)

    def metrics_address(self) -> Optional[str]:
        return self.sink.address

    def serve_request_events(self, spans: Sequence[dict],
                             records: Sequence[dict]) -> None:
        self.ledger.ingest(spans, records)

    def serve_requests(self, **filters: Any) -> List[Dict[str, Any]]:
        return self.ledger.query(**filters)

    _RPC = ("get_replicas", "get_routing_config", "get_deployment_names",
            "get_last_error", "get_replica_starts", "metric_update",
            "cluster_events", "cluster_spans", "get_spans", "query_metrics",
            "metrics_address", "serve_request_events", "serve_requests")

    # ----------------------------------------------------------- replicas

    def _card_for(self, info: _DeploymentInfo):
        """The card a new replica of ``info`` takes: None where it takes
        none, False where none is free."""
        if not replica_cards(1, info.config.get("ray_actor_options")):
            return None
        for c in range(self._card_count()):
            if c not in self._cards:
                return c
        return False

    def _spawn_locked(self, info: _DeploymentInfo,
                      card: Optional[int]) -> None:
        info.spawned += 1
        rid = f"{info.name}#{info.spawned}"
        if card is not None:
            self._cards[card] = rid
        opts = info.config.get("ray_actor_options") or {}
        num_threads = max(1, int(opts.get("num_cpus", 1) or 1))
        address = socket_address(self.dir, f"replica-{next(self._sockets)}")
        worker = procs.Worker(
            self._ctx, replica_main,
            (info.payload, card, num_threads, address, self.dir, rid,
             int(info.config.get("max_ongoing_requests", 16) or 16),
             self.address, dict(os.environ)),
            f"rtpu-serve-replica-{rid}")
        info.replicas.append(_Replica(worker, ReplicaClient(
            rid, address, info.name, worker.pid, card)))

    @staticmethod
    def _card_count() -> int:
        import torch

        return torch.cuda.device_count()

    def _release_cards(self, replicas: Sequence[_Replica]) -> None:
        for r in replicas:
            if r.client.card is not None:
                self._cards.pop(r.client.card, None)

    def _stop_replicas(self, replicas: Sequence[_Replica]) -> None:
        with self._procs_lock:
            for r in replicas:
                r.stopped = True
            procs.stop([r.worker for r in replicas])

    def _reconcile_locked(self, info: _DeploymentInfo) -> List[_Replica]:
        """Move ``info`` toward its target: past it, starting replicas
        stop and ready ones drain; short of it, spawn while cards allow
        (the rest stay pending). Returns the replicas to stop."""
        now = time.monotonic()
        stop: List[_Replica] = []
        while len(info.replicas) > info.target_replicas:
            starting = [r for r in info.replicas if not r.ready]
            r = starting[-1] if starting else info.replicas[-1]
            info.replicas.remove(r)
            if r.ready:
                r.draining_since = now
                info.draining.append(r)
                info.version += 1
            else:
                self._release_cards([r])
                stop.append(r)
        while len(info.replicas) < info.target_replicas:
            if now - info.last_failure < _RESPAWN_BACKOFF_S:
                break
            card = self._card_for(info)
            if card is False:
                break  # pending until a card frees
            try:
                self._spawn_locked(info, card)
            except Exception:  # noqa: BLE001 — kept as the last error
                info.last_error = traceback.format_exc()
                info.last_failure = now
                break
        return stop

    # ------------------------------------------------------------ the loop

    def _control_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._control_pass()
            except Exception:  # noqa: BLE001 — the loop goes on
                logger.exception("serve control loop error")
                time.sleep(_PASS_S)

    def _control_pass(self) -> None:
        with self._lock:
            records = {r.worker: (info, r)
                       for info in self._deployments.values()
                       for r in info.replicas + info.draining}
        dead: set = set()
        if not records:
            self._stop.wait(_PASS_S)
        else:
            with self._procs_lock:
                live = [w for w, (_, r) in records.items() if not r.stopped]
                _, dead = procs.wait(live, timeout=_PASS_S)
        gone: List[_Replica] = []
        with self._lock:
            changed = False
            for w, (info, r) in records.items():
                if self._deployments.get(info.name) is not info or r.stopped:
                    continue  # deleted or redeployed meanwhile
                died = w in dead or w.ready_error is not None
                if r in info.draining:
                    if died:
                        info.draining.remove(r)
                        self._release_cards([r])
                        gone.append(r)
                    continue
                if r not in info.replicas:
                    continue
                if died:
                    info.replicas.remove(r)
                    self._release_cards([r])
                    gone.append(r)
                    info.last_failure = time.monotonic()
                    info.last_error = (
                        w.ready_error if w.ready_error is not None else
                        f"replica {r.client.replica_id} (pid {w.pid}) died, "
                        f"exit code {w.proc.exitcode}")
                    if r.ready:
                        info.version += 1
                        logger.warning("%s; replacing it", info.last_error)
                    changed = True
                elif w.ready is not None and not r.ready:
                    r.ready = True
                    info.version += 1
                    info.starts.append({
                        "replica_id": r.client.replica_id,
                        "pid": w.pid, "card": r.client.card,
                        "spawn_s": w.ready["t_ready"] - w.t_start,
                        "init_s": w.ready["init_s"]})
                    changed = True
            for info in self._deployments.values():
                gone += self._reconcile_locked(info)
            if changed or gone:
                self._lock.notify_all()
        if gone:
            self._stop_replicas(gone)

    # ------------------------------------------------------- signal plane

    def _signal_loop(self) -> None:
        while not self._stop.wait(_SIGNAL_S):
            try:
                now = time.time()
                signals = self._poll_stats()
                self._autoscale(now)
                self._autoscale_signals(now, signals)
                self._reap_draining()
                self._promote_prefixes()
            except Exception:  # noqa: BLE001 — the loop goes on
                logger.exception("serve signal loop error")

    def _ready_clients(self) -> List[Tuple[_DeploymentInfo,
                                           List[ReplicaClient]]]:
        with self._lock:
            return [(info, [r.client for r in info.ready()])
                    for info in self._deployments.values()]

    def _poll_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-deployment serving signals from the ready replicas'
        ``stats()``: queue depth (blocked submitters), slot occupancy,
        ongoing requests, and prefix-cache holdings (folded into the
        deployment's PrefixIndex). A replica that misses the poll counts
        as saturated: full slots and one waiting request."""
        snapshot = self._ready_clients()
        answers = self._stats_of([c for _, cs in snapshot for c in cs])
        signals: Dict[str, Dict[str, float]] = {}
        for info, clients in snapshot:
            polled, saturated = [], 0
            for c in clients:
                st = answers[c.replica_id]
                if st is _MISSED:
                    saturated += 1
                elif isinstance(st, dict):
                    polled.append((c.replica_id, st))
                # else it raised: gone (its sentinel tells the control
                # loop) or a stats() fault of its own.
            queue = busy = total = float(saturated)
            ongoing = 0.0
            idx = self._prefix_index.get(info.name)
            for rid, st in polled:
                ongoing += float(st.get("ongoing", 0))
                serve = st.get("serve") or {}
                queue += float(serve.get("queued", 0.0))
                if serve.get("slots_total"):
                    busy += float(serve.get("slots_busy", 0.0))
                    total += float(serve["slots_total"])
                pref = serve.get("prefix")
                if pref:
                    if idx is None:
                        from .prefix_cache import PrefixIndex

                        idx = PrefixIndex()
                    idx.update_replica(rid, pref.get("holders") or [],
                                       pref.get("hot") or {})
            if idx is not None:
                live = {c.replica_id for c in clients}
                for rid in idx.replica_ids():
                    if rid not in live:
                        idx.drop_replica(rid)
            sig = {"queue_depth": queue,
                   "occupancy": (busy / total) if total else 0.0}
            p = self._autoscaler.policy(info.name)
            if p is not None and p.ttft_p99_high_s > 0:
                ttft = self._ttft_p99(info.name)
                if ttft is not None:
                    sig["ttft_p99_s"] = ttft
            with self._lock:
                if self._deployments.get(info.name) is not info:
                    continue  # deleted or redeployed meanwhile
                if idx is not None:
                    self._prefix_index[info.name] = idx
                info.signals = sig
                info.ongoing = ongoing
                info.polled = len(clients)
                pool = info.config.get("pool") or "main"
                n_replicas = len(info.replicas)
            signals[info.name] = sig
            m = _plane_metrics()
            m["queue"].set(queue, tags={"model": info.name})
            m["replicas"].set(float(n_replicas),
                              tags={"deployment": info.name, "pool": pool})
            if total:
                m["occupancy"].set(sig["occupancy"],
                                   tags={"model": info.name})
        return signals

    def _ttft_p99(self, name: str, window_s: float = 30.0
                  ) -> Optional[float]:
        """The deployment's latest TTFT p99 over the last ``window_s``
        from the sink's TSDB (None before any TTFT); the signal plane
        reads it only where the policy triggers on it."""
        res = self.sink.query_metrics(
            name="rtpu_serve_ttft_s", tags={"model": name}, stat="p99",
            window_s=window_s)
        for ser in res["series"]:
            pts = ser.get("points") or []
            if pts:
                return float(pts[-1][1])
        return None

    def _stats_of(self, clients: Sequence[ReplicaClient]
                  ) -> Dict[str, Any]:
        """Each replica's ``stats()``, read on the pool within one
        _STATS_TIMEOUT_S for all: its dict, the exception it raised, or
        _MISSED where no answer came in time (a replica whose threads are
        all busy answers late, its connection's handshake included; the
        call runs on and its answer is dropped)."""
        futs = {c.replica_id: self._pool.submit(
            c.call, "stats", timeout=_STATS_TIMEOUT_S) for c in clients}
        wait(futs.values(), timeout=_STATS_TIMEOUT_S)
        out: Dict[str, Any] = {}
        for rid, fut in futs.items():
            if not fut.done():
                fut.add_done_callback(_drop_result)
                out[rid] = _MISSED
            elif fut.exception() is not None:
                out[rid] = (_MISSED if isinstance(fut.exception(),
                                                  TimeoutError)
                            else fut.exception())
            else:
                out[rid] = fut.result()
        return out

    def _autoscale(self, now: float) -> None:
        """``autoscaling_config``: ongoing requests a ready replica
        against ``target_ongoing_requests``, sustained for the up/down
        delays, step the target by one within the replica range."""
        with self._lock:
            for info in self._deployments.values():
                ac = info.config.get("autoscaling_config")
                if not ac:
                    continue
                per = info.ongoing / max(1, info.polled)
                target = info.target_replicas
                if per > ac["target_ongoing_requests"]:
                    info.below_since = None
                    if info.above_since is None:
                        info.above_since = now
                    if now - info.above_since >= ac["upscale_delay_s"]:
                        target = min(ac["max_replicas"],
                                     info.target_replicas + 1)
                        info.above_since = now  # a fresh window each step
                elif per < ac["target_ongoing_requests"] * 0.5:
                    info.above_since = None
                    if info.below_since is None:
                        info.below_since = now
                    if now - info.below_since >= ac["downscale_delay_s"]:
                        target = max(ac["min_replicas"],
                                     info.target_replicas - 1)
                        info.below_since = now
                else:
                    info.above_since = None
                    info.below_since = None
                info.target_replicas = target

    def _autoscale_signals(self, now: float,
                           signals: Dict[str, Dict[str, float]]) -> None:
        """The signal-driven autoscaler's ±1 steps, clamped to each
        policy's replica range; the control loop realizes them, up by
        spawning (or leaving pending), down by draining."""
        with self._lock:
            for name, d in self._autoscaler.step(now, signals).items():
                info = self._deployments.get(name)
                p = self._autoscaler.policy(name)
                if info is None or p is None:
                    continue
                new = max(p.min_replicas,
                          min(p.max_replicas, info.target_replicas + d))
                if new != info.target_replicas:
                    logger.info("serve autoscaler: %s %d -> %d replicas",
                                name, info.target_replicas, new)
                    info.target_replicas = new

    def _reap_draining(self) -> None:
        """Stop draining replicas that went idle (no request running or
        waiting, read once every router has refreshed since the drain
        began) or overstayed RTPU_SERVE_DRAIN_DEADLINE_S; their cards are
        freed then. A live replica that does not answer keeps draining:
        the deadline decides."""
        with self._lock:
            snapshot = [(info, list(info.draining))
                        for info in self._deployments.values()
                        if info.draining]
        grace = flags.get("RTPU_SERVE_DRAIN_DEADLINE_S")
        now = time.monotonic()
        answers = self._stats_of([r.client for _, victims in snapshot
                                  for r in victims
                                  if now - r.draining_since >= _DRAIN_MIN_S])
        for info, victims in snapshot:
            for r in victims:
                age = time.monotonic() - r.draining_since
                final = answers.get(r.client.replica_id)
                if isinstance(final, dict):
                    reap = final["ongoing"] + final["queued"] == 0
                else:
                    # Gone: nothing left to drain. Late or failing: a live
                    # replica keeps draining; the deadline decides.
                    reap = isinstance(final, ReplicaDiedError)
                    final = {}
                if not (reap or age >= grace):
                    continue
                with self._lock:
                    if r not in info.draining:
                        continue  # died or deleted meanwhile
                    info.draining.remove(r)
                    self._release_cards([r])
                    info.retired.append({
                        "replica_id": r.client.replica_id,
                        "card": r.client.card, "drain_s": age,
                        "stats": final})
                    self._lock.notify_all()
                self._stop_replicas([r])

    def _promote_prefixes(self) -> None:
        """Cluster-hot prefixes: replicas missing one pull it straight
        from a holder replica (bytes move replica to replica, never
        through the controller); the pulls run on the pool."""
        if not flags.get("RTPU_PREFIX_CACHE"):
            return
        threshold = int(flags.get("RTPU_PREFIX_CACHE_PROMOTE_HITS"))
        for info, clients in self._ready_clients():
            idx = self._prefix_index.get(info.name)
            if idx is None or len(clients) < 2:
                continue
            by_rid = {c.replica_id: c for c in clients}
            for h, holder_rid, target_rid in idx.promotions(
                    list(by_rid), threshold=threshold):
                holder = by_rid.get(holder_rid)
                target = by_rid.get(target_rid)
                if holder is None or target is None:
                    continue
                with self._lock:
                    info.promotions += 1
                self._pool.submit(target.handle_request, "pull_prefix",
                                  (h, holder), {}, timeout=60.0
                                  ).add_done_callback(_log_failed_pull)

    # -------------------------------------------------------- the listener

    def _accept_loop(self) -> None:
        # shutdown() wakes this thread before it closes the listener, so
        # an error here is one connection's (a caller that went away
        # during the handshake raises an OSError out of accept()).
        while not self._stop_listening.is_set():
            try:
                conn = self._listener.accept()
            except OSError:
                time.sleep(0.001)  # no busy loop on a persistent error
                continue
            except Exception:  # noqa: BLE001 — a failed handshake
                continue
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="serve-controller-rpc").start()

    def _serve_conn(self, conn) -> None:
        """Answer ``(method, args[, kwargs])`` calls from another
        process (a replica's router, its flushers) with ``("ok", value)``
        or ``("err", (exception, traceback))``."""
        try:
            while True:
                method, args, *kwargs = pickle.loads(conn.recv_bytes())
                try:
                    if method not in self._RPC:
                        raise AttributeError(f"no controller call {method!r}")
                    reply = ("ok", getattr(self, method)(
                        *args, **(kwargs[0] if kwargs else {})))
                except Exception as e:  # noqa: BLE001 — to the caller
                    reply = ("err", error_payload(e))
                conn.send_bytes(pickle.dumps(reply))
        except (EOFError, OSError):
            pass
        finally:
            conn.close()


_MISSED = object()  # a stats() answer that did not come in time


def _drop_result(fut) -> None:
    if not fut.cancelled():
        fut.exception()  # read, so that no failure goes unretrieved


def _log_failed_pull(fut) -> None:
    try:
        fut.result()
    except Exception:  # noqa: BLE001 — a promotion is best effort
        logger.warning("prefix promotion failed", exc_info=True)


class ControllerClient:
    """A replica process's view of the controller: its calls over the
    controller's address, one connection kept (under a lock) and opened
    again after a failure."""

    def __init__(self, address: str):
        self.address = address
        self._conn = None
        self._lock = threading.Lock()

    def _call(self, method: str, *args, **kwargs) -> Any:
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        self._conn = connect(self.address)
                    self._conn.send_bytes(pickle.dumps((method, args,
                                                        kwargs)))
                    status, value = pickle.loads(self._conn.recv_bytes())
                    break
                except (OSError, EOFError):
                    if self._conn is not None:
                        self._conn.close()
                    self._conn = None
                    if attempt:
                        raise
        if status == "err":
            exc_bytes, tb = value
            raise (pickle.loads(exc_bytes) if exc_bytes is not None
                   else RuntimeError(f"serve controller: {method} raised:\n"
                                     f"{tb}"))
        return value

    def __getattr__(self, name: str):
        if name not in ServeController._RPC:
            raise AttributeError(name)
        return lambda *args, **kwargs: self._call(name, *args, **kwargs)


def controller_at(address: Optional[str]):
    """The controller object for ``address``: this process's own, or a
    client of another process's."""
    if _local is not None and (address is None or address == _local.address):
        return _local
    if address is None:
        raise RuntimeError("serve is not running: call serve.run first")
    return ControllerClient(address)
