"""ServeController: the control plane (counterpart of the JAX package's
``serve/controller.py``).

It holds the target state of each deployment, keeps its replica
processes at that target (spawning them, one card each where they ask
for one, and replacing one that dies), and answers routing queries
(replica lists, versioned so routers refresh cheaply).

Where the JAX package runs it as a named actor, the port runs it in the
process that called ``serve.run``, as a thread: it watches every replica
process's pipe (its ready answer) and sentinel (its death), and listens
on an AF_UNIX address of the serve instance's temporary directory, so a
handle inside a replica process (model composition, the disaggregated
plane) can ask it for a deployment's replicas. Bytes of requests and
results never pass through it: handles connect straight to replicas.

Left for a later slice: the autoscalers (``autoscaling_config``, the
signal-driven ``scaling_policy``), the drain of scaled-down replicas,
the cluster prefix index's promotions and hot-prefix routing table, and
the metrics plane. A replica's health is its process: its sentinel.
"""
from __future__ import annotations

import itertools
import logging
import multiprocessing
import multiprocessing.connection as mpc
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..util import procs
from .replica import (ReplicaClient, authkey, error_payload, replica_main,
                      socket_address)

logger = logging.getLogger(__name__)

# Seconds between control passes when nothing happens, and the least
# time between two spawns of one deployment after a failed one.
_PASS_S = 0.2
_RESPAWN_BACKOFF_S = 1.0

# Replica processes fork from a server process that imported torch and the
# LLM side once (seconds a process otherwise). The server never starts
# CUDA, so a forked replica takes its card as a spawned one would; each
# replica gets the environment of the moment it is asked for.
_PRELOAD = ["ray_tpu_torch.serve.llm", "ray_tpu_torch.serve.disagg"]


def _replica_context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    return ctx


def _stop_fork_server() -> None:
    """Stop the fork server (multiprocessing starts it on first use and
    keeps it to the process's end), so serve leaves no process behind."""
    from multiprocessing import forkserver

    server = forkserver._forkserver
    stop = getattr(server, "_stop", None)
    if stop is None:
        # A Python whose fork server has no _stop (a private method of
        # CPython 3.8 on): the server then outlives serve; say so.
        logger.warning(
            "multiprocessing's fork server has no _stop on this Python: "
            "its process (pid %s) outlives serve.shutdown()",
            getattr(server, "_forkserver_pid", None))
        return
    stop()


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


class _Replica:
    """The controller's record of one replica process."""

    def __init__(self, worker: procs.Worker, client: ReplicaClient):
        self.worker = worker
        self.client = client
        self.ready = False
        self.stopped = False


class _DeploymentInfo:
    def __init__(self, name: str, payload: bytes, config: Dict[str, Any]):
        self.name = name
        self.payload = payload
        self.config = config
        self.target_replicas: int = int(config["num_replicas"])
        self.replicas: List[_Replica] = []  # starting and ready
        self.version = 0
        self.last_error: Optional[str] = None
        self.last_failure = 0.0
        self.spawned = 0
        # Ready replicas' start: spawn to ready, and the constructor's.
        self.starts: List[Dict[str, Any]] = []

    def ready(self) -> List[_Replica]:
        return [r for r in self.replicas if r.ready]


class ServeController:
    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="rtpu-serve-")
        self.address = socket_address(self.dir, "controller")
        self._listener = mpc.Listener(self.address, family="AF_UNIX",
                                      authkey=authkey())
        self._ctx = _replica_context()
        self._deployments: Dict[str, _DeploymentInfo] = {}
        self._cards: Dict[int, str] = {}  # card -> replica id
        self._sockets = itertools.count(1)
        self._lock = threading.Condition(threading.RLock())
        # Held around every wait on and stop of replica processes: two
        # threads reaping one process race in waitpid.
        self._procs_lock = threading.Lock()
        self._stop = threading.Event()
        self._loop = threading.Thread(target=self._control_loop,
                                      daemon=True, name="serve-controller")
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="serve-controller-listener")
        self._loop.start()
        self._accept.start()

    # ------------------------------------------------------------ deploy API

    def cards_held(self, excluding: Sequence[str] = ()) -> int:
        with self._lock:
            return sum(replica_cards(i.target_replicas,
                                     i.config.get("ray_actor_options"))
                       for n, i in self._deployments.items()
                       if n not in excluding)

    def deploy(self, name: str, payload: bytes,
               config: Dict[str, Any]) -> None:
        """Set ``name``'s target (an in-place redeploy stops the old
        replicas first) and spawn its replicas."""
        with self._lock:
            prev = self._deployments.pop(name, None)
            if prev is not None:
                self._release_cards(prev.replicas)
        if prev is not None:
            self._stop_replicas(prev.replicas)
        with self._lock:
            info = _DeploymentInfo(name, payload, config)
            if prev is not None:
                info.version = prev.version + 1
            self._deployments[name] = info
            try:
                for _ in range(info.target_replicas):
                    self._spawn_locked(info)
            except BaseException as e:
                # A spawn that fails here is the caller's to see.
                del self._deployments[name]
                self._release_cards(info.replicas)
                failed, error = info.replicas, e
            else:
                return
        self._stop_replicas(failed)
        raise error

    def wait_ready(self, names: Sequence[str], timeout: float) -> None:
        """Until every deployment of ``names`` has its target of ready
        replicas; raises with the last replica error after ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                short = [n for n in names
                         if n in self._deployments
                         and len(self._deployments[n].ready())
                         < self._deployments[n].target_replicas]
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
            if info is None:
                return
            self._release_cards(info.replicas)
        self._stop_replicas(info.replicas)

    def shutdown(self) -> None:
        """Delete every deployment (no replica process is left), stop the
        threads, remove the temporary directory."""
        self._stop.set()
        with self._lock:
            names = list(self._deployments)
        for n in names:
            self.delete_deployment(n)
        try:
            self._listener.close()
        except OSError:
            pass
        self._loop.join(timeout=10)
        _stop_fork_server()
        shutil.rmtree(self.dir, ignore_errors=True)

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
        means unbounded)."""
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                raise KeyError(f"no deployment {name!r}")
            return {"max_ongoing_requests": int(
                        info.config.get("max_ongoing_requests", 16) or 16),
                    "max_queued_requests":
                        info.config.get("max_queued_requests")}

    def get_deployment_names(self) -> List[str]:
        with self._lock:
            return list(self._deployments)

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

    _RPC = ("get_replicas", "get_routing_config", "get_deployment_names",
            "get_last_error", "get_replica_starts")

    # ----------------------------------------------------------- replicas

    def _spawn_locked(self, info: _DeploymentInfo) -> None:
        info.spawned += 1
        rid = f"{info.name}#{info.spawned}"
        card = None
        opts = info.config.get("ray_actor_options") or {}
        if replica_cards(1, opts):
            free = [c for c in range(self._card_count())
                    if c not in self._cards]
            if not free:
                raise RuntimeError(f"no free card for replica {rid}")
            card = free[0]
            self._cards[card] = rid
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

    def _reconcile_locked(self, info: _DeploymentInfo) -> None:
        now = time.monotonic()
        while len(info.replicas) < info.target_replicas:
            if now - info.last_failure < _RESPAWN_BACKOFF_S:
                return
            try:
                self._spawn_locked(info)
            except Exception:  # noqa: BLE001 — kept as the last error
                info.last_error = traceback.format_exc()
                info.last_failure = now
                return

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
                       for r in info.replicas}
        if not records:
            self._stop.wait(_PASS_S)
            with self._lock:
                for info in self._deployments.values():
                    self._reconcile_locked(info)
            return
        with self._procs_lock:
            live = [w for w, (_, r) in records.items() if not r.stopped]
            _, dead = procs.wait(live, timeout=_PASS_S)
        gone: List[_Replica] = []
        with self._lock:
            changed = False
            for w, (info, r) in records.items():
                if (self._deployments.get(info.name) is not info
                        or r not in info.replicas or r.stopped):
                    continue  # deleted or redeployed meanwhile
                if w in dead or w.ready_error is not None:
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
                self._reconcile_locked(info)
            if changed:
                self._lock.notify_all()
        if gone:
            self._stop_replicas(gone)

    # -------------------------------------------------------- the listener

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except OSError:
                return  # closed
            except Exception:  # noqa: BLE001 — a failed handshake
                continue
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="serve-controller-rpc").start()

    def _serve_conn(self, conn) -> None:
        """Answer ``(method, args)`` calls from a replica's router with
        ``("ok", value)`` or ``("err", (exception, traceback))``."""
        try:
            while True:
                method, args = pickle.loads(conn.recv_bytes())
                try:
                    if method not in self._RPC:
                        raise AttributeError(f"no controller call {method!r}")
                    reply = ("ok", getattr(self, method)(*args))
                except Exception as e:  # noqa: BLE001 — to the caller
                    reply = ("err", error_payload(e))
                conn.send_bytes(pickle.dumps(reply))
        except (EOFError, OSError):
            pass
        finally:
            conn.close()


class ControllerClient:
    """A replica process's view of the controller: its calls over the
    controller's address, one connection kept (under a lock) and opened
    again after a failure."""

    def __init__(self, address: str):
        self.address = address
        self._conn = None
        self._lock = threading.Lock()

    def _call(self, method: str, *args) -> Any:
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        self._conn = mpc.Client(self.address,
                                                family="AF_UNIX",
                                                authkey=authkey())
                    self._conn.send_bytes(pickle.dumps((method, args)))
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
        return lambda *args: self._call(name, *args)


def controller_at(address: Optional[str]):
    """The controller object for ``address``: this process's own, or a
    client of another process's."""
    if _local is not None and (address is None or address == _local.address):
        return _local
    if address is None:
        raise RuntimeError("serve is not running: call serve.run first")
    return ControllerClient(address)
