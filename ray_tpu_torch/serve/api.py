"""Public serve API: run, start, delete, status, shutdown and handles
(counterpart of the JAX package's ``serve/api.py``).

``serve.run`` deploys an Application graph: bound child nodes become
DeploymentHandles injected into their parents' constructors, the
controller (a thread of this process, started on first use) spawns the
replica processes, and ``run`` returns once every deployment of the
graph has its replicas ready. Everything that can refuse a graph does so
before any process is spawned: a nested class or a lambda, a bind
argument that cannot travel, a scaling policy that does not coerce, a
replica asking for more cards than are visible or free.

The ingresses run as threads of this process, one of each at most: the
HTTP proxy (``proxy.py``; ``serve.start`` or ``run(_http=True)``) and the
gRPC proxy (``grpc_proxy.py``; ``run(_grpc=True)``). Port 0 picks a free
port, which the proxy's ``port`` reports; ``shutdown`` stops both and
frees their ports.
"""
from __future__ import annotations

import atexit
import dataclasses
import pickle
import threading
import time
from typing import Any, Dict, Optional

from .. import flags
from . import controller as serve_controller
from .autoscaler import check_policy
from .deployment import (Application, callable_payload, check_picklable)
from .handle import DeploymentHandle
from .proxy import HTTPProxy

_lock = threading.Lock()
_atexit_registered = False
# This process's ingresses (one of each at most).
_proxy: Optional[HTTPProxy] = None
_grpc_proxy = None


def _get_or_create_controller() -> serve_controller.ServeController:
    global _atexit_registered
    with _lock:
        if serve_controller._local is None:
            serve_controller._local = serve_controller.ServeController()
            if not _atexit_registered:
                atexit.register(shutdown)
                _atexit_registered = True
        return serve_controller._local


def start(*, http_host: str = "127.0.0.1", http_port: int = 8000,
          detached: bool = False) -> None:
    """Start serve (the controller and the HTTP proxy) without deploying
    anything. A proxy already running keeps its port."""
    global _proxy
    ctrl = _get_or_create_controller()
    with _lock:
        if _proxy is None:
            proxy = HTTPProxy(http_host, http_port, controller=ctrl)
            proxy.start()
            _proxy = proxy


def _start_grpc(grpc_port: int) -> None:
    global _grpc_proxy
    from .grpc_proxy import GRPCProxy

    ctrl = _get_or_create_controller()
    with _lock:
        if _grpc_proxy is None:
            proxy = GRPCProxy(port=grpc_port, controller=ctrl)
            proxy.start()
            _grpc_proxy = proxy


def _node_config(dep) -> Dict[str, Any]:
    cfg = dep.config
    check_policy(dep.name, cfg.scaling_policy)
    return {"num_replicas": cfg.num_replicas,
            "max_ongoing_requests": cfg.max_ongoing_requests,
            "max_queued_requests": cfg.max_queued_requests,
            "ray_actor_options": dict(cfg.ray_actor_options or {}),
            "user_config": cfg.user_config,
            "autoscaling_config": (
                dataclasses.asdict(cfg.autoscaling_config)
                if cfg.autoscaling_config is not None else None),
            "stream": cfg.stream,
            "scaling_policy": cfg.scaling_policy,
            "pool": cfg.pool}


def run(target: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        _http: bool = False, http_port: int = 8000,
        _grpc: bool = False, grpc_port: int = 9000) -> DeploymentHandle:
    """Deploy an application graph; returns a handle to the ingress
    deployment once every deployment of the graph has its replicas
    ready (raising with the last replica error after
    ``RTPU_SERVE_READY_TIMEOUT_S``). ``route_prefix`` routes the HTTP
    and gRPC ingresses to the graph's ingress deployment; ``_http=True``
    also starts the HTTP proxy on ``http_port``, ``_grpc=True`` the gRPC
    proxy on ``grpc_port``."""
    if _grpc:
        from .grpc_proxy import import_grpc

        import_grpc()  # refuse before any spawn
    if not isinstance(target, Application):
        raise TypeError("serve.run expects Deployment.bind(...)")
    nodes = target._flatten()
    # Refusals first: none of them spawns anything.
    plans = []
    for node in nodes:
        dep = node.deployment
        plans.append((node, callable_payload(dep), _node_config(dep)))
        for i, a in enumerate(node.args):
            if not isinstance(a, Application):
                check_picklable(f"argument {i}", a, dep.name)
        for k, v in node.kwargs.items():
            if not isinstance(v, Application):
                check_picklable(f"argument {k!r}", v, dep.name)
    names = [node.deployment.name for node, _, _ in plans]
    needed = sum(serve_controller.replica_cards(
        cfg["num_replicas"], cfg["ray_actor_options"]) for _, _, cfg in plans)
    ctrl = _get_or_create_controller()
    serve_controller.check_cards(needed, ctrl.cards_held(excluding=names))

    def bound(a):
        if isinstance(a, Application):
            return DeploymentHandle(a.deployment.name,
                                    controller_address=ctrl.address)
        return a

    for node, fc, cfg in plans:
        args = tuple(bound(a) for a in node.args)
        kwargs = {k: bound(v) for k, v in node.kwargs.items()}
        payload = pickle.dumps((fc, args, kwargs, cfg["user_config"]))
        ctrl.deploy(node.deployment.name, payload, cfg,
                    route_prefix if node is target else None)
    ctrl.wait_ready(names, flags.get("RTPU_SERVE_READY_TIMEOUT_S"))
    if _http:
        start(http_port=http_port)
    if _grpc:
        _start_grpc(grpc_port)
    handle = DeploymentHandle(target.deployment.name,
                              controller_address=ctrl.address)
    if blocking:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return handle


def get_app_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


get_deployment_handle = get_app_handle


def delete(name: str) -> None:
    """Delete a deployment: its replica processes are stopped."""
    ctrl = serve_controller._local
    if ctrl is not None:
        ctrl.delete_deployment(name)


def status() -> Optional[Dict[str, Any]]:
    """Read-only: never creates a controller. Returns None when serve is
    not running, {} when it runs with zero deployments."""
    ctrl = serve_controller._local
    if ctrl is None:
        return None
    out: Dict[str, Any] = {}
    stats = ctrl.get_serve_stats()
    for n in ctrl.get_deployment_names():
        try:
            version, reps = ctrl.get_replicas(n)
        except KeyError:
            continue  # deleted meanwhile
        st = stats.get(n, {})
        out[n] = {"version": version, "num_replicas": len(reps),
                  "target": st.get("target"),
                  "pending": st.get("pending", 0),
                  "draining": st.get("draining", 0)}
    return out


def shutdown() -> None:
    """Stop the proxies (their ports are free again), delete every
    deployment and stop the controller: no replica process and no proxy
    thread is left."""
    global _proxy, _grpc_proxy
    with _lock:
        ctrl, serve_controller._local = serve_controller._local, None
        proxies = [p for p in (_proxy, _grpc_proxy) if p is not None]
        _proxy = _grpc_proxy = None
    # No new requests; open connections shut. Requests still waiting on a
    # replica end when the controller stops it; then their threads join.
    for p in proxies:
        p.close()
    if ctrl is not None:
        ctrl.shutdown()
    for p in proxies:
        p.join()
