"""Public serve API: run, delete, status, shutdown and handles
(counterpart of the JAX package's ``serve/api.py``).

``serve.run`` deploys an Application graph: bound child nodes become
DeploymentHandles injected into their parents' constructors, the
controller (a thread of this process, started on first use) spawns the
replica processes, and ``run`` returns once every deployment of the
graph has its replicas ready. Everything that can refuse a graph does so
before any process is spawned: a nested class or a lambda, a bind
argument that cannot travel, an autoscaling config, a replica asking for
more cards than are visible or free.

The HTTP and gRPC ingresses (``proxy.py``, ``grpc_proxy.py``) come in a
later slice of the port.
"""
from __future__ import annotations

import atexit
import pickle
import threading
import time
from typing import Any, Dict, Optional

from .. import flags
from . import controller as serve_controller
from .deployment import (Application, callable_payload, check_picklable)
from .handle import DeploymentHandle

_lock = threading.Lock()
_atexit_registered = False

_INGRESS_LATER = ("the port's HTTP and gRPC ingresses (serve/proxy.py, "
                  "serve/grpc_proxy.py) come in a later slice; call the "
                  "deployment through the handle serve.run returns")


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
    """Start serve with its HTTP proxy: not in the port yet."""
    raise NotImplementedError(f"serve.start starts the HTTP proxy: "
                              f"{_INGRESS_LATER}")


def _node_config(dep) -> Dict[str, Any]:
    cfg = dep.config
    if cfg.autoscaling_config is not None or cfg.scaling_policy is not None:
        raise NotImplementedError(
            f"deployment {dep.name!r}: autoscaling (autoscaling_config, "
            "scaling_policy) comes in a later slice of the port; set "
            "num_replicas")
    return {"num_replicas": cfg.num_replicas,
            "max_ongoing_requests": cfg.max_ongoing_requests,
            "max_queued_requests": cfg.max_queued_requests,
            "ray_actor_options": dict(cfg.ray_actor_options or {}),
            "user_config": cfg.user_config,
            "stream": cfg.stream,
            "pool": cfg.pool}


def run(target: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        _http: bool = False, http_port: int = 8000,
        _grpc: bool = False, grpc_port: int = 9000) -> DeploymentHandle:
    """Deploy an application graph; returns a handle to the ingress
    deployment once every deployment of the graph has its replicas
    ready (raising with the last replica error after
    ``RTPU_SERVE_READY_TIMEOUT_S``)."""
    if _http or _grpc:
        raise NotImplementedError(_INGRESS_LATER)
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
        ctrl.deploy(node.deployment.name, payload, cfg)
    ctrl.wait_ready(names, flags.get("RTPU_SERVE_READY_TIMEOUT_S"))
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
    for n in ctrl.get_deployment_names():
        try:
            version, reps = ctrl.get_replicas(n)
        except KeyError:
            continue  # deleted meanwhile
        out[n] = {"version": version, "num_replicas": len(reps)}
    return out


def shutdown() -> None:
    """Delete every deployment and stop the controller: no replica
    process is left."""
    with _lock:
        ctrl, serve_controller._local = serve_controller._local, None
    if ctrl is not None:
        ctrl.shutdown()
