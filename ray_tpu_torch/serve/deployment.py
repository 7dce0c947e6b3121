"""Deployment authoring API (counterpart of the JAX package's
``serve/deployment.py``).

``@serve.deployment`` wraps a class or function in a :class:`Deployment`;
``.bind(*args)`` produces an :class:`Application` node; bound child nodes
become DeploymentHandles injected into the parent's constructor at deploy
time (model composition).

The user's class or function travels to its replica processes by plain
pickle, by reference (the port has no cloudpickle): it must be defined at
module level. Decorated at module level, the module's name for it holds
the Deployment, which :func:`callable_payload` resolves. A nested class,
a lambda, or a lambda among the bind arguments raises before any spawn,
naming itself.

A builder can give a Deployment arguments of its own (``bound_args``,
``bound_kwargs``): ``bind()`` puts them before the caller's, as the
LLM builders do with their config, params factory and options.
"""
from __future__ import annotations

import dataclasses
import importlib
import pickle
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-metric driven autoscaling: the controller steps the target
    by one replica while ongoing requests a replica stay above
    ``target_ongoing_requests`` for ``upscale_delay_s``, or below half of
    it for ``downscale_delay_s``, within [min_replicas, max_replicas]."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 10.0


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    # Queue bound ABOVE the replicas' max_ongoing capacity: requests past
    # num_replicas*max_ongoing + max_queued_requests shed with
    # BackPressureError. None defers to the RTPU_SERVE_MAX_QUEUED flag
    # default; -1 means unbounded.
    max_queued_requests: Optional[int] = None
    # {"num_gpus": 0 or 1, "num_cpus": n}: a replica with num_gpus=1 takes
    # one card; otherwise it runs torch on num_cpus threads (default 1)
    # and never starts CUDA.
    ray_actor_options: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 10.0
    user_config: Optional[Dict[str, Any]] = None
    # The handler returns a generator; calls stream item by item.
    stream: bool = False
    # Signal-driven autoscaling (serve/autoscaler.py ScalingPolicy
    # fields): queue depth and slot occupancy move the target.
    scaling_policy: Optional[Dict[str, Any]] = None
    # Pool label for the disaggregated LLM plane ("prefill" | "decode").
    pool: Optional[str] = None


class Deployment:
    def __init__(self, func_or_class: Union[type, Callable], name: str,
                 config: DeploymentConfig, bound_args: Tuple = (),
                 bound_kwargs: Optional[Dict[str, Any]] = None):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config
        self.bound_args = tuple(bound_args)
        self.bound_kwargs = dict(bound_kwargs or {})

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        name = kwargs.pop("name", self.name)
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise AttributeError(f"unknown deployment option {k!r}")
            setattr(cfg, k, v)
        return Deployment(self.func_or_class, name, cfg, self.bound_args,
                          self.bound_kwargs)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, self.bound_args + args,
                           {**self.bound_kwargs, **kwargs})

    def __repr__(self) -> str:
        return f"Deployment({self.name})"


class Application:
    """A bound deployment DAG node."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def _flatten(self, out: Optional[List["Application"]] = None
                 ) -> List["Application"]:
        """Topological list, children first."""
        out = out if out is not None else []
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, Application):
                a._flatten(out)
        if self not in out:
            out.append(self)
        return out


def deployment(
    _func_or_class: Optional[Union[type, Callable]] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Optional[int] = None,
    max_ongoing_requests: Optional[int] = None,
    max_queued_requests: Optional[int] = None,
    ray_actor_options: Optional[Dict[str, Any]] = None,
    autoscaling_config: Optional[Union[AutoscalingConfig, Dict]] = None,
    user_config: Optional[Dict[str, Any]] = None,
    stream: bool = False,
    scaling_policy: Optional[Dict[str, Any]] = None,
    pool: Optional[str] = None,
):
    """@serve.deployment decorator."""

    def wrap(fc):
        cfg = DeploymentConfig()
        cfg.stream = bool(stream)
        if scaling_policy is not None:
            cfg.scaling_policy = dict(scaling_policy)
        if pool is not None:
            cfg.pool = str(pool)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if autoscaling_config is not None:
            ac = autoscaling_config
            cfg.autoscaling_config = (
                ac if isinstance(ac, AutoscalingConfig)
                else AutoscalingConfig(**ac))
        if user_config is not None:
            cfg.user_config = dict(user_config)
        return Deployment(fc, name or fc.__name__, cfg)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


# ---------------------------------------------------- the callable by name

_HINT = ("define it at module level (a class or a function), not inside a "
         "function or as a lambda")


class _ByName:
    """A user class or function that the module's name holds as a
    Deployment (decorated at module level): pickled as (module,
    qualname) and resolved in the replica process."""

    def __init__(self, module: str, qualname: str):
        self.module = module
        self.qualname = qualname

    def __reduce__(self):
        return (_resolve, (self.module, self.qualname))


def _lookup(module: str, qualname: str) -> Any:
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _resolve(module: str, qualname: str) -> Any:
    obj = _lookup(module, qualname)
    return obj.func_or_class if isinstance(obj, Deployment) else obj


def callable_payload(dep: Deployment) -> Any:
    """What goes to the replica for ``dep``'s class or function: the
    object itself where plain pickle finds it by name, else a reference
    to the module-level Deployment that wraps it. Raises TypeError,
    naming it, where neither works."""
    fc = dep.func_or_class
    module = getattr(fc, "__module__", None)
    qualname = getattr(fc, "__qualname__", None)
    why = "it has no module-level name"
    if module and qualname and "<" not in qualname:
        try:
            found = _lookup(module, qualname)
        except (ImportError, AttributeError) as e:
            found, why = None, str(e)
        if found is fc:
            return fc
        if isinstance(found, Deployment) and found.func_or_class is fc:
            return _ByName(module, qualname)
        if found is not None:
            why = f"{module}.{qualname} is another object"
    elif qualname and "<locals>" in qualname:
        why = "it is defined inside a function"
    elif qualname and "<lambda>" in qualname:
        why = "it is a lambda"
    raise TypeError(
        f"deployment {dep.name!r}: {fc!r} cannot be sent to the replica "
        f"processes ({why}). Classes and functions go by pickle, by "
        f"reference: {_HINT}")


def check_picklable(what: str, value: Any, deployment_name: str) -> None:
    """Raise, before any spawn, where a bind argument cannot travel."""
    try:
        pickle.dumps(value)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"deployment {deployment_name!r}: {what} {value!r} cannot be "
            f"sent to the replica processes ({e}). Arguments go by pickle, "
            f"by reference: {_HINT}") from e
