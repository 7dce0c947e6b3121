"""Utilities of the port: the host collectives (``util.collective``), the
process core (``util.procs``), the metrics, tracing and state APIs of
the serve trace plane (``util.metrics``, ``util.tracing``,
``util.state``), and what rides on the core's ``remote``:
``util.actor_pool`` (:class:`ActorPool`), ``util.queue`` (:class:`Queue`,
``Empty``, ``Full``), ``util.multiprocessing`` (``Pool``) and
``util.joblib`` (``register_ray``). ``ActorPool``, ``Queue``, ``Empty``
and ``Full`` are exported here, as in the JAX package, loaded at first
use."""

_EXPORTS = {"ActorPool": "actor_pool", "Queue": "queue", "Empty": "queue",
            "Full": "queue"}

__all__ = ["ActorPool", "Queue", "Empty", "Full"]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
