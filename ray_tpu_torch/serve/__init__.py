"""Serve on the port's worker processes (counterpart of the JAX package's
``ray_tpu.serve``).

- ``@serve.deployment`` / ``.bind()`` graph -> deployment.py
- the controller (a thread of the driver) -> controller.py
- the replica process and ``ReplicaActor`` -> replica.py
- DeploymentHandle and the power-of-two Router -> handle.py
- ``@serve.batch`` -> batching.py
- serve.run / start / delete / status / shutdown -> api.py
- the HTTP and gRPC ingresses -> proxy.py, grpc_proxy.py
- the autoscalers -> autoscaler.py (``scaling_policy``) and the
  controller (``autoscaling_config``, the drain, pending replicas)
- ``@serve.multiplexed`` -> multiplex.py
- the LLM deployments over models/generate.py -> llm.py, disagg.py,
  prefix_cache.py, llm_engine.py
- the per-request trace plane (hop spans, ledger records) -> trace.py,
  on ``util/metrics.py``, ``util/tracing.py``, ``core/events.py`` and the
  controller's sink and ledger (read back through ``util/state.py``)
"""
import importlib

from .admission import BackPressureError
from .api import (delete, get_app_handle, get_deployment_handle, run,
                  shutdown, start, status)
from .autoscaler import ScalingPolicy
from .batching import batch
from .context import (DeadlineExceededError, get_request_context,
                      remaining_s)
from .deployment import Application, AutoscalingConfig, Deployment, deployment
from .handle import (DeploymentHandle, DeploymentResponse,
                     DeploymentStreamingResponse)
from .multiplex import get_multiplexed_model_id, multiplexed

# The LLM side loads torch and the model layer (seconds): a replica of a
# plain deployment, which imports this package, never pays for it.
_LAZY = {"build_llm_deployment": "llm",
         "build_streaming_llm_deployment": "llm",
         "build_disagg_llm_deployment": "disagg",
         "ContinuousBatchingEngine": "llm_engine",
         "PrefixCache": "prefix_cache",
         "prefix_key": "prefix_cache"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BackPressureError",
    "DeadlineExceededError",
    "get_request_context",
    "remaining_s",
    "deployment",
    "Deployment",
    "Application",
    "AutoscalingConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentStreamingResponse",
    "get_multiplexed_model_id",
    "multiplexed",
    "run",
    "start",
    "shutdown",
    "delete",
    "status",
    "get_app_handle",
    "get_deployment_handle",
    "batch",
    "build_llm_deployment",
    "build_streaming_llm_deployment",
    "build_disagg_llm_deployment",
    "ContinuousBatchingEngine",
    "PrefixCache",
    "prefix_key",
    "ScalingPolicy",
]
