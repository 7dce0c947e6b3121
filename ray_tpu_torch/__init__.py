"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside the JAX package ``ray_tpu``; it imports
``torch`` and never ``jax`` or ``ray_tpu``. Module names mirror the JAX
package (``models.transformer``, ``ops.flash_attention``,
``serve.llm_engine``, ...). Every Pallas kernel of the JAX package becomes a
hand-written Hopper kernel under ``ops/csrc/``, built at first use into
``ray_tpu_torch/_build/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

# The core's API (``core/api.py``) and ``workflow``, loaded at first use:
# importing the package stays cheap, and a process that never calls them
# loads none of them.
_CORE_API = ("init", "shutdown", "is_initialized", "remote", "get", "put",
             "wait", "kill", "get_actor", "cluster_resources", "method",
             "exit_actor", "ActorClass", "ActorHandle", "RemoteFunction",
             "RayTpuError", "TaskError", "GetTimeoutError", "ActorDiedError",
             "WorkerCrashedError")


def __getattr__(name):
    if name in _CORE_API:
        from .core import api

        return getattr(api, name)
    if name == "ObjectRef":
        from .core.serialization import ObjectRef

        return ObjectRef
    if name == "workflow":
        import importlib

        return importlib.import_module(".workflow", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
