"""A joblib backend over the core's tasks (counterpart of the JAX
package's ``util/joblib.py``): ``register_ray()`` registers
``"ray_tpu"``, and each of joblib's batches runs as one task::

    from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray_tpu"):
        Parallel(n_jobs=8)(delayed(f)(x) for x in xs)

joblib is imported at first use, so ``ray_tpu_torch.util`` imports
without it. joblib pickles the backend instance into every batch
(``BatchedCalls.__reduce__``): the backend class is module-level, made
at first use (:func:`__getattr__`), and its pickled state drops the
``Parallel`` it serves. Functions go by reference
(``core/serialization.py``), so the ones a ``Parallel`` runs are
module-level.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List

from ..core import api


@api.remote
def _run_batch(batch: Callable[[], List[Any]]) -> List[Any]:
    return batch()


class _BatchFuture:
    """joblib's handle on one batch's task."""

    def __init__(self, ref):
        self.ref = ref

    def get(self, timeout=None):
        return api.get(self.ref, timeout=timeout)


def _make_backend() -> type:
    from joblib._parallel_backends import ParallelBackendBase

    class RayTpuBackend(ParallelBackendBase):
        """Each joblib batch (a callable over bound work items) runs as
        one task; joblib's own batching spreads the task's cost. joblib
        1.3 on drives a backend through ``submit(func, callback)``."""

        supports_timeout = True
        supports_retrieve_callback = False
        uses_threads = False
        supports_sharedmem = False

        def effective_n_jobs(self, n_jobs: int) -> int:
            if not api.is_initialized():
                api.init()
            cpus = int(api.cluster_resources().get("CPU", 1))
            if n_jobs == -1 or n_jobs is None:
                return cpus
            return max(1, min(n_jobs, cpus))

        def configure(self, n_jobs: int = 1, parallel=None,
                      **kwargs: Any) -> int:
            if not api.is_initialized():
                api.init()
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def submit(self, func: Callable[[], List[Any]], callback=None):
            fut = _BatchFuture(_run_batch.remote(func))
            if callback is not None:
                # joblib schedules the next batches from the callback:
                # call it when the task is done.
                def notify():
                    try:
                        api.wait([fut.ref], num_returns=1)
                    except Exception:  # noqa: BLE001 — get() raises it
                        pass
                    callback(fut)

                threading.Thread(target=notify, daemon=True,
                                 name="rtpt-joblib-notify").start()
            return fut

        apply_async = submit  # joblib before 1.3

        def terminate(self) -> None:
            pass

        def abort_everything(self, ensure_ready: bool = True) -> None:
            if ensure_ready:
                self.configure(n_jobs=getattr(self.parallel, "n_jobs", 1),
                               parallel=self.parallel)

        def __getstate__(self):
            state = dict(self.__dict__)
            state.pop("parallel", None)  # locks, the whole Parallel
            return state

    RayTpuBackend.__module__ = __name__
    RayTpuBackend.__qualname__ = "RayTpuBackend"
    return RayTpuBackend


def _backend_class() -> type:
    cls = globals().get("RayTpuBackend")
    if cls is None:
        cls = globals()["RayTpuBackend"] = _make_backend()
    return cls


def __getattr__(name: str):
    """``RayTpuBackend``, made at first use (its base is joblib's)."""
    if name != "RayTpuBackend":
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return _backend_class()


def register_ray() -> None:
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray_tpu", _backend_class())
