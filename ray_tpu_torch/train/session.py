"""Worker-side training session: report/get_checkpoint/get_context.

The port's copy of the JAX package's ``train/session.py`` (the reference's
_TrainSession, report, get_checkpoint, get_dataset_shard and the
TrainContext rank accessors). The session lives in the train-worker
process; ``report`` enqueues a result the trainer process drains over the
worker's pipe (``worker_group.py``). ``get_mesh`` is the port's ``DeviceMesh``, and
``start_profile``/``stop_profile`` go through ``torch.profiler`` where the
JAX package goes through ``jax.profiler``.
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .checkpoint import Checkpoint


@dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = ""
    trial_name: str = ""

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name


@dataclass
class _Session:
    context: TrainContext
    results: "queue.Queue[Dict[str, Any]]" = field(default_factory=queue.Queue)
    checkpoint: Optional[Checkpoint] = None
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    mesh: Any = None
    collective_group: Optional[str] = None
    iteration: int = 0
    stop_requested: bool = False
    profiler: Any = None  # (torch.profiler.profile, logdir) while tracing


_session_lock = threading.Lock()
_session: Optional[_Session] = None


def _init_session(context: TrainContext, checkpoint: Optional[Checkpoint] = None,
                  dataset_shards: Optional[Dict[str, Any]] = None) -> _Session:
    global _session
    with _session_lock:
        _session = _Session(context=context, checkpoint=checkpoint,
                            dataset_shards=dict(dataset_shards or {}))
        return _session


def _shutdown_session() -> None:
    global _session
    with _session_lock:
        _session = None


def _get_session(strict: bool = True) -> Optional[_Session]:
    if _session is None and strict:
        raise RuntimeError(
            "not inside a training session; this API must be called from a "
            "train_loop_per_worker function"
        )
    return _session


# ---------------------------------------------------------------- public API


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Stream metrics (and optionally a checkpoint) to the trainer process."""
    s = _get_session()
    s.iteration += 1
    s.results.put({
        "type": "report",
        "metrics": dict(metrics),
        "checkpoint": checkpoint,
        "iteration": s.iteration,
        "rank": s.context.world_rank,
    })
    if s.stop_requested:
        raise StopIteration("training stop requested by the trainer")


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from (set on restart after failure)."""
    return _get_session().checkpoint


def get_context() -> TrainContext:
    return _get_session().context


def get_dataset_shard(dataset_name: str = "train") -> Any:
    """This worker's split of a dataset passed to the trainer."""
    s = _get_session()
    shard = s.dataset_shards.get(dataset_name)
    if shard is None:
        raise KeyError(
            f"no dataset shard named {dataset_name!r}; pass datasets={{...}} "
            "to the trainer"
        )
    return shard


def get_mesh() -> Any:
    """The ``DeviceMesh`` the backend formed over the world's processes
    (None when the backend did not build one)."""
    return _get_session().mesh


def collective_group_name() -> Optional[str]:
    """Name of the host-collective group joined by this worker (backend-set)."""
    return _get_session().collective_group


def start_profile(logdir: str) -> None:
    """Start a ``torch.profiler`` capture on this train worker: host ops,
    and the card's kernels and copies where the worker has one. The trace
    is written to ``logdir`` by :func:`stop_profile`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    s = _get_session()
    if s.profiler is not None:
        raise RuntimeError("a profile is already running on this worker")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    s.profiler = (prof, logdir)


def stop_profile() -> None:
    """Stop the trace started by start_profile and write it to the logdir
    as a Chrome trace, one file per rank (view in Perfetto or
    chrome://tracing)."""
    s = _get_session()
    if s.profiler is None:
        raise RuntimeError("no profile is running on this worker")
    (prof, logdir), s.profiler = s.profiler, None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_rank{s.context.world_rank}.json"))


class profile:
    """Context manager: ``with session.profile(logdir): train_steps()``."""

    def __init__(self, logdir: str):
        self.logdir = logdir

    def __enter__(self):
        start_profile(self.logdir)
        return self

    def __exit__(self, *exc):
        # As the reference: a trace that cannot be stopped or written on
        # exit (the body stopped it, the export failed) neither raises
        # nor hides the body's own exception.
        try:
            stop_profile()
        except Exception:  # noqa: BLE001
            pass
        return False
