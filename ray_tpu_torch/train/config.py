"""Run/scaling configuration dataclasses.

The port's copy of the JAX package's ``train/config.py`` (the reference's
AIR configs: ScalingConfig, RunConfig, FailureConfig, CheckpointConfig).
Where the JAX package gives a worker TPU chips (``use_tpu``,
``tpus_per_worker``), the port gives it one card (``use_gpu``, as Ray's
own ScalingConfig): one process per card, PyTorch's process model.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    """How many train workers and what each reserves.

    ``use_gpu=True`` gives each worker one CUDA card (a worker that asks
    for more than one card through ``resources_per_worker`` is refused when
    the group starts). The port's workers are processes of one host, so
    ``placement_strategy`` can only be ``"PACK"`` or ``"STRICT_PACK"``; a
    spreading one raises rather than being ignored.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    def __post_init__(self) -> None:
        if self.placement_strategy not in ("PACK", "STRICT_PACK"):
            raise ValueError(
                f"placement_strategy {self.placement_strategy!r}: the "
                "port's workers are processes of one host; placing "
                "them across hosts waits for the control plane's port "
                "(ROADMAP item G)")

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if "CPU" not in res:
            res["CPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return {k: v for k, v in res.items() if v}


@dataclass
class FailureConfig:
    """max_failures whole-group restarts; -1 means unlimited."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Top-k retention ordered by a metric."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"

    def __post_init__(self) -> None:
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """Experiment name, storage, failure and checkpoint policy."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    callbacks: Optional[list] = None

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.expanduser("~/ray_tpu_results")
