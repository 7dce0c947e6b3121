"""Experiment storage + top-k checkpoint retention.

The port's copy of the JAX package's ``train/storage.py`` (the reference's
StorageContext and top-k _CheckpointManager by metric). Local paths: the
port's workers are processes of one host, so the trainer process copies a
worker's checkpoint directory into storage by path.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .checkpoint import Checkpoint
from .config import CheckpointConfig


@dataclass
class StorageContext:
    """Resolves where experiment artifacts live.

    storage_path/experiment_name/trial_name/checkpoint_000NNN
    """

    storage_path: str
    experiment_name: str
    trial_name: str = ""

    @property
    def experiment_dir(self) -> str:
        return os.path.join(self.storage_path, self.experiment_name)

    @property
    def trial_dir(self) -> str:
        d = os.path.join(self.experiment_dir, self.trial_name) if self.trial_name \
            else self.experiment_dir
        os.makedirs(d, exist_ok=True)
        return d

    def checkpoint_dir(self, index: int) -> str:
        return os.path.join(self.trial_dir, f"checkpoint_{index:06d}")

    def persist(self, checkpoint: Checkpoint, index: int) -> Checkpoint:
        """Copy a worker-local checkpoint dir into durable storage."""
        dest = self.checkpoint_dir(index)
        if os.path.abspath(checkpoint.path) == os.path.abspath(dest):
            return checkpoint
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
        return Checkpoint(dest)


@dataclass
class TrackedCheckpoint:
    checkpoint: Checkpoint
    index: int
    metrics: Dict[str, Any] = field(default_factory=dict)


class CheckpointManager:
    """Top-k retention ordered by CheckpointConfig's score attribute
    (reference: train/_internal/checkpoint_manager.py)."""

    def __init__(self, storage: StorageContext, config: Optional[CheckpointConfig] = None):
        self.storage = storage
        self.config = config or CheckpointConfig()
        self.tracked: List[TrackedCheckpoint] = []
        self._index = 0

    @property
    def latest(self) -> Optional[TrackedCheckpoint]:
        return max(self.tracked, key=lambda t: t.index, default=None)

    @property
    def best(self) -> Optional[TrackedCheckpoint]:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return self.latest
        scored = [t for t in self.tracked if attr in t.metrics]
        if not scored:
            return self.latest
        key = lambda t: t.metrics[attr]  # noqa: E731
        return (max if self.config.checkpoint_score_order == "max" else min)(scored, key=key)

    def register(self, checkpoint: Checkpoint, metrics: Optional[Dict[str, Any]] = None,
                 already_persisted: bool = False) -> TrackedCheckpoint:
        idx = self._index
        self._index += 1
        persisted = checkpoint if already_persisted else self.storage.persist(checkpoint, idx)
        tc = TrackedCheckpoint(persisted, idx, dict(metrics or {}))
        self.tracked.append(tc)
        self._enforce_retention()
        return tc

    def _enforce_retention(self) -> None:
        k = self.config.num_to_keep
        if k is None or len(self.tracked) <= k:
            return
        attr = self.config.checkpoint_score_attribute

        def score(t: TrackedCheckpoint) -> Tuple:
            if attr is not None and attr in t.metrics:
                v = t.metrics[attr]
                v = v if self.config.checkpoint_score_order == "max" else -v
                return (1, v, t.index)
            return (0, 0, t.index)  # unscored evicted first, oldest first

        self.tracked.sort(key=score)
        while len(self.tracked) > k:
            victim = self.tracked.pop(0)
            try:
                shutil.rmtree(victim.checkpoint.path, ignore_errors=True)
            except Exception:
                pass
