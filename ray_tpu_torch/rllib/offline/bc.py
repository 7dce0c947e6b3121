"""Behavior Cloning: the offline-RL baseline algorithm (counterpart of the
JAX package's ``rllib/offline/bc.py``).

Parity: reference rllib/algorithms/bc (trains the policy head to imitate
logged actions from offline data; the env is used only for the module's
spaces and optional evaluation). Data comes from experience shards written
by offline.io (the output side of the reference's offline_data pipeline).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..algorithm import Algorithm, LearnerFactory
from ..algorithm_config import AlgorithmConfig
from ..core.learner import TorchLearner
from .io import iter_offline_batches, load_columns


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BC)
        self.input_path: str = ""
        self.steps_per_iteration: int = 32

    def offline_data(self, *, input_path: str,
                     steps_per_iteration: int = None) -> "BCConfig":
        self.input_path = input_path
        if steps_per_iteration is not None:
            self.steps_per_iteration = steps_per_iteration
        return self


class BCLearner(TorchLearner):
    """Negative log-likelihood of the logged actions (policy head only)."""

    def loss(self, params, batch, generator):
        out = self.module.forward(params, batch["obs"])
        dist = self.module.action_dist(out["logits"])
        logp = dist.logp(batch["actions"])
        # Means over the whole minibatch (every rank's rows on a mesh).
        n = self.mask_sum(torch.ones_like(logp))
        nll = -logp.sum() / n
        return nll, {"bc_nll": nll,
                     "entropy": dist.entropy().detach().sum() / n}


class BC(Algorithm):
    config_cls = BCConfig

    def _learner_factory(self):
        cfg = self._algo_config
        return LearnerFactory(BCLearner, self._module_factory(), lr=cfg.lr,
                              grad_clip=cfg.grad_clip, mesh=cfg.learner_mesh,
                              seed=cfg.seed, device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        if not cfg.input_path:
            raise ValueError("BC requires offline_data(input_path=...)")
        # Load the corpus once; only the shuffle varies per iteration.
        cache = getattr(self, "_offline_columns", None)
        if cache is None:
            cache = self._offline_columns = load_columns(cfg.input_path)
        metrics: Dict[str, Any] = {}
        steps = 0
        for batch in iter_offline_batches(
                cache, cfg.minibatch_size or 128,
                seed=cfg.seed + self._iteration):
            batch = dict(batch)
            batch.setdefault("mask",
                             np.ones(len(batch["actions"]), np.float32))
            metrics = self.learner_group.update(batch)
            steps += 1
            if steps >= cfg.steps_per_iteration:
                break
        out = dict(metrics)
        out["sgd_steps_this_iter"] = steps
        out["env_steps_this_iter"] = 0
        return out
