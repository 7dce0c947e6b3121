"""IMPALA: v-trace off-policy correction (counterpart of the JAX package's
``rllib/algorithms/impala.py``).

Parity: reference rllib/algorithms/impala/impala.py. The learner's v-trace
loss and the synchronous local-runner branch of ``training_step`` (lag 0:
weights synced before every sample) are ported. The asynchronous branch
(sample futures kept in flight on env-runner actors, bounded-lag weight
broadcast) is framework glue not yet ported (ROADMAP item G).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..algorithm import Algorithm
from ..algorithm_config import AlgorithmConfig
from ..core.learner import TorchLearner
from ..utils.episodes import episodes_to_batch, pad_batch_to_buckets
from ..utils.gae import vtrace


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or IMPALA)
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.clip_rho_threshold: float = 1.0
        self.clip_c_threshold: float = 1.0
        self.broadcast_interval: int = 1
        self.updates_per_step: int = 4  # learner updates per training_step
        self.num_epochs = 1  # v-trace assumes fresh-ish behavior policy


class IMPALALearner(TorchLearner):
    def __init__(self, module, cfg: IMPALAConfig, **kw):
        self.cfg = cfg
        super().__init__(module, lr=cfg.lr, grad_clip=cfg.grad_clip, **kw)

    def _vtrace_terms(self, params, batch):
        """(target logp, values, entropy [B, T], and v-trace's vs and
        pg_adv, no gradient through them, as the reference's
        stop_gradient)."""
        cfg = self.cfg
        B, T = batch["rewards"].shape
        obs = batch["obs"].reshape((B * T,) + batch["obs"].shape[2:])
        out = self.module.forward(params, obs)
        logits = out["logits"].reshape(B, T, -1)
        values = out["vf"].reshape(B, T)
        dist = self.module.action_dist(logits)
        target_logp = dist.logp(batch["actions"])
        with torch.no_grad():
            vs, pg_adv = vtrace(
                batch["logp"], target_logp.detach(), batch["rewards"],
                values.detach(), batch["dones"], batch["bootstrap_value"],
                gamma=cfg.gamma, clip_rho=cfg.clip_rho_threshold,
                clip_c=cfg.clip_c_threshold)
        return target_logp, values, dist.entropy(), vs, pg_adv

    def loss(self, params, batch, generator):
        cfg = self.cfg
        target_logp, values, entropy, vs, pg_adv = self._vtrace_terms(
            params, batch)
        mask = batch["mask"]
        msum = self.mask_sum(mask)
        pi_loss = -(target_logp * pg_adv * mask).sum() / msum
        vf_loss = (((values - vs) ** 2) * mask).sum() / msum
        ent = (entropy * mask).sum() / msum
        total = (pi_loss + cfg.vf_loss_coeff * vf_loss
                 - cfg.entropy_coeff * ent)
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": ent,
        }


class IMPALA(Algorithm):
    config_cls = IMPALAConfig
    _learner_cls = IMPALALearner

    def _learner_factory(self):
        cfg = self._algo_config
        module_factory = self._module_factory()
        learner_cls = self._learner_cls

        def factory():
            return learner_cls(module_factory(), cfg, mesh=cfg.learner_mesh,
                               seed=cfg.seed, device=cfg.device)

        return factory

    def _update_from_episodes(self, episodes) -> Dict[str, float]:
        cfg = self._algo_config
        self._record_episodes(episodes)
        episodes = self._connect_episodes(episodes)
        max_t = min(cfg.max_episode_len, max(len(e) for e in episodes))
        # gamma folds the bootstrap into the last valid reward and marks it
        # done: the v-trace reverse scan then can't pull V(padded-zero-obs)
        # into valid steps, and the bootstrap lands at the true last step.
        batch = pad_batch_to_buckets(
            episodes_to_batch(episodes, max_t, gamma=cfg.gamma))
        return self.learner_group.update(batch, num_epochs=1, shuffle=False)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        if self.env_runner_group.num_runners:
            raise NotImplementedError(
                "IMPALA's asynchronous sampling over env-runner actors is "
                "framework glue not yet ported (ROADMAP item G)")
        # Synchronous mode (local runner): the v-trace math at lag 0.
        metrics: Dict[str, float] = {}
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        for _ in range(cfg.updates_per_step):
            episodes = self.env_runner_group.sample(
                cfg.rollout_fragment_length * cfg.num_envs_per_env_runner)
            metrics = self._update_from_episodes(episodes)
        out = dict(metrics)
        out["episode_return_mean"] = self.episode_return_mean
        out["timesteps_total"] = self._timesteps_total
        return out
