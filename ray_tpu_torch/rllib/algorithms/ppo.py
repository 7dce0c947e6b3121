"""PPO on the port's learner stack (counterpart of the JAX package's
``rllib/algorithms/ppo.py``).

Parity: reference rllib/algorithms/ppo/ppo.py:395 (training_step :421 —
synchronous sample → learner update → weight broadcast) and the
postprocessing pipeline (evaluation/postprocessing.py compute_advantages +
standardize_fields): GAE runs once per rollout on [B, T] columns, valid
transitions flatten to a transition batch, and the learner minibatch-SGDs
over timesteps.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ..algorithm import Algorithm, LearnerFactory
from ..algorithm_config import AlgorithmConfig
from ..core.learner import TorchLearner
from ..utils.episodes import (_next_pow2, episodes_to_batch,
                              pad_batch_to_buckets)
from ..utils.gae import compute_gae
from ..utils.rollout import fragments_to_ppo_batch


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or PPO)
        self.clip_param: float = 0.2
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        self.lambda_: float = 0.95


class PPOLearner(TorchLearner):
    """Loss over a FLAT transition batch: obs [N,...], actions/logp/
    advantages/value_targets/mask [N]."""

    def __init__(self, module, cfg: PPOConfig, **kw):
        self.cfg = cfg
        super().__init__(module, lr=cfg.lr, grad_clip=cfg.grad_clip, **kw)

    def loss(self, params, batch, generator):
        cfg = self.cfg
        out = self.module.forward(params, batch["obs"])
        dist = self.module.action_dist(out["logits"])
        logp = dist.logp(batch["actions"])
        entropy = dist.entropy()
        vf = out["vf"]

        mask = batch["mask"]
        msum = self.mask_sum(mask)
        adv = batch["advantages"]

        ratio = torch.exp(logp - batch["logp"])
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        pi_loss = -(surr * mask).sum() / msum

        vf_err = torch.clamp((vf - batch["value_targets"]) ** 2,
                             0.0, cfg.vf_clip_param ** 2)
        vf_loss = (vf_err * mask).sum() / msum

        ent = (entropy * mask).sum() / msum
        total = (pi_loss + cfg.vf_loss_coeff * vf_loss
                 - cfg.entropy_coeff * ent)

        approx_kl = ((batch["logp"] - logp) * mask).sum() / msum
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": ent,
            "approx_kl": approx_kl,
        }


def postprocess_episodes(
    episodes, *, gamma: float, lam: float, max_t: int,
    standardize: bool = True,
) -> Dict[str, np.ndarray]:
    """Episodes -> flat transition batch with GAE advantages (reference
    compute_advantages + standardize_fields). N is padded to a power of two
    (mask 0), as the reference pads it."""
    # gamma folds each row's bootstrap into its last reward, so GAE is exact
    # per row regardless of padding (see episodes_to_batch docstring).
    bt = pad_batch_to_buckets(episodes_to_batch(episodes, max_t, gamma=gamma))
    adv, vtarg = compute_gae(
        bt["rewards"], bt["vf_preds"], bt["dones"], bt["bootstrap_value"],
        gamma=gamma, lam=lam)
    valid = bt["mask"] > 0
    if standardize:
        a = adv[valid]
        adv = (adv - a.mean()) / (a.std() + 1e-8)
    flat = {
        "obs": bt["obs"][valid],
        "actions": bt["actions"][valid],
        "logp": bt["logp"][valid],
        "advantages": adv[valid].astype(np.float32),
        "value_targets": vtarg[valid].astype(np.float32),
    }
    n = flat["actions"].shape[0]
    n2 = _next_pow2(n)
    out = {}
    for k, v in flat.items():
        pad = [(0, n2 - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad)
    out["mask"] = np.zeros(n2, np.float32)
    out["mask"][:n] = 1.0
    return out


class PPO(Algorithm):
    config_cls = PPOConfig

    def _learner_factory(self):
        cfg = self._algo_config
        return LearnerFactory(PPOLearner, self._module_factory(), cfg,
                              mesh=cfg.learner_mesh, seed=cfg.seed,
                              device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        # 1. broadcast current weights to the sampler
        weights = self.learner_group.get_weights()
        self.env_runner_group.sync_weights(weights)
        if cfg.use_fragments:
            return self._training_step_fragments(cfg)
        # Episode-based path (kept for comparison/debug; the fragment path
        # is the throughput-oriented default).
        episodes = self.env_runner_group.sample(cfg.train_batch_size)
        self._record_episodes(episodes)
        episodes = self._connect_episodes(episodes)
        max_t = min(cfg.max_episode_len, max(len(e) for e in episodes))
        batch = postprocess_episodes(
            episodes, gamma=cfg.gamma, lam=cfg.lambda_, max_t=max_t)
        metrics = self.learner_group.update(
            batch,
            minibatch_size=cfg.minibatch_size,
            num_epochs=cfg.num_epochs,
            shuffle=True,
        )
        out = dict(metrics)
        out["episode_return_mean"] = self.episode_return_mean
        out["num_episodes"] = len(episodes)
        out["env_steps_this_iter"] = int(sum(len(e) for e in episodes))
        return out

    def _training_step_fragments(self, cfg) -> Dict[str, Any]:
        """Fragment path: [T, N] columns from the runner, vectorized GAE,
        minibatch SGD over the flat (masked) transition batch."""
        t0 = time.perf_counter()
        frags = self.env_runner_group.sample_fragments(
            cfg.rollout_fragment_length)
        t_sample = time.perf_counter() - t0
        if self._learner_connector is not None:
            frags = [self._learner_connector(f) for f in frags]
        n_eps = 0
        n_steps = 0
        for f in frags:
            rets = f.get("episode_returns") or []
            n_eps += len(rets)
            n_steps += int(f["valid"].sum())
            self._recent_returns.extend(float(r) for r in rets)
        self._episodes_total += n_eps
        self._timesteps_total += n_steps
        window = cfg.metrics_num_episodes_for_smoothing
        self._recent_returns = self._recent_returns[-window:]
        batch = fragments_to_ppo_batch(
            frags, gamma=cfg.gamma, lam=cfg.lambda_)
        t1 = time.perf_counter()
        metrics = self.learner_group.update(
            batch,
            minibatch_size=cfg.minibatch_size,
            num_epochs=cfg.num_epochs,
            shuffle=True,
        )
        out = dict(metrics)
        out["episode_return_mean"] = self.episode_return_mean
        out["num_episodes"] = n_eps
        out["env_steps_this_iter"] = int(batch["mask"].sum())
        # Host-clock seconds of the sampling and of the learner's update.
        out["sample_time_s"] = t_sample
        out["learn_time_s"] = time.perf_counter() - t1
        return out
