"""APPO: IMPALA's pipeline with PPO's clipped surrogate (counterpart of
the JAX package's ``rllib/algorithms/appo.py``).

Parity: reference rllib/algorithms/appo/ (v-trace corrected advantages
consumed by PPO's clipped-ratio objective plus a KL penalty against the
behavior policy). The sampling is IMPALA's, unchanged; only the loss
differs.
"""
from __future__ import annotations

import torch

from .impala import IMPALA, IMPALAConfig, IMPALALearner


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or APPO)
        self.clip_param: float = 0.2      # PPO surrogate clip
        self.kl_coeff: float = 0.2        # behavior-KL penalty weight
        self.use_kl_loss: bool = True


class APPOLearner(IMPALALearner):
    def loss(self, params, batch, generator):
        cfg = self.cfg
        target_logp, values, entropy, vs, pg_adv = self._vtrace_terms(
            params, batch)
        mask = batch["mask"]
        msum = self.mask_sum(mask)
        # PPO clipped surrogate on the v-trace advantages (the APPO
        # difference vs IMPALA's plain policy gradient).
        ratio = torch.exp(target_logp - batch["logp"])
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_param,
                              1.0 + cfg.clip_param)
        surrogate = torch.minimum(ratio * pg_adv, clipped * pg_adv)
        pi_loss = -(surrogate * mask).sum() / msum
        vf_loss = (((values - vs) ** 2) * mask).sum() / msum
        ent = (entropy * mask).sum() / msum
        # KL(behavior || target) estimated from logp samples keeps the
        # policy from drifting past the clip's trust region.
        kl = ((batch["logp"] - target_logp) * mask).sum() / msum
        total = (pi_loss + cfg.vf_loss_coeff * vf_loss
                 - cfg.entropy_coeff * ent)
        if cfg.use_kl_loss:
            total = total + cfg.kl_coeff * torch.abs(kl)
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": ent,
            "kl": kl,
            "mean_ratio": (ratio * mask).sum() / msum,
        }


class APPO(IMPALA):
    config_cls = APPOConfig
    _learner_cls = APPOLearner
