"""CQL (Conservative Q-Learning): offline continuous control (counterpart
of the JAX package's ``rllib/offline/cql.py``).

Parity: reference rllib/algorithms/cql/ — SAC's losses plus the
conservative regularizer that penalizes Q-values of out-of-distribution
actions, trained purely from logged transitions (no env interaction; the
env supplies only the spaces).

The penalty per critic is

    alpha_cql * E_s[ logsumexp_a Q(s, a) - Q(s, a_data) ]

with the logsumexp estimated over a mix of uniform-random and
current-policy actions (importance-corrected, Kumar et al. 2020 eq. 4 as
implemented by the reference). The penalty is more terms in SACLearner's
one loss: one update, one optimizer, the same detached heads.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..algorithm import LearnerFactory
from ..algorithms.sac import SAC, SACConfig, SACLearner, SACModule
from .io import iter_offline_batches, load_columns


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or CQL)
        self.input_path: str = ""
        self.steps_per_iteration: int = 32
        self.cql_alpha: float = 1.0
        self.cql_n_actions: int = 4

    def offline_data(self, *, input_path: str,
                     steps_per_iteration: int = None) -> "CQLConfig":
        self.input_path = input_path
        if steps_per_iteration is not None:
            self.steps_per_iteration = steps_per_iteration
        return self


class CQLLearner(SACLearner):
    def draw_noise(self, n: int) -> Dict[str, torch.Tensor]:
        noise = super().draw_noise(n)
        shape = (n * self.cfg.cql_n_actions, self.module.act_dim)
        noise["cql_unif"] = torch.rand(
            shape, generator=self._generator, device=self.device) * 2.0 - 1.0
        noise["cql_pi"] = torch.randn(shape, generator=self._generator,
                                      device=self.device)
        return noise

    def loss(self, params, batch, generator,
             noise: Dict[str, torch.Tensor]):
        """``noise``: SAC's two draws, plus "cql_unif" ([B*N, A], uniform
        in [-1, 1]) and "cql_pi" ([B*N, A], standard normal) for the
        penalty's proposals (the reference's ``split(fold_in(rng, 7))``)."""
        base_loss, metrics = super().loss(params, batch, generator, noise)
        m: SACModule = self.module
        obs = batch["obs"]
        B = obs.shape[0]
        N = self.cfg.cql_n_actions

        # Q over N uniform + N policy actions per state: obs tiled to
        # [B*N, ...] so the critics run ONE batched product per set.
        rep = obs.repeat_interleave(N, dim=0)
        unif = noise["cql_unif"]
        pi_act, pi_logp = m.sample_action(params, rep, generator,
                                          noise["cql_pi"])
        q1_u, q2_u = m.q_values(params, rep, unif)
        q1_p, q2_p = m.q_values(params, rep, pi_act)
        # Importance correction: uniform proposals have log-density
        # -act_dim*log(2); policy proposals use their own logp.
        log_u = math.log(0.5) * m.act_dim
        logp = pi_logp.detach().reshape(B, N)
        lse = [torch.logsumexp(torch.cat([qu.reshape(B, N) - log_u,
                                          qp.reshape(B, N) - logp], dim=1),
                               dim=1) - math.log(2 * N)
               for qu, qp in ((q1_u, q1_p), (q2_u, q2_p))]

        q1_d, q2_d = m.q_values(params, obs, m.from_env(batch["actions"]))
        n = self.mask_sum(torch.ones_like(q1_d))
        penalty = ((lse[0] - q1_d).sum() + (lse[1] - q2_d).sum()) / n
        metrics = dict(metrics)
        metrics["cql_penalty"] = penalty
        return base_loss + self.cfg.cql_alpha * penalty, metrics


class CQL(SAC):
    config_cls = CQLConfig

    def _learner_factory(self):
        cfg = self._algo_config
        return LearnerFactory(CQLLearner, self._module_factory(), cfg,
                              mesh=cfg.learner_mesh, seed=cfg.seed,
                              device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        """Pure offline: shuffled minibatches of logged transitions into
        SAC's update (reference cql.py training_step over OfflineData)."""
        cfg = self._algo_config
        if not cfg.input_path:
            raise ValueError("CQL requires offline_data(input_path=...)")
        cache = getattr(self, "_offline_columns", None)
        if cache is None:
            cache = self._offline_columns = load_columns(cfg.input_path)
            need = {"obs", "actions", "rewards", "next_obs", "dones"}
            missing = need - set(cache)
            if missing:
                raise ValueError(
                    f"CQL shards lack transition columns: {sorted(missing)}")
        metrics: Dict[str, Any] = {}
        steps = 0
        for batch in iter_offline_batches(
                cache, cfg.minibatch_size or 256,
                seed=cfg.seed + self._iteration):
            metrics = self.learner_group.call("update_sac", {
                k: batch[k] for k in
                ("obs", "actions", "rewards", "next_obs", "dones")})
            steps += 1
            if steps >= cfg.steps_per_iteration:
                break
        out = dict(metrics)
        out["sgd_steps_this_iter"] = steps
        out["env_steps_this_iter"] = 0
        return out
