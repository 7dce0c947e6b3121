"""IMPALA: v-trace off-policy correction (counterpart of the JAX package's
``rllib/algorithms/impala.py``).

Parity: reference rllib/algorithms/impala/impala.py. The learner's v-trace
loss and both branches of ``training_step``: with the local runner,
synchronous (lag 0: weights synced before every sample); with
``num_env_runners > 0``, asynchronous: every healthy runner process keeps
one ``sample`` in flight (``FaultTolerantActorManager.submit``), the
driver drains whichever is ready (``wait_any``, 60 s) and updates,
``updates_per_step`` times a step, and the whole fleet gets the weights
every ``broadcast_interval`` updates. A runner that died is restored and
re-armed, after being given weights, by ``_heal_and_arm``. As in the
reference, a broadcast waits for each runner's answer, which a runner
gives after its sample in flight.

On the CPU: ``IMPALAConfig().environment(env_creator=BatchedCreator(
CartPoleBatchedEnv)).env_runners(num_env_runners=2).resources(
device="cpu").build()`` (``tests/test_torch_rllib_remote.py``); on the
card, ``chip_smoke.py``'s ``impala_async``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from ..algorithm import Algorithm, LearnerFactory
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
        return LearnerFactory(self._learner_cls, self._module_factory(), cfg,
                              mesh=cfg.learner_mesh, seed=cfg.seed,
                              device=cfg.device)

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        # The samples in flight: ticket -> the learner's update count of
        # the weights the runner samples with.
        self._inflight: Dict[Any, int] = {}
        self._updates_since_broadcast = 0
        self._num_updates = 0
        # Runner -> the update count of the weights last sent to it.
        self._sent_version: Dict[int, int] = {}

    # ------------------------------------------------------------- async sample

    def _sample_len(self) -> int:
        # Per-env fragment semantics: a runner's sample counts timesteps
        # across all its envs.
        cfg = self._algo_config
        return cfg.rollout_fragment_length * cfg.num_envs_per_env_runner

    def _arm(self, manager, actor_ids: List[int]) -> None:
        for i in actor_ids:
            ticket = manager.submit(i, "sample", self._sample_len())
            if ticket is not None:
                self._inflight[ticket] = self._sent_version.get(i, 0)

    def _send_weights(self, manager, actor_ids=None) -> List[int]:
        """The learner's weights to the runners (all healthy ones by
        default); returns those that took them."""
        weights = self.learner_group.get_weights()
        ok = [i for i, _ in manager.foreach_actor(
            "set_weights", weights, actor_ids=actor_ids)]
        for i in ok:
            self._sent_version[i] = self._num_updates
        return ok

    def _heal_and_arm(self, manager) -> None:
        """Every step: restore what can be restored and (re)arm any healthy
        runner with no sample in flight. This is the only recovery
        trigger: a runner that died outside the drain path (e.g. during a
        weight broadcast) has no pending sample to fail and would
        otherwise drop out of the rotation for good."""
        manager.restore_unhealthy()
        armed = {t.actor_id for t in self._inflight}
        idle = [i for i in manager.healthy_actor_ids() if i not in armed]
        if idle:
            # Unarmed runners may be fresh restores: weights first.
            ok = set(self._send_weights(manager, idle))
            self._arm(manager, [i for i in idle if i in ok])

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
        metrics = self.learner_group.update(batch, num_epochs=1,
                                            shuffle=False)
        self._updates_since_broadcast += 1
        self._num_updates += 1
        return metrics

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        manager = self.env_runner_group.manager
        metrics: Dict[str, float] = {}
        if manager is None:
            # Synchronous mode (local runner): the v-trace math at lag 0.
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
            for _ in range(cfg.updates_per_step):
                episodes = self.env_runner_group.sample(self._sample_len())
                metrics = self._update_from_episodes(episodes)
            return self._result(metrics, {})

        # Async path: keep every healthy runner armed with one sample in
        # flight; drain whichever is ready and update.
        t0 = time.perf_counter()
        self._heal_and_arm(manager)
        stats = {"num_updates": 0, "env_steps_this_iter": 0,
                 "max_runner_lag": 0, "max_sample_lag": 0,
                 "learn_time_s": 0.0}
        while stats["num_updates"] < cfg.updates_per_step and self._inflight:
            got = manager.wait_any(list(self._inflight), timeout=60.0)
            if got is None:
                break
            ticket, ok, episodes = got
            version = self._inflight.pop(ticket)
            if not ok:
                # Not re-armed here: a runner past its restart budget
                # would fail again at once. _heal_and_arm restores and
                # re-arms what can be restored.
                self._heal_and_arm(manager)
                continue
            i = ticket.actor_id
            # The weights this runner holds once its sample is drained
            # (its calls run in order), and those it sampled with, behind
            # the learner's, in updates.
            stats["max_runner_lag"] = max(
                stats["max_runner_lag"],
                self._num_updates - self._sent_version.get(i, 0))
            stats["max_sample_lag"] = max(stats["max_sample_lag"],
                                          self._num_updates - version)
            t1 = time.perf_counter()
            metrics = self._update_from_episodes(episodes)
            stats["learn_time_s"] += time.perf_counter() - t1
            stats["num_updates"] += 1
            stats["env_steps_this_iter"] += sum(len(e) for e in episodes)
            if self._updates_since_broadcast >= cfg.broadcast_interval:
                # Fleet-wide: syncing only the drained runner would leave
                # the others' lag unbounded.
                self._send_weights(manager)
                self._updates_since_broadcast = 0
            if i in manager.healthy_actor_ids():
                self._arm(manager, [i])
        stats["step_time_s"] = time.perf_counter() - t0
        return self._result(metrics, stats)

    def _result(self, metrics: Dict[str, float],
                stats: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(metrics)
        out.update(stats)
        out["episode_return_mean"] = self.episode_return_mean
        out["timesteps_total"] = self._timesteps_total
        return out
