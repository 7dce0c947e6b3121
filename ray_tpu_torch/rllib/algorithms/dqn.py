"""DQN on the port's learner stack (counterpart of the JAX package's
``rllib/algorithms/dqn.py``).

Parity: reference rllib/algorithms/dqn/ (training_step: rollout ->
replay-buffer add -> TD updates with a periodically synced target network;
epsilon-greedy exploration). Epsilon lives IN the weights (a param leaf
no loss reaches, so Adam leaves it as it is), so the weight broadcast
carries the schedule to the runner. The replay buffer stays on the host;
each TD update uploads one minibatch, and the update's per-row |TD error|
stays on the device until the prioritized buffer asks for it.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict

import numpy as np
import torch

from ..algorithm import Algorithm, LearnerFactory, env_spaces
from ..algorithm_config import AlgorithmConfig
from ..core.learner import TorchLearner, mean_metrics, tree_map
from ..core.rl_module import MLPModule, RLModule
from ..utils.replay_buffers import PrioritizedReplayBuffer, make_buffer


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DQN)
        self.replay_buffer_capacity: int = 50_000
        self.learning_starts: int = 1_000
        self.target_network_update_freq: int = 500  # in sampled env-steps
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_timesteps: int = 10_000
        self.num_td_updates_per_iter: int = 32
        self.gamma: float = 0.99
        # Reference replay_buffer_config dicts: {"type": "uniform" |
        # "prioritized", "alpha": 0.6, "beta": 0.4}.
        self.replay_buffer_config: dict = {"type": "uniform"}


class DQNModule(RLModule):
    """Q-network wrapper: logits ARE Q-values; exploration is
    epsilon-greedy with epsilon carried in the params tree."""

    def __init__(self, obs_dim: int, num_actions: int, hiddens=(64, 64)):
        self._mlp = MLPModule(obs_dim, num_actions, hiddens)
        self.num_actions = num_actions

    def init(self, generator: torch.Generator):
        params = self._mlp.init(generator)
        params["epsilon"] = torch.tensor(1.0, device=generator.device)
        return params

    def forward(self, params, obs):
        out = self._mlp.forward(params, obs)
        # vf = max-Q: gives the runners a value estimate for logging.
        out["vf"] = out["logits"].max(-1).values
        return out

    def forward_exploration(self, params, obs, generator):
        out = self.forward(params, obs)
        q = out["logits"]
        greedy = q.argmax(-1)
        rand_a = torch.randint(0, self.num_actions, greedy.shape,
                               generator=generator, device=q.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < params["epsilon"]
        action = torch.where(explore, rand_a, greedy)
        # logp is not meaningful for epsilon-greedy; report 0 (unused).
        return action, torch.zeros_like(q[..., 0]), out["vf"]


def _clone(tree):
    """A real copy of a params tree (the target network)."""
    return tree_map(lambda t: t.detach().clone(), tree)


class DQNLearner(TorchLearner):
    per_row_metrics = ("td_abs",)

    def __init__(self, module, cfg: DQNConfig, **kw):
        self.cfg = cfg
        super().__init__(module, lr=cfg.lr, grad_clip=cfg.grad_clip, **kw)
        self._target_params = _clone(self.params)

    def _td(self, params, batch):
        """(Q(s, a), the TD target) on ``params`` and the target net."""
        q = self.module.forward(params, batch["obs"])["logits"]
        q_sa = q.gather(1, batch["actions"].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next = self.module.forward(self._target_params,
                                         batch["next_obs"])["logits"]
            target = batch["rewards"] + self.cfg.gamma * (
                1.0 - batch["dones"]) * q_next.max(-1).values
        return q_sa, target

    def loss(self, params, batch, generator):
        q_sa, target = self._td(params, batch)
        err = q_sa - target
        # Huber loss (reference default), importance-weighted when the
        # batch came from a prioritized buffer.
        huber = torch.where(err.abs() < 1.0, 0.5 * err ** 2,
                            err.abs() - 0.5)
        if "weights" in batch:
            huber = batch["weights"] * huber
        # Means over the whole minibatch (every rank's rows on a mesh).
        n = self.mask_sum(torch.ones_like(q_sa))
        loss = huber.sum() / n
        # Per-row |err| for prioritized replay, from THIS update: no
        # second forward pass.
        return loss, {"td_loss": loss, "mean_q": q_sa.detach().sum() / n,
                      "td_abs": err.detach().abs()}

    @torch.no_grad()
    def td_errors(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """|TD error| per row on CURRENT params — the prioritized buffer's
        priority signal."""
        dev = self._to_device({k: v for k, v in batch.items()
                               if k != "weights"})
        q_sa, target = self._td(self.params, dev)
        return (q_sa - target).abs().cpu().numpy()

    def sync_target(self) -> None:
        """Copy current params into the target network (called at
        target_network_update_freq)."""
        self._target_params = _clone(self.params)

    def update_td(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One TD step on one minibatch (this rank's rows of it on a
        mesh); :meth:`take_td_errors` then gives its |TD errors|."""
        n = len(batch["rewards"])
        metrics = self._step(self._to_device(self._local_batch(batch, n)))
        return mean_metrics([metrics])


class DQN(Algorithm):
    config_cls = DQNConfig

    def _module_factory(self):
        cfg = self._algo_config
        obs_space, action_space = env_spaces(cfg.make_env_creator())
        shape = obs_space.shape
        if cfg.env_to_module_connector is not None:
            shape = tuple(
                cfg.env_to_module_connector().output_shape(shape))
        # A partial of the class: it goes by plain pickle to a process.
        return functools.partial(
            DQNModule, int(np.prod(shape)), action_space.n,
            tuple(cfg.model.get("fcnet_hiddens", (64, 64))))

    def _learner_factory(self):
        cfg = self._algo_config
        return LearnerFactory(DQNLearner, self._module_factory(), cfg,
                              mesh=cfg.learner_mesh, seed=cfg.seed,
                              device=cfg.device)

    def _setup_extra(self) -> None:
        cfg = self._algo_config
        obs_shape = env_spaces(cfg.make_env_creator())[0].shape
        if cfg.env_to_module_connector is not None:
            # The buffer stores CONNECTED observations (what the module sees).
            obs_shape = tuple(
                cfg.env_to_module_connector().output_shape(obs_shape))
        self._buffer = make_buffer(getattr(cfg, "replay_buffer_config", None),
                                   cfg.replay_buffer_capacity, obs_shape)
        self.learner_group.call("sync_target")
        self._steps_since_target_sync = 0
        self._np_rng = np.random.default_rng(cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        if not hasattr(self, "_buffer"):
            self._setup_extra()
        t0 = time.perf_counter()
        weights = self.learner_group.get_weights()
        # Epsilon schedule, carried inside the weights.
        frac = min(1.0, self._timesteps_total / max(1, cfg.epsilon_timesteps))
        eps = cfg.epsilon_initial + frac * (
            cfg.epsilon_final - cfg.epsilon_initial)
        weights["epsilon"] = np.float32(eps)
        self.learner_group.set_weights(weights)
        self.env_runner_group.sync_weights(weights)

        episodes = self.env_runner_group.sample(cfg.train_batch_size)
        self._record_episodes(episodes)
        # Learner connector before replay insertion: TD targets must see
        # the transformed (e.g. clipped) rewards.
        episodes = self._connect_episodes(episodes)
        # Env steps, not stored transitions: the buffer drops a step whose
        # next observation the env never returned.
        steps = sum(len(e) for e in episodes)
        self._buffer.add_episodes(episodes)
        self._steps_since_target_sync += steps
        t1 = time.perf_counter()

        metrics: Dict[str, Any] = {}
        if self._buffer.size >= cfg.learning_starts:
            prioritized = isinstance(self._buffer, PrioritizedReplayBuffer)
            for _ in range(cfg.num_td_updates_per_iter):
                batch = self._buffer.sample(cfg.minibatch_size, self._np_rng)
                idx = batch.pop("idx", None)
                metrics = self.learner_group.call("update_td", batch)
                if prioritized and idx is not None:
                    td = self.learner_group.call("take_td_errors")
                    if len(td):
                        self._buffer.update_priorities(idx, td)
            if self._steps_since_target_sync >= cfg.target_network_update_freq:
                self.learner_group.call("sync_target")
                self._steps_since_target_sync = 0

        out = dict(metrics)
        out["epsilon"] = float(eps)
        out["buffer_size"] = self._buffer.size
        out["episode_return_mean"] = self.episode_return_mean
        out["num_episodes"] = len(episodes)
        out["env_steps_this_iter"] = steps
        # Host-clock seconds of the sampling and of the TD updates.
        out["sample_time_s"] = t1 - t0
        out["learn_time_s"] = time.perf_counter() - t1
        return out
