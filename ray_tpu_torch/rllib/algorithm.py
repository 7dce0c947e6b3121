"""Algorithm: the RL training loop (counterpart of the JAX package's
``rllib/algorithm.py``).

Parity: reference rllib/algorithms/algorithm.py:213 (Algorithm(Trainable),
step :818, training_step :1586, save/restore). Builds the EnvRunnerGroup
(``num_env_runners`` runner processes, or the local runner at 0) and the
LearnerGroup (a learner process with ``num_learners`` > 0, or the learner
in this process) from an AlgorithmConfig; the env creator and the module
and learner factories go to those processes by plain pickle
(``ModuleFactory``, ``LearnerFactory``). ``train()`` runs
one training_step with metric bookkeeping; checkpoints carry the learner
state (params and optimizer). ``Algorithm`` is the port's Tune
``Trainable`` (``ray_tpu_torch.tune``), as the JAX package's is its:
``train``/``save``/``restore``/``stop`` are Tune's (an iteration counter in
``training_iteration``, a checkpoint directory with the iteration beside
it), and a Tuner runs an algorithm class as trials, each built from a plain
dict of overrides onto the default config.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..tune.trainable import Trainable
from .algorithm_config import AlgorithmConfig
from .core.learner_group import LearnerGroup
from .env.env_runner_group import EnvRunnerGroup
from .spaces import Box


def env_spaces(creator: Callable[..., Any]) -> Tuple[Any, Any]:
    """(observation space, action space) of one env from ``creator``.
    Batched-env factories (vector_env.BatchedEnv protocol) take a column
    count and expose single_* spaces; plain creators build one gym env."""
    batched = getattr(creator, "makes_batched_env", False)
    env = creator(1) if batched else creator()
    try:
        # Space access inside try: a space property that raises must not
        # leak the constructed env.
        if batched:
            return env.single_observation_space, env.single_action_space
        return env.observation_space, env.action_space
    finally:
        env.close()


class ModuleFactory:
    """Builds the default RLModule for an env: ``catalog.module_for_space``
    of its spaces (after the env-to-module connector's shape, if any). A
    module-level callable, so it goes by plain pickle to an env runner
    or learner process."""

    def __init__(self, creator: Callable[..., Any],
                 model_config: Dict[str, Any],
                 connector_factory: Optional[Callable[[], Any]] = None):
        self.creator = creator
        self.model_config = model_config
        self.connector_factory = connector_factory

    def __call__(self):
        from .core.catalog import module_for_space

        obs_space, action_space = env_spaces(self.creator)
        if self.connector_factory is not None:
            # The module sees connector OUTPUT shapes.
            shape = tuple(
                self.connector_factory().output_shape(obs_space.shape))
            obs_space = Box(-np.inf, np.inf, shape, np.float32)
        return module_for_space(obs_space, action_space, self.model_config)


class LearnerFactory:
    """Builds a learner: ``learner_cls(module_factory(), *args, **kw)``. A
    module-level callable, so it goes by plain pickle to a learner
    process."""

    def __init__(self, learner_cls: Callable[..., Any],
                 module_factory: Callable[[], Any], *args: Any, **kw: Any):
        self.learner_cls = learner_cls
        self.module_factory = module_factory
        self.args = args
        self.kw = kw

    def __call__(self):
        return self.learner_cls(self.module_factory(), *self.args,
                                **self.kw)


class Algorithm(Trainable):
    config_cls = AlgorithmConfig

    def __init__(self, config=None, **kwargs):
        if isinstance(config, AlgorithmConfig):
            self._algo_config = config
        elif isinstance(config, dict) or config is None:
            # From Tune: a plain dict of overrides onto the default config.
            base = self.get_default_config()
            for k, v in (config or {}).items():
                setattr(base, k, v)
            self._algo_config = base
        else:
            raise TypeError(f"bad config {type(config)}")
        super().__init__(config={}, **kwargs)

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return cls.config_cls(algo_class=cls)

    # ----------------------------------------------------------------- setup

    def setup(self, config: Dict[str, Any]) -> None:
        cfg = self._algo_config
        # The runner processes spawn first and start while the learner's
        # process starts (LearnerGroup waits for its learner only).
        self.env_runner_group = EnvRunnerGroup(
            cfg.make_env_creator(),
            self._module_factory(),
            num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_env_runner,
            seed=cfg.seed,
            connector_factory=cfg.env_to_module_connector,
            action_connector_factory=cfg.module_to_env_connector,
            vectorize_mode=cfg.vectorize_mode,
            device=cfg.device,
        )
        try:
            self.learner_group = LearnerGroup(
                self._learner_factory(), num_learners=cfg.num_learners,
                device=cfg.device)
        except BaseException:
            self.env_runner_group.stop()  # no runner process left behind
            raise
        # Learner-connector pipeline: sampled data passes through it before
        # advantage estimation (reference learner connector position). The
        # fragment path hands it [T, N] columns; the episode paths hand it
        # per-episode [T] columns via _connect_episodes.
        self._learner_connector = (cfg.learner_connector()
                                   if cfg.learner_connector else None)
        self._timesteps_total = 0
        self._episodes_total = 0
        self._recent_returns: list = []

    # -------------------------------------------------- algorithm interface

    def _module_factory(self):
        """Returns a zero-arg callable building the RLModule from the env's
        spaces (the port's or gymnasium's)."""
        cfg = self._algo_config
        return ModuleFactory(cfg.make_env_creator(), dict(cfg.model),
                             cfg.env_to_module_connector)

    def _learner_factory(self):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # ------------------------------------------------------------ Trainable

    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        result = self.training_step()
        cfg = self._algo_config
        if (cfg.evaluation_interval
                and self._iteration % cfg.evaluation_interval == 0):
            result["evaluation_return_mean"] = self.env_runner_group.evaluate(
                cfg.evaluation_num_episodes)
        result.setdefault("timesteps_total", self._timesteps_total)
        result.setdefault("episodes_total", self._episodes_total)
        result["time_this_iter_s"] = time.time() - t0
        return result

    def _connect_episodes(self, episodes):
        """Apply the learner-connector pipeline on the episode-based paths
        (PPO use_fragments=False, IMPALA): each episode's columns pass
        through as a [T]-shaped dict BEFORE batch assembly / advantage
        estimation, mirroring the fragment path's position."""
        lc = self._learner_connector
        if lc is None:
            return episodes
        for ep in episodes:
            cols = {
                "rewards": np.asarray(ep.rewards, np.float32),
                "actions": np.asarray(ep.actions),
                "logp": np.asarray(ep.logp, np.float32),
                "vf_preds": np.asarray(ep.vf_preds, np.float32),
            }
            out = lc(cols)
            ep.rewards = [float(r) for r in out["rewards"]]
            if out["actions"] is not cols["actions"]:
                ep.actions = list(out["actions"])
            if out["logp"] is not cols["logp"]:
                ep.logp = [float(x) for x in out["logp"]]
            if out["vf_preds"] is not cols["vf_preds"]:
                ep.vf_preds = [float(x) for x in out["vf_preds"]]
        return episodes

    def _record_episodes(self, episodes) -> None:
        done = [e for e in episodes if e.is_done]
        self._episodes_total += len(done)
        self._timesteps_total += sum(len(e) for e in episodes)
        self._recent_returns.extend(e.total_reward() for e in done)
        window = self._algo_config.metrics_num_episodes_for_smoothing
        self._recent_returns = self._recent_returns[-window:]

    @property
    def episode_return_mean(self) -> float:
        if not self._recent_returns:
            return float("nan")
        return float(np.mean(self._recent_returns))

    # ---------------------------------------------------------- checkpoints

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        state = {
            "learner": self.learner_group.get_state(),
            "timesteps_total": self._timesteps_total,
            "episodes_total": self._episodes_total,
        }
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._timesteps_total = state["timesteps_total"]
        self._episodes_total = state["episodes_total"]

    def cleanup(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.shutdown()
