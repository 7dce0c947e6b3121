"""Fluent AlgorithmConfig (counterpart of the JAX package's
``rllib/algorithm_config.py``).

Parity: reference rllib/algorithms/algorithm_config.py:117 (fluent
`.environment() .env_runners() .training() .learners() .evaluation()`
:1216). ``.resources(device=...)`` picks where the local runner's policy
and the learner run: the card unless the caller asks for the CPU. The
learner mesh is the port's ``DeviceMesh`` (``parallel.make_mesh``).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Type


class GymCreator:
    """The env creator of a gymnasium id: ``gymnasium.make(env_id,
    **env_config)``. A module-level callable, so it goes by plain pickle
    to an env runner process."""

    def __init__(self, env_id: str, env_config: Dict[str, Any]):
        self.env_id = env_id
        self.env_config = env_config

    def __call__(self):
        import gymnasium as gym

        return gym.make(self.env_id, **self.env_config)

    def __repr__(self) -> str:
        return f"GymCreator({self.env_id!r})"


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type] = None):
        self.algo_class = algo_class
        # environment()
        self.env: Optional[str] = None
        self.env_creator: Optional[Callable[[], Any]] = None
        self.env_config: Dict[str, Any] = {}
        # env_runners()
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        self.env_to_module_connector: Optional[Any] = None
        # Zero-arg factory -> ConnectorV2 applied to ACTIONS before
        # env.step (reference module_to_env pipeline).
        self.module_to_env_connector: Optional[Any] = None
        # Zero-arg factory -> LearnerConnector applied to fragments before
        # advantage estimation (reference learner pipeline; set via
        # .training(learner_connector=...)).
        self.learner_connector: Optional[Any] = None
        # Fragment sampling ([T,N] columns, utils/rollout.py) is the
        # throughput default for PPO; False restores the episode-based
        # sampler (comparison/debug).
        self.use_fragments: bool = True
        # "sync" | "async": gym vector env backend (async = subprocess per
        # env, for CPU-heavy env steps on many-core hosts).
        self.vectorize_mode: str = "sync"
        # training()
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 4000
        self.minibatch_size: Optional[int] = 128
        self.num_epochs: int = 4
        self.grad_clip: Optional[float] = 0.5
        self.model: Dict[str, Any] = {}
        self.max_episode_len: int = 512
        # learners()
        self.num_learners: int = 0
        self.learner_mesh: Optional[Any] = None  # parallel.make_mesh(...)
        # resources(): the device of the runner's policy and the learner
        # (None: the card).
        self.device: Optional[Any] = None
        # evaluation()
        self.evaluation_interval: int = 0
        self.evaluation_num_episodes: int = 3
        # reporting
        self.metrics_num_episodes_for_smoothing: int = 100
        # debugging()
        self.seed: int = 0
        # algo-specific extras live in subclass __init__.

    # ------------------------------------------------------------- builders

    def environment(self, env: Optional[str] = None, *,
                    env_creator: Optional[Callable[[], Any]] = None,
                    env_config: Optional[Dict[str, Any]] = None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_creator is not None:
            self.env_creator = env_creator
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    env_to_module_connector: Optional[Any] = None,
                    module_to_env_connector: Optional[Any] = None,
                    use_fragments: Optional[bool] = None,
                    vectorize_mode: Optional[str] = None,
                    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if use_fragments is not None:
            self.use_fragments = use_fragments
        if vectorize_mode is not None:
            self.vectorize_mode = vectorize_mode
        if env_to_module_connector is not None:
            # Zero-arg factory returning a ConnectorV2 / ConnectorPipeline
            # (reference: config.env_runners(env_to_module_connector=...)).
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 learner_mesh: Optional[Any] = None) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if learner_mesh is not None:
            self.learner_mesh = learner_mesh
        return self

    def resources(self, *, device: Optional[Any] = None
                  ) -> "AlgorithmConfig":
        if device is not None:
            self.device = device
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_num_episodes: Optional[int] = None
                   ) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_episodes is not None:
            self.evaluation_num_episodes = evaluation_num_episodes
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # ------------------------------------------------------------------ misc

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def make_env_creator(self) -> Callable[[], Any]:
        if self.env_creator is not None:
            return self.env_creator
        if self.env is None:
            raise ValueError("config.environment(env=...) not set")
        return GymCreator(self.env, dict(self.env_config))

    def build_algo(self):
        if self.algo_class is None:
            raise ValueError("no algo_class bound to this config")
        return self.algo_class(self)

    # legacy alias (reference .build())
    build = build_algo
