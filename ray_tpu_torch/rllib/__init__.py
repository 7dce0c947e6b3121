"""RL library (counterpart of the JAX package's ``rllib``): the compute
core, run in one process.

Parity map (reference rllib/):
- Algorithm + fluent AlgorithmConfig  -> algorithm.py, algorithm_config.py
- RLModule + catalog                  -> core/rl_module.py, core/catalog.py
- Learner/LearnerGroup                -> core/learner.py, core/learner_group.py
- SingleAgentEnvRunner/EnvRunnerGroup -> env/ (the local runner)
- GAE / v-trace                       -> utils/gae.py
- PPO / IMPALA / APPO                 -> algorithms/
- Box / Discrete spaces               -> spaces.py (gymnasium is needed only
  for gymnasium's own envs, and imported only where one is built)

The learner and the runner's policy run on the card unless the caller asks
for the CPU. Actor-hosted runners and learners, Tune, DQN, SAC, the
offline algorithms and multi-agent envs are not ported yet (ROADMAP).
"""
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig
from .algorithms import (APPO, APPOConfig, IMPALA, IMPALAConfig, PPO,
                         PPOConfig)
from .core import LearnerGroup, MLPModule, RLModule, TorchLearner
from .env import EnvRunnerGroup, SingleAgentEnvRunner
from .spaces import Box, Discrete
from .utils import (SingleAgentEpisode, compute_gae, episodes_to_batch,
                    vtrace)

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "APPO",
    "APPOConfig",
    "PPO",
    "PPOConfig",
    "IMPALA",
    "IMPALAConfig",
    "RLModule",
    "MLPModule",
    "TorchLearner",
    "LearnerGroup",
    "EnvRunnerGroup",
    "SingleAgentEnvRunner",
    "Box",
    "Discrete",
    "SingleAgentEpisode",
    "episodes_to_batch",
    "compute_gae",
    "vtrace",
]
