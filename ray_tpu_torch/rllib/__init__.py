"""RL library (counterpart of the JAX package's ``rllib``): the compute
core, run in one process.

Parity map (reference rllib/):
- Algorithm + fluent AlgorithmConfig  -> algorithm.py, algorithm_config.py
- RLModule + catalog                  -> core/rl_module.py, core/catalog.py
- Learner/LearnerGroup                -> core/learner.py, core/learner_group.py
- SingleAgentEnvRunner/EnvRunnerGroup -> env/ (the local runner)
- GAE / v-trace                       -> utils/gae.py
- PPO / IMPALA / APPO / DQN / SAC     -> algorithms/
- replay buffers                      -> utils/replay_buffers/
- offline IO, BC / CQL / MARWIL       -> offline/
- multi-agent envs (shared policy)    -> env/multi_agent_env.py
- Box / Discrete spaces               -> spaces.py (gymnasium is needed only
  for gymnasium's own envs, and imported only where one is built)

The learner and the runner's policy run on the card unless the caller asks
for the CPU. Actor-hosted runners and learners (``utils/actor_manager``),
Tune and the offline Dataset reader (``read_experiences``) are framework
glue not yet ported (ROADMAP item G).
"""
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig
from .algorithms import (APPO, APPOConfig, IMPALA, IMPALAConfig, PPO,
                         PPOConfig, SAC, SACConfig)
from .core import LearnerGroup, MLPModule, RLModule, TorchLearner
from .env import EnvRunnerGroup, SingleAgentEnvRunner
from .env.multi_agent_env import (MultiAgentBatchedEnv, MultiAgentEnv,
                                  make_multi_agent_creator)
from .offline import BC, BCConfig, MARWIL, MARWILConfig
from .spaces import Box, Discrete
from .utils import (SingleAgentEpisode, compute_gae, episodes_to_batch,
                    vtrace)

__all__ = [
    "MultiAgentBatchedEnv",
    "MultiAgentEnv",
    "make_multi_agent_creator",
    "Algorithm",
    "AlgorithmConfig",
    "APPO",
    "APPOConfig",
    "PPO",
    "SAC",
    "SACConfig",
    "PPOConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
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
