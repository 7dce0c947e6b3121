"""RL library (counterpart of the JAX package's ``rllib``): the compute
core, in one process or on a fleet of env runner processes and a learner
process.

Parity map (reference rllib/):
- Algorithm + fluent AlgorithmConfig  -> algorithm.py, algorithm_config.py
- RLModule + catalog                  -> core/rl_module.py, core/catalog.py
- Learner/LearnerGroup                -> core/learner.py, core/learner_group.py
- SingleAgentEnvRunner/EnvRunnerGroup -> env/ (the local runner, or
  runner processes with num_runners > 0)
- FaultTolerantActorManager           -> utils/actor_manager.py (spawned
  actor processes; util/procs.py's core)
- GAE / v-trace                       -> utils/gae.py
- PPO / IMPALA / APPO / DQN / SAC     -> algorithms/
- replay buffers                      -> utils/replay_buffers/
- offline IO, BC / CQL / MARWIL       -> offline/
- multi-agent envs (shared policy)    -> env/multi_agent_env.py
- Box / Discrete spaces               -> spaces.py (gymnasium is needed only
  for gymnasium's own envs, and imported only where one is built)

The learner and the local runner's policy run on the card unless the
caller asks for the CPU; runner processes run on the CPU (one torch thread
each) unless given a card, and the learner process (``num_learners > 0``)
takes card 0 unless the learner's device is the CPU. Tune is not ported.
On the CPU: ``tests/test_torch_rllib_remote.py``; on the card,
``chip_smoke.py``'s ``ppo_remote`` and ``impala_async`` phases.
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
