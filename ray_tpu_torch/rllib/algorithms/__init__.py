from .dqn import DQN, DQNConfig
from .sac import SAC, SACConfig
from .appo import APPO, APPOConfig
from .impala import IMPALA, IMPALAConfig
from .ppo import PPO, PPOConfig

__all__ = ["PPO", "PPOConfig", "IMPALA", "IMPALAConfig", "DQN",
           "DQNConfig", "SAC", "SACConfig", "APPO", "APPOConfig"]
