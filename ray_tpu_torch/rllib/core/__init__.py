from .rl_module import MLPModule, RLModule
from .learner import TorchLearner
from .learner_group import LearnerGroup

__all__ = ["RLModule", "MLPModule", "TorchLearner", "LearnerGroup"]
