from .env_runner import SingleAgentEnvRunner
from .env_runner_group import EnvRunnerGroup

__all__ = ["SingleAgentEnvRunner", "EnvRunnerGroup"]
