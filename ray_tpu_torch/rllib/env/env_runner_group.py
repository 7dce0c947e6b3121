"""EnvRunnerGroup: the local sampler (counterpart of the JAX package's
``rllib/env/env_runner_group.py``). ``num_runners=0`` runs one runner in
the calling process, as the reference's local worker; its policy inference
runs on ``device``. Actor-hosted runners (the sampling fleet) are
framework glue not yet ported (ROADMAP item G): asking for them raises."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ...device import DeviceLike
from ..utils.episodes import SingleAgentEpisode
from .env_runner import SingleAgentEnvRunner


class EnvRunnerGroup:
    def __init__(
        self,
        env_creator: Callable[[], Any],
        module_factory: Callable[[], Any],
        *,
        num_runners: int = 0,
        num_envs_per_runner: int = 1,
        seed: int = 0,
        runner_resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 3,
        connector_factory: Optional[Callable[[], Any]] = None,
        action_connector_factory: Optional[Callable[[], Any]] = None,
        vectorize_mode: str = "sync",
        device: DeviceLike = None,
    ):
        if num_runners > 0:
            raise NotImplementedError(
                "actor-hosted env runners (num_runners > 0) are framework "
                "glue not yet ported (ROADMAP item G); use num_runners=0")
        self.num_runners = 0
        self._manager = None
        self._local = SingleAgentEnvRunner(
            env_creator, module_factory,
            num_envs=num_envs_per_runner, seed=seed, worker_index=0,
            connector_factory=connector_factory,
            action_connector_factory=action_connector_factory,
            vectorize_mode=vectorize_mode, device=device)

    @property
    def local_runner(self) -> SingleAgentEnvRunner:
        return self._local

    def sync_weights(self, weights: Any) -> None:
        self._local.set_weights(weights)

    def sample_fragments(self, fragment_len: int) -> List[Dict[str, Any]]:
        """One fixed-length [T, N] fragment (utils/rollout.py)."""
        return [self._local.sample_fragment(fragment_len)]

    def sample(self, total_timesteps: int) -> List[SingleAgentEpisode]:
        return self._local.sample(total_timesteps)

    def evaluate(self, num_episodes: int = 1) -> float:
        """Mean greedy-policy episode return."""
        rets = [self._local.sample_episode_greedy()
                for _ in range(num_episodes)]
        return sum(rets) / len(rets)

    def stop(self) -> None:
        self._local.stop()
