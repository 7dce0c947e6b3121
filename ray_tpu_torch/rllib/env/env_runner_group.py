"""EnvRunnerGroup: the sampling fleet (counterpart of the JAX package's
``rllib/env/env_runner_group.py``).

Parity: reference rllib/env/env_runner_group.py + the
`synchronous_parallel_sample` train-op (ppo.py:435): N env-runner actors,
weight sync before sampling, fault-tolerant fan-out via
FaultTolerantActorManager. ``num_runners=0`` runs one runner in the calling
process, as the reference's local worker; its policy inference runs on
``device`` (the card unless the caller asks for the CPU).

With ``num_runners > 0`` each runner is a spawned process
(``utils/actor_manager.py``) hosting ``SingleAgentEnvRunner(...,
worker_index=i + 1)``, so runner i's envs are seeded with ``seed * 65537 +
i + 1``, as the reference's. ``runner_resources`` says where it runs: the
default ``{"num_cpus": 1}`` is a CPU runner on one torch thread (the
reference's CPU-host runner; CUDA is never started in it), ``{"num_gpus":
1}`` gives runner i card i. The env creator, module factory and connector
factories go by plain pickle: one that cannot (a nested function) raises
here, before any spawn. Fragments and episodes come back as files.

On the CPU: ``EnvRunnerGroup(BatchedCreator(CartPoleBatchedEnv),
functools.partial(MLPModule, 4, 2), num_runners=2)``, and
``tests/test_torch_rllib_remote.py``; on the card, ``chip_smoke.py``'s
``ppo_remote`` (4 CPU runners, and one card runner) and ``impala_async``.
"""
from __future__ import annotations

import math
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional

from ...device import DeviceLike
from ..utils.actor_manager import (ActorProcess, FaultTolerantActorManager,
                                   actor_payload)
from ..utils.episodes import SingleAgentEpisode
from .env_runner import SingleAgentEnvRunner


def runner_cards(num_runners: int, resources: Dict[str, float]
                 ) -> Optional[List[int]]:
    """The card of each runner (None: CPU runners); raises, before any
    spawn, where the cards cannot give one to each runner."""
    gpus = resources.get("num_gpus", 0)
    if not gpus:
        return None
    if gpus != 1:
        raise ValueError(
            f"an env runner asks for {gpus} cards: the port runs one process "
            "a card, so num_gpus is 0 or 1")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass runner_resources="
                           "{'num_cpus': 1} to run the env runners on the CPU")
    cards = torch.cuda.device_count()
    if num_runners > cards:
        raise ValueError(f"{num_runners} env runners need {num_runners} "
                         f"cards, {cards} visible: each runner takes one card")
    return list(range(num_runners))


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
        self.num_runners = num_runners
        self._manager: Optional[FaultTolerantActorManager] = None
        self._local: Optional[SingleAgentEnvRunner] = None
        kwargs = dict(num_envs=num_envs_per_runner, seed=seed,
                      connector_factory=connector_factory,
                      action_connector_factory=action_connector_factory,
                      vectorize_mode=vectorize_mode)
        if num_runners == 0:
            self._local = SingleAgentEnvRunner(
                env_creator, module_factory, worker_index=0, device=device,
                **kwargs)
            return
        res = dict(runner_resources or {"num_cpus": 1})
        cards = runner_cards(num_runners, res)
        threads = max(1, math.ceil(res.get("num_cpus", 1)))
        payloads = [actor_payload(
            SingleAgentEnvRunner, (env_creator, module_factory),
            {**kwargs, "worker_index": i + 1,
             "device": "cpu" if cards is None else "cuda"},
            "env runner processes") for i in range(num_runners)]
        # Fragments and episodes in transit, as files (in TMPDIR): removed
        # with the group, with whatever a dead runner left there.
        self._spill_dir = tempfile.mkdtemp(prefix="rtpu-env-runners-")

        def factory(i: int) -> ActorProcess:
            return ActorProcess(
                payloads[i], f"rtpu-env-runner-{i + 1}",
                spill_dir=self._spill_dir,
                card=None if cards is None else cards[i],
                num_threads=threads,
                spill_results=("sample_fragment", "sample"))

        try:
            self._manager = FaultTolerantActorManager(
                factory, num_runners, max_restarts=max_restarts)
        except BaseException:
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            raise

    @property
    def local_runner(self) -> Optional[SingleAgentEnvRunner]:
        return self._local

    @property
    def manager(self) -> Optional[FaultTolerantActorManager]:
        """The runner processes' manager (None with the local runner)."""
        return self._manager

    # -------------------------------------------------------------- sampling

    def sync_weights(self, weights: Any) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            self._manager.foreach_actor("set_weights", weights)

    def sample_fragments(self, fragment_len: int) -> List[Dict[str, Any]]:
        """One fixed-length [T, N] fragment per healthy runner (the
        high-throughput path; utils/rollout.py)."""
        if self._local is not None:
            return [self._local.sample_fragment(fragment_len)]
        results = self._manager.foreach_actor("sample_fragment", fragment_len)
        # Heal for the next round; restored runners get weights at the
        # next sync_weights.
        self._manager.restore_unhealthy()
        return [frag for _, frag in results]

    def sample(self, total_timesteps: int) -> List[SingleAgentEpisode]:
        """Synchronous parallel sample of ~total_timesteps across runners."""
        if self._local is not None:
            return self._local.sample(total_timesteps)
        n = max(1, len(self._manager.healthy_actor_ids()))
        per = max(1, total_timesteps // n)
        results = self._manager.foreach_actor("sample", per)
        episodes: List[SingleAgentEpisode] = []
        for _, eps in results:
            episodes.extend(eps)
        # Heal for the next round; freshly restored runners get weights at
        # the next sync_weights call.
        self._manager.restore_unhealthy()
        return episodes

    def evaluate(self, num_episodes: int = 1) -> float:
        """Mean greedy-policy episode return."""
        if self._local is not None:
            rets = [self._local.sample_episode_greedy()
                    for _ in range(num_episodes)]
            return sum(rets) / len(rets)
        ids = self._manager.healthy_actor_ids()[:num_episodes]
        results = self._manager.foreach_actor(
            "sample_episode_greedy", actor_ids=ids)
        if not results:
            return float("nan")
        return sum(r for _, r in results) / len(results)

    def stop(self) -> None:
        if self._local is not None:
            self._local.stop()
        if self._manager is not None:
            self._manager.shutdown()
            shutil.rmtree(self._spill_dir, ignore_errors=True)
