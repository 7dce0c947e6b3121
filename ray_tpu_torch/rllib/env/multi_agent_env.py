"""Multi-agent environments with shared-policy training (the port's copy
of the JAX package's ``rllib/env/multi_agent_env.py``, numpy only, on the
port's ``BatchedEnv``).

Parity: reference rllib/env/multi_agent_env.py (the dict-keyed
reset/step protocol with the "__all__" done key). The training
integration is ``MultiAgentBatchedEnv``: each (env instance, agent) pair
becomes one COLUMN of the batched-env protocol (vector_env.BatchedEnv), so
the fragment sampler and PPO train a parameter-shared policy over all
agents with zero new sampling machinery — one batched forward covers every
agent of every env instance (the reference's shared-policy / parameter
sharing setup, its most common multi-agent configuration).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .vector_env import BatchedEnv


class MultiAgentEnv:
    """Dict-keyed protocol (reference multi_agent_env.py):

    - ``possible_agents``: fixed agent-id list (defines column order).
    - ``reset() -> obs_dict`` with one entry per (live) agent.
    - ``step(action_dict) -> (obs, rewards, terminations, truncations)``
      dicts; terminations/truncations may carry "__all__".
    Agents absent from an obs dict are done until the next reset.
    """

    possible_agents: Sequence[Any] = ()
    single_observation_space: Any = None
    single_action_space: Any = None

    def reset(self, seed: Optional[int] = None) -> Dict[Any, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[Any, Any]):
        raise NotImplementedError


class MultiAgentBatchedEnv(BatchedEnv):
    """num_instances copies of a MultiAgentEnv flattened to columns.

    Column layout: instance-major, agent-minor — column
    ``i * n_agents + j`` is agent j of instance i. An agent done before
    "__all__" keeps emitting zero-reward done=False rows that are MASKED
    (valid=0) until its episode resets, so fragment GAE never mixes a dead
    agent's padding into the learning signal.
    """

    autoreset_mode = "same_step"

    def __init__(self, env_creator: Callable[[], MultiAgentEnv],
                 num_instances: int, seed: int = 0):
        self.envs: List[MultiAgentEnv] = [env_creator()
                                          for _ in range(num_instances)]
        proto = self.envs[0]
        self.agents = list(proto.possible_agents)
        if not self.agents:
            raise ValueError("MultiAgentEnv.possible_agents must be set")
        self.n_agents = len(self.agents)
        self.num_envs = num_instances * self.n_agents
        self.single_observation_space = proto.single_observation_space
        self.single_action_space = proto.single_action_space
        self._seed = seed
        self._episode = 0  # rollover seeds must differ every episode
        self._obs: Optional[np.ndarray] = None
        self._dead = np.zeros(self.num_envs, bool)

    # BatchedEnv extension: the sampler masks these columns (dead agents
    # waiting for their instance's episode to finish).
    def dead_mask(self) -> np.ndarray:
        return self._dead.copy()

    def _col(self, i: int, agent) -> int:
        return i * self.n_agents + self.agents.index(agent)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        base = self._seed if seed is None else seed
        obs_shape = None
        rows = []
        for i, env in enumerate(self.envs):
            od = env.reset(seed=base + i)
            for a in self.agents:
                rows.append(np.asarray(od[a]))
                obs_shape = rows[-1].shape
        self._obs = np.stack(rows)
        self._dead[:] = False
        return self._obs

    def step(self, actions: np.ndarray):
        N = self.num_envs
        obs = self._obs.copy()
        rew = np.zeros(N, np.float32)
        term = np.zeros(N, bool)
        trunc = np.zeros(N, bool)
        for i, env in enumerate(self.envs):
            live = [a for a in self.agents
                    if not self._dead[self._col(i, a)]]
            act = {a: actions[self._col(i, a)] for a in live}
            od, rd, td, ud = env.step(act)
            term_all = bool(td.get("__all__", False))
            trunc_all = bool(ud.get("__all__", False))
            all_done = term_all or trunc_all
            for a in live:
                c = self._col(i, a)
                rew[c] = float(rd.get(a, 0.0))
                # "__all__" truncation must stay a truncation per agent —
                # conflating it with termination would zero the GAE
                # bootstrap on every time-limit episode.
                a_term = bool(td.get(a, False)) or term_all
                a_trunc = (bool(ud.get(a, False)) or trunc_all)
                term[c] = a_term
                trunc[c] = a_trunc and not a_term
                if a in od:
                    obs[c] = np.asarray(od[a])
                if (a_term or a_trunc) and not all_done:
                    self._dead[c] = True
            if all_done:
                # Advancing seed: a constant here would make seed-respecting
                # envs replay the same episode forever.
                self._episode += 1
                od = env.reset(
                    seed=self._seed + i + 7919 * self._episode)
                for a in self.agents:
                    c = self._col(i, a)
                    obs[c] = np.asarray(od[a])
                    self._dead[c] = False
        self._obs = obs
        return obs, rew, term, trunc

    def close(self) -> None:
        for env in self.envs:
            close = getattr(env, "close", None)
            if close:
                close()


def make_multi_agent_creator(env_creator: Callable[[], MultiAgentEnv],
                             seed: int = 0):
    """Adapter for AlgorithmConfig.environment(env_creator=...): the
    runner sees a batched-env factory whose `num_envs` means ENV INSTANCES
    x AGENTS columns."""

    def make(num_columns: int):
        proto = env_creator()
        n_agents = len(proto.possible_agents)
        close = getattr(proto, "close", None)
        if close:
            close()
        # Round UP: the runner sizes its buffers off the built env's
        # num_envs, and short-building would leave phantom columns.
        instances = max(1, -(-num_columns // n_agents))
        return MultiAgentBatchedEnv(env_creator, instances, seed=seed)

    make.makes_batched_env = True
    return make
