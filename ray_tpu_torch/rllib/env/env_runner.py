"""SingleAgentEnvRunner: the sampling half of the RL stack (counterpart of
the JAX package's ``rllib/env/env_runner.py``).

Parity: reference rllib/env/single_agent_env_runner.py:49 (`sample` :127,
gym.vector envs :701): owns a batched env, steps it with the current
policy, and returns fragments or completed/truncated episode chunks
carrying logp and value predictions for GAE/v-trace.

Policy inference runs on ``device``: the card unless the caller asks for
the CPU (the reference's runner defaults to the CPU; the port's runner
processes, ``env_runner_group.py``, run it on the CPU unless they are given
a card). Observations go to the device
as they come (uint8 pixels stay uint8) and are cast there; one forward per
vector step over all envs, and one copy back of the actions, their logp
and the values. Actions are drawn from a seeded ``torch.Generator`` on the
device, so a sampled action matches the reference's only in distribution.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ..core.learner import to_numpy, tree_map
from ..utils.episodes import SingleAgentEpisode


class SingleAgentEnvRunner:
    def __init__(
        self,
        env_creator: Callable[[], Any],
        module_factory: Callable[[], Any],
        *,
        num_envs: int = 1,
        seed: int = 0,
        worker_index: int = 0,
        connector_factory: Optional[Callable[[], Any]] = None,
        action_connector_factory: Optional[Callable[[], Any]] = None,
        vectorize_mode: str = "sync",
        device: DeviceLike = None,
    ):
        from .vector_env import GymVecEnv

        self.device = resolve_device(device)
        if getattr(env_creator, "makes_batched_env", False):
            # The creator builds a whole BatchedEnv itself (vector_env.py
            # protocol) — e.g. the CNN rollout bench or an envpool-style
            # native vector env.
            self.batched = env_creator(num_envs)
            self.envs = None
            # A batched factory may round the column count (e.g. up to a
            # multiple of the agent count) — its word is final.
            num_envs = self.batched.num_envs
        else:
            self.batched = GymVecEnv(env_creator, num_envs,
                                     mode=vectorize_mode)
            self.envs = self.batched.envs  # greedy evaluation's env_fns
        self.num_envs = num_envs
        self.module = module_factory()
        self.params = None
        # env-to-module connector pipeline (reference ConnectorV2): runs on
        # the raw vector observations BEFORE the policy forward; episodes
        # record the transformed obs so the learner sees the same view.
        self._connector_factory = connector_factory
        self.connector = connector_factory() if connector_factory else None
        # module-to-env pipeline (reference module_to_env connectors):
        # transforms the MODULE's actions into env actions; recorded
        # buffers keep the module's view (the learner must see what the
        # policy actually emitted). Stateful ones reset on episode
        # boundaries like the obs pipeline.
        self._action_connector_factory = action_connector_factory
        self.action_connector = (action_connector_factory()
                                 if action_connector_factory else None)
        self._generator = torch.Generator(self.device).manual_seed(
            seed * 10_007 + worker_index)
        seed_val = int(seed * 65_537 + worker_index)
        raw_obs = self.batched.reset(seed=seed_val)
        self._obs = self._connect(raw_obs)
        self._episodes = [SingleAgentEpisode() for _ in range(num_envs)]
        for i in range(num_envs):
            self._episodes[i].observations.append(self._obs[i].copy())
        # gymnasium >=1.0 vector envs autoreset on the step AFTER done
        # (AutoresetMode.NEXT_STEP): that step's action is ignored, so no
        # transition must be recorded for it.
        self._needs_reset = np.zeros(num_envs, dtype=bool)
        # Fragment-path state (sample_fragment): reusable buffers + running
        # per-env return accumulators, all vectorized.
        self._frag_buffers: Optional[Dict[str, np.ndarray]] = None
        self._ep_return = np.zeros(num_envs, np.float64)
        self._completed_returns: List[float] = []

    # ----------------------------------------------------------------- state

    def _connect(self, raw_obs):
        return self.connector(raw_obs) if self.connector is not None else raw_obs

    def _reset_pipelines(self, env_index: int) -> None:
        """Episode boundary: clear per-env state in BOTH pipelines."""
        if self.connector is not None:
            self.connector.reset(env_index)
        if self.action_connector is not None:
            self.action_connector.reset(env_index)

    def set_weights(self, weights) -> None:
        """A params tree (numpy arrays, as the learner hands them out, or
        tensors), copied onto the runner's device."""
        self.params = tree_map(
            lambda w: (w.detach().to(self.device, copy=True)
                       if isinstance(w, torch.Tensor)
                       else torch.as_tensor(np.array(w)).to(self.device)),
            weights)

    def get_weights(self) -> Any:
        """The policy's params as a numpy tree (what ``set_weights`` was
        last given)."""
        return tree_map(to_numpy, self.params)

    def _to_device(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(obs)).to(self.device)

    @torch.no_grad()
    def _explore(self, obs: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(actions, logp, values) of the policy on ``obs``, as numpy; the
        actions in the module's dtype and shape ([N] discrete, [N, A] for
        a Box). One copy to the host: the three side by side in one f32
        buffer, which holds f32 actions and integer ones below 2**24
        exactly."""
        actions, logp, vf = self.module.forward_exploration(
            self.params, self._to_device(obs), self._generator)
        n = actions.shape[0]
        out = torch.cat([actions.reshape(n, -1).float(),
                         logp.float().reshape(n, 1),
                         vf.float().reshape(n, 1)], dim=1).cpu().numpy()
        k = out.shape[1] - 2
        dtype = torch.empty(0, dtype=actions.dtype).numpy().dtype
        act = out[:, :k].reshape(actions.shape).astype(dtype)
        return act, out[:, k], out[:, k + 1]

    @torch.no_grad()
    def _values(self, obs: np.ndarray) -> np.ndarray:
        vf = self.module.forward(self.params, self._to_device(obs))["vf"]
        return vf.float().cpu().numpy()

    def ping(self) -> str:
        return "ok"

    # ---------------------------------------------------------------- sample

    def _fragment_buffers(self, T: int, actions: np.ndarray
                          ) -> Dict[str, np.ndarray]:
        """The reusable [T, N] buffers; the actions' in the dtype and
        shape of the module's first actions."""
        bufs = self._frag_buffers
        if (bufs is None or bufs["actions"].shape[0] != T
                or bufs["actions"].shape[2:] != actions.shape[1:]
                or bufs["actions"].dtype != actions.dtype):
            N = self.num_envs
            bufs = self._frag_buffers = {
                "obs": np.empty((T, N, *self._obs.shape[1:]),
                                self._obs.dtype),
                "actions": np.empty((T, *actions.shape), actions.dtype),
                "logp": np.empty((T, N), np.float32),
                "vf": np.empty((T, N), np.float32),
                "rewards": np.empty((T, N), np.float32),
                "dones": np.empty((T, N), bool),
                "truncs": np.empty((T, N), bool),
                "valid": np.empty((T, N), np.float32),
            }
        return bufs

    def sample_fragment(self, num_steps: int) -> Dict[str, Any]:
        """Fixed-length rollout fragment: [T, N] arrays, zero per-env
        Python in the hot loop (reference single_agent_env_runner.py:127
        vector sampling; see utils/rollout.py for the layout).

        One policy forward per vector step over all N envs; env stepping
        and bookkeeping are whole-batch numpy ops. This is the
        high-throughput path PPO/IMPALA train from.
        """
        assert self.params is not None, "set_weights before sample"
        T, N = num_steps, self.num_envs
        next_step_mode = self.batched.autoreset_mode == "next_step"
        # Multi-agent batched envs expose dead columns (agents done before
        # their instance's episode): their rows are masked like autoreset
        # rows (env/multi_agent_env.py).
        dead_fn = getattr(self.batched, "dead_mask", None)
        for t in range(T):
            actions, logp, vf = self._explore(self._obs)
            if t == 0:
                bufs = self._fragment_buffers(T, actions)
            bufs["obs"][t] = self._obs
            bufs["actions"][t] = actions
            bufs["logp"][t] = logp
            bufs["vf"][t] = vf
            invalid = (self._needs_reset.copy() if next_step_mode
                       else np.zeros(N, bool))
            if dead_fn is not None:
                invalid |= dead_fn()
            bufs["valid"][t] = 1.0 - invalid.astype(np.float32)
            env_actions = (self.action_connector(actions)
                           if self.action_connector is not None else actions)
            raw_next, rewards, terms, truncs = self.batched.step(env_actions)
            bufs["rewards"][t] = rewards
            done = terms | truncs
            bufs["dones"][t] = done & ~invalid
            bufs["truncs"][t] = truncs & ~terms
            # Vectorized episode-return tracking (only completed episodes
            # surface; the loop below is over DONE envs only — rare).
            live = ~invalid
            self._ep_return += np.where(live, rewards, 0.0)
            finished = done & live
            if finished.any():
                self._completed_returns.extend(
                    self._ep_return[finished].tolist())
                self._ep_return[finished] = 0.0
            if next_step_mode:
                self._needs_reset = done
                # NEXT_STEP: raw_next at a done step is the FINAL obs —
                # connect it with the old stack (its value is the
                # truncation bootstrap), THEN reset; the reset state
                # applies to the reset obs arriving next step.
                self._obs = self._connect(raw_next)
                if finished.any():
                    for i in np.nonzero(finished)[0]:
                        self._reset_pipelines(int(i))
            else:
                # SAME_STEP: raw_next is already the new episode's start —
                # reset the connector before it passes through.
                if finished.any():
                    for i in np.nonzero(finished)[0]:
                        self._reset_pipelines(int(i))
                self._obs = self._connect(raw_next)
        bootstrap = self._values(self._obs)
        returns, self._completed_returns = self._completed_returns, []
        return {
            **{k: v.copy() for k, v in bufs.items()},
            "bootstrap": bootstrap.astype(np.float32),
            "episode_returns": returns,
        }

    def sample(self, num_timesteps: int) -> List[SingleAgentEpisode]:
        """Step the vector env ~num_timesteps (per runner, across its envs);
        returns episode CHUNKS (done or truncated-by-horizon or cut at the
        end of the rollout, with bootstrap values for the cut ones).

        Walks a gymnasium vector env or a native BatchedEnv alike, by its
        ``autoreset_mode``. "next_step": the done step returns the final
        observation, and the next step (its action ignored) the reset one,
        which starts the next chunk. "same_step": the done step already
        returns the next episode's first observation, so a done chunk ends
        without its final observation (the env gives none) and a truncated
        one without a bootstrap value; a replay buffer keeps the last step
        of a terminated one and drops that of a truncated one
        (``add_episodes``). Dead columns of a multi-agent env record
        nothing until their instance resets."""
        assert self.params is not None, "set_weights before sample"
        next_step_mode = self.batched.autoreset_mode == "next_step"
        dead_fn = getattr(self.batched, "dead_mask", None)
        out: List[SingleAgentEpisode] = []
        steps = 0
        while steps < num_timesteps:
            actions, logp, vf = self._explore(self._obs)
            skip = self._needs_reset.copy()
            if dead_fn is not None:
                skip |= dead_fn()
            env_actions = (self.action_connector(actions)
                           if self.action_connector is not None else actions)
            raw_next, rewards, terms, truncs = self.batched.step(env_actions)
            finished = (terms | truncs) & ~skip
            if not next_step_mode:
                # The returned obs already starts the next episode: the
                # pipelines restart before it passes through them.
                for i in np.nonzero(finished)[0]:
                    self._reset_pipelines(int(i))
            next_obs = self._connect(raw_next)
            vf_next: Optional[np.ndarray] = None  # lazy V(next_obs)
            for i in range(self.num_envs):
                if skip[i]:
                    # Autoreset step (the env ignored our action and
                    # returned the reset observation) or a dead column:
                    # no transition; the next chunk starts here.
                    self._needs_reset[i] = False
                    self._episodes[i] = self._fresh(next_obs[i])
                    continue
                ep = self._episodes[i]
                ep.actions.append(actions[i])
                ep.rewards.append(float(rewards[i]))
                ep.logp.append(float(logp[i]))
                ep.vf_preds.append(float(vf[i]))
                steps += 1
                if not finished[i]:
                    ep.observations.append(next_obs[i].copy())
                    continue
                ep.terminated = bool(terms[i])
                ep.truncated = bool(truncs[i])
                out.append(ep)
                if not next_step_mode:
                    self._episodes[i] = self._fresh(next_obs[i])
                    continue
                # NEXT_STEP autoreset: next_obs[i] IS the final obs.
                ep.observations.append(next_obs[i].copy())
                if truncs[i] and not terms[i]:
                    if vf_next is None:
                        vf_next = self._values(next_obs)
                    ep.bootstrap_value = float(vf_next[i])
                self._episodes[i] = SingleAgentEpisode()
                self._needs_reset[i] = True
                # Stateful connectors (frame stacks) restart with the
                # new episode.
                self._reset_pipelines(i)
            self._obs = next_obs
        # Cut the in-flight episodes: hand them out with a bootstrap value
        # and start fresh chunks that continue from the same env state.
        live_idx = [i for i in range(self.num_envs)
                    if len(self._episodes[i]) > 0]
        if live_idx:
            vf_last = self._values(self._obs)
            for i in live_idx:
                ep = self._episodes[i]
                ep.bootstrap_value = float(vf_last[i])
                out.append(ep)
                self._episodes[i] = self._fresh(self._obs[i])
        return out

    @staticmethod
    def _fresh(obs: np.ndarray) -> SingleAgentEpisode:
        ep = SingleAgentEpisode()
        ep.observations.append(obs.copy())
        return ep

    def sample_episode_greedy(self, max_steps: int = 10_000) -> float:
        """One full greedy-policy episode on a fresh env; returns its return
        (evaluation path, reference Algorithm.evaluate)."""
        if self.envs is None:
            raise RuntimeError(
                "greedy evaluation builds one gym env; this runner wraps a "
                "native BatchedEnv")
        env = self.envs.env_fns[0]()
        # Evaluation gets its own connector instances: sharing the sampling
        # pipelines' per-env state would corrupt in-flight frame stacks.
        conn = (self._connector_factory()
                if self._connector_factory is not None else None)
        act_conn = (self._action_connector_factory()
                    if self._action_connector_factory is not None else None)

        def trans(o):
            return conn(np.asarray(o)[None]) if conn is not None \
                else np.asarray(o)[None]

        obs, _ = env.reset()
        total = 0.0
        for _ in range(max_steps):
            with torch.no_grad():
                action = self.module.forward_inference(
                    self.params, self._to_device(trans(obs)))
            act = action.cpu().numpy()
            if act_conn is not None:
                act = act_conn(act)
            obs, r, term, trunc, _ = env.step(int(act[0]))
            total += float(r)
            if term or trunc:
                break
        env.close()
        return total

    def stop(self) -> None:
        self.batched.close()
