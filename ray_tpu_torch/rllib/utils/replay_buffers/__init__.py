"""Replay buffer suite (the port's copy of the JAX package's
``rllib/utils/replay_buffers``, numpy only; reference:
rllib/utils/replay_buffers/ — replay_buffer.py uniform sampling,
prioritized_episode_buffer.py proportional prioritization with importance
weights).

Design: buffers are HOST-side ring stores over preallocated numpy columns
(observations may be images — device memory is for the learner), generic
over action dtype/shape so both discrete (DQN) and continuous (SAC)
algorithms share them. ``sample()`` returns a flat dict of arrays; the
learner uploads one minibatch per update. Prioritized sampling uses a
Fenwick (binary indexed) tree: O(log n) priority updates and O(log n)
proportional draws — the array-backed analog of the reference's segment
tree (rllib/execution/segment_tree.py). The same seed gives the same
indices and importance weights as the JAX package's copy."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition buffer.

    Columns: obs, next_obs, actions, rewards, dones. ``action_shape`` /
    ``action_dtype`` default to scalar int32 (discrete); SAC passes
    ``action_shape=(act_dim,), action_dtype=np.float32``."""

    def __init__(self, capacity: int, obs_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 action_dtype=np.int32):
        self.capacity = int(capacity)
        self.size = 0
        self.pos = 0
        self.obs = np.zeros((capacity, *obs_shape), np.float32)
        self.next_obs = np.zeros((capacity, *obs_shape), np.float32)
        self.actions = np.zeros((capacity, *action_shape), action_dtype)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)

    # ------------------------------------------------------------------ add

    def add(self, obs, next_obs, action, reward, done) -> int:
        """Add one transition; returns the slot index it landed in."""
        i = self.pos
        self.obs[i] = obs
        self.next_obs[i] = next_obs
        self.actions[i] = action
        self.rewards[i] = reward
        self.dones[i] = done
        self.pos = (self.pos + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)
        return i

    def add_episodes(self, episodes: Sequence) -> int:
        """Flatten SingleAgentEpisode objects into transitions; returns how
        many were stored.

        A chunk that ends without its final observation (a same-step
        autoreset env returns the next episode's first one instead) keeps
        its last step only if it terminated: the target masks the next
        observation there, so the step's own stands in. A truncated one
        drops it, since its target would bootstrap from a state the env
        never returned. (The JAX package's copy stores that step with its
        own observation as the next; its runner never makes such a
        chunk.)"""
        n = 0
        for ep in episodes:
            T = len(ep.actions)
            for t in range(T):
                done = float(ep.terminated and t == T - 1)
                if t + 1 < len(ep.observations):
                    nxt = ep.observations[t + 1]
                elif done:
                    nxt = ep.observations[t]
                else:
                    continue
                self.add(ep.observations[t], nxt, ep.actions[t],
                         ep.rewards[t], done)
                n += 1
        return n

    # --------------------------------------------------------------- sample

    def sample(self, batch_size: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, batch_size)
        return self._rows(idx)

    def _rows(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "obs": self.obs[idx],
            "next_obs": self.next_obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
        }

    def __len__(self) -> int:
        return self.size


class _FenwickTree:
    """Prefix-sum tree over ``n`` slots (1-indexed internally)."""

    def __init__(self, n: int):
        self.n = n
        self.tree = np.zeros(n + 1, np.float64)
        self.values = np.zeros(n, np.float64)

    def set(self, i: int, value: float) -> None:
        delta = value - self.values[i]
        self.values[i] = value
        j = i + 1
        while j <= self.n:
            self.tree[j] += delta
            j += j & (-j)

    def total(self) -> float:
        return self._prefix(self.n)

    def _prefix(self, i: int) -> float:
        s = 0.0
        while i > 0:
            s += self.tree[i]
            i -= i & (-i)
        return s

    def find_prefix(self, mass: float) -> int:
        """Largest index whose prefix sum is < mass (proportional draw)."""
        idx = 0
        bit = 1 << (self.n.bit_length())
        while bit:
            nxt = idx + bit
            if nxt <= self.n and self.tree[nxt] < mass:
                idx = nxt
                mass -= self.tree[nxt]
            bit >>= 1
        return min(idx, self.n - 1)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    prioritized_episode_buffer.py; Schaul et al. 2016).

    ``sample`` additionally returns ``weights`` (importance corrections,
    normalized to max 1) and ``idx`` (pass back to ``update_priorities``
    with the new |TD errors|)."""

    def __init__(self, capacity: int, obs_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...] = (),
                 action_dtype=np.int32,
                 alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-6):
        super().__init__(capacity, obs_shape, action_shape, action_dtype)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)
        self._tree = _FenwickTree(self.capacity)
        self._max_priority = 1.0

    def add(self, obs, next_obs, action, reward, done) -> int:
        i = super().add(obs, next_obs, action, reward, done)
        # New transitions get max priority so everything is seen at least
        # once before its priority decays (reference behavior).
        self._tree.set(i, self._max_priority ** self.alpha)
        return i

    def sample(self, batch_size: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
        total = self._tree._prefix(self.capacity)
        if total <= 0:
            return super().sample(batch_size, rng)
        # Stratified proportional draws (one uniform per segment).
        seg = total / batch_size
        mass = (np.arange(batch_size) + rng.random(batch_size)) * seg
        idx = np.array([self._tree.find_prefix(m) for m in mass], np.int64)
        idx = np.minimum(idx, max(self.size - 1, 0))
        out = self._rows(idx)
        probs = self._tree.values[idx] / total
        # IS weights: (N * P(i))^-beta, normalized by the max weight.
        weights = (self.size * np.maximum(probs, 1e-12)) ** (-self.beta)
        out["weights"] = (weights / weights.max()).astype(np.float32)
        out["idx"] = idx
        return out

    def update_priorities(self, idx: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prios = np.abs(np.asarray(td_errors, np.float64)) + self.eps
        for i, p in zip(np.asarray(idx, np.int64), prios):
            self._tree.set(int(i), float(p) ** self.alpha)
            self._max_priority = max(self._max_priority, float(p))


def make_buffer(config: Optional[Dict], capacity: int,
                obs_shape: Tuple[int, ...],
                action_shape: Tuple[int, ...] = (),
                action_dtype=np.int32) -> ReplayBuffer:
    """Config-driven construction (reference: replay_buffer_config dicts,
    {"type": "PrioritizedEpisodeReplayBuffer", "alpha": ..., "beta": ...})."""
    cfg = dict(config or {})
    btype = str(cfg.pop("type", "uniform")).lower()
    if "prior" in btype:
        return PrioritizedReplayBuffer(
            capacity, obs_shape, action_shape, action_dtype,
            alpha=float(cfg.get("alpha", 0.6)),
            beta=float(cfg.get("beta", 0.4)))
    return ReplayBuffer(capacity, obs_shape, action_shape, action_dtype)
