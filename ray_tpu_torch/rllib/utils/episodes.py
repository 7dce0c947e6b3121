"""Episode container + batch building (numpy only; the port's copy of the
JAX package's ``rllib/utils/episodes.py``).

Parity: reference rllib/env/single_agent_episode.py (episode as the sampling
currency of the new API stack) and policy/sample_batch.py (column batches).
Episodes are plain numpy on the CPU sampling side; batches are dense
[B, T] arrays padded to a fixed T, so the learner sees few distinct
shapes (the JAX package's compiled update recompiles for each).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SingleAgentEpisode:
    """A (chunk of an) episode collected by an env runner."""

    observations: List[Any] = dataclasses.field(default_factory=list)
    actions: List[Any] = dataclasses.field(default_factory=list)
    rewards: List[float] = dataclasses.field(default_factory=list)
    logp: List[float] = dataclasses.field(default_factory=list)
    vf_preds: List[float] = dataclasses.field(default_factory=list)
    terminated: bool = False
    truncated: bool = False
    # value estimate of the obs AFTER the last action (bootstrap); 0 if
    # terminated.
    bootstrap_value: float = 0.0

    def __len__(self) -> int:
        return len(self.actions)

    @property
    def is_done(self) -> bool:
        return self.terminated or self.truncated

    def total_reward(self) -> float:
        return float(sum(self.rewards))


def episodes_to_batch(
    episodes: List[SingleAgentEpisode],
    max_t: int,
    *,
    gamma: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """Pack episodes into padded [B, T] columns with a validity mask.

    With `gamma` set, each row's bootstrap value is FOLDED into its last
    valid reward (r[T-1] += gamma * V_boot) and dones[T-1] is set — the
    classic truncation-bootstrap trick. This makes GAE/v-trace exact per row
    regardless of padding (cont=0 at the true last step blocks the reverse
    scan from pulling padded-garbage values into the valid region, and the
    bootstrap lands at the right step instead of the padded column). Rows
    clipped at max_t mid-episode bootstrap from the recorded V(obs[max_t]).
    """
    B = len(episodes)
    obs0 = np.asarray(episodes[0].observations[0])
    obs_shape = obs0.shape
    obs_dtype = obs0.dtype
    act0 = np.asarray(episodes[0].actions[0])

    obs = np.zeros((B, max_t) + obs_shape, obs_dtype)
    actions = np.zeros((B, max_t) + act0.shape, act0.dtype)
    rewards = np.zeros((B, max_t), np.float32)
    logp = np.zeros((B, max_t), np.float32)
    vf = np.zeros((B, max_t), np.float32)
    dones = np.zeros((B, max_t), np.float32)
    mask = np.zeros((B, max_t), np.float32)
    bootstrap = np.zeros((B,), np.float32)

    for i, ep in enumerate(episodes):
        T = min(len(ep), max_t)
        obs[i, :T] = np.asarray(ep.observations[:T])
        actions[i, :T] = np.asarray(ep.actions[:T])
        rewards[i, :T] = np.asarray(ep.rewards[:T], np.float32)
        logp[i, :T] = np.asarray(ep.logp[:T], np.float32)
        vf[i, :T] = np.asarray(ep.vf_preds[:T], np.float32)
        mask[i, :T] = 1.0
        if T < len(ep):
            # Clipped at max_t mid-episode: the sampler recorded
            # V(obs[T]) as vf_preds[T] — that's the exact bootstrap.
            boot = float(ep.vf_preds[T])
            terminal = False
        elif ep.terminated:
            boot = 0.0
            terminal = True
        else:  # truncated by the env or cut at the rollout boundary
            boot = ep.bootstrap_value
            terminal = False
        if gamma is not None:
            rewards[i, T - 1] += gamma * boot
            dones[i, T - 1] = 1.0
            bootstrap[i] = 0.0
        else:
            if terminal:
                dones[i, T - 1] = 1.0
            bootstrap[i] = boot
    return {
        "obs": obs,
        "actions": actions,
        "rewards": rewards,
        "logp": logp,
        "vf_preds": vf,
        "dones": dones,
        "mask": mask,
        "bootstrap_value": bootstrap,
    }


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pad_batch_to_buckets(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Pad B and T up to powers of two (zero rows, mask 0) so the learner's
    update sees a small, finite set of shapes instead of recompiling
    for every (num_episodes, max_len) the sampler happens to produce."""
    B, T = batch["rewards"].shape
    B2, T2 = _next_pow2(B), _next_pow2(T)
    if B2 == B and T2 == T:
        return batch
    out = {}
    for k, v in batch.items():
        if v.ndim == 1:  # [B]
            pad = [(0, B2 - B)]
        else:            # [B, T, ...]
            pad = [(0, B2 - B), (0, T2 - T)] + [(0, 0)] * (v.ndim - 2)
        out[k] = np.pad(v, pad)
    return out
