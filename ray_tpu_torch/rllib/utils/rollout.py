"""Fixed-length rollout fragments: the throughput-oriented sample format
(numpy only; the port's copy of the JAX package's ``rllib/utils/rollout.py``).

Parity: the reference's high-throughput path samples fixed
rollout_fragment_length column batches per env runner (reference
rllib/env/single_agent_env_runner.py:127 with vector envs; IMPALA's
sample queue carries exactly such fragments). Episode objects cost a
Python loop per env per step; fragments are preallocated [T, N] arrays
the sampler fills with pure vector ops — the difference between ~3k and
~100k+ env-steps/s per runner.

Fragment layout (dict of arrays):
    obs        [T, N, ...]  observation fed to the policy at step t
    actions    [T, N]
    logp       [T, N] f32   behavior log-prob
    vf         [T, N] f32   V(obs[t])
    rewards    [T, N] f32
    dones      [T, N] bool  episode ended AT t (term or trunc)
    truncs     [T, N] bool  ended by truncation (bootstrap needed)
    valid      [T, N] f32   0 at autoreset rows (gymnasium NEXT_STEP mode)
    bootstrap  [N]   f32    V(obs after the fragment) per column
    episode_returns list[float]  returns of episodes completed in-fragment
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from .gae import compute_gae


def fragments_to_ppo_batch(
    frags: Sequence[Dict[str, Any]],
    *,
    gamma: float,
    lam: float,
    standardize: bool = True,
) -> Dict[str, np.ndarray]:
    """Fragments -> flat transition batch with GAE advantages.

    GAE runs vectorized over [N_total, T] columns. Truncation bootstrap:
    the value of a truncated episode's final observation is exactly the
    vf recorded at the FOLLOWING row (the autoreset row sees the final
    obs, gymnasium NEXT_STEP) or the fragment bootstrap when truncation
    lands on the last row — folded into the reward, the same trick
    episodes_to_batch uses, so the scan needs no special cases.
    """
    obs = np.concatenate([f["obs"] for f in frags], axis=1)
    actions = np.concatenate([f["actions"] for f in frags], axis=1)
    logp = np.concatenate([f["logp"] for f in frags], axis=1)
    vf = np.concatenate([f["vf"] for f in frags], axis=1)
    rewards = np.concatenate([f["rewards"] for f in frags], axis=1).copy()
    dones = np.concatenate([f["dones"] for f in frags], axis=1)
    truncs = np.concatenate([f["truncs"] for f in frags], axis=1)
    valid = np.concatenate([f["valid"] for f in frags], axis=1)
    bootstrap = np.concatenate([f["bootstrap"] for f in frags], axis=0)

    T, N = rewards.shape
    # Fold the truncation bootstrap into the truncated step's reward.
    t_idx, n_idx = np.nonzero(truncs)
    if t_idx.size:
        nxt_vf = np.where(t_idx + 1 < T, vf[np.minimum(t_idx + 1, T - 1), n_idx],
                          bootstrap[n_idx])
        rewards[t_idx, n_idx] += gamma * nxt_vf
    # Columns whose fragment was cut mid-episode bootstrap via the [N]
    # value; columns that ended exactly at T-1 have dones=1 there, which
    # zeroes the bootstrap term inside the scan.
    adv, vtarg = compute_gae(
        rewards.T, vf.T, dones.T.astype(np.float32), bootstrap,
        gamma=gamma, lam=lam)
    adv = np.asarray(adv).T
    vtarg = np.asarray(vtarg).T

    mask = valid.astype(np.float32)
    if standardize:
        sel = mask > 0
        a = adv[sel]
        adv = (adv - a.mean()) / (a.std() + 1e-8)

    def flat(x):
        return x.reshape(T * N, *x.shape[2:])

    return {
        "obs": flat(obs),
        "actions": flat(actions),
        "logp": flat(logp).astype(np.float32),
        "advantages": flat(adv).astype(np.float32),
        "value_targets": flat(vtarg).astype(np.float32),
        "mask": flat(mask),
    }
