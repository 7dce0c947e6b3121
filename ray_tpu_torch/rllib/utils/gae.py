"""Advantage estimators (counterpart of the JAX package's
``rllib/utils/gae.py``): GAE and v-trace.

Parity: reference rllib/evaluation/postprocessing.py compute_advantages
(GAE) and rllib/algorithms/impala/vtrace_torch.py (v-trace). Both run as a
loop over reversed time, vectorised over the batch, on the inputs' device
(the reference's ``lax.scan``). A host batch (numpy arrays) stays on the
host and comes back as numpy, as the reference's callers take it;
tensors come back as tensors. Everything is f32.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _as_f32(*xs):
    """(tensors in f32 on the first tensor's device, whether the inputs
    came from the host as numpy)."""
    host = not any(isinstance(x, torch.Tensor) for x in xs)
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                  torch.device("cpu"))
    out = [x.to(device, torch.float32) if isinstance(x, torch.Tensor)
           else torch.as_tensor(np.asarray(x, np.float32), device=device)
           for x in xs]
    return out, host


def _reverse_scan(deltas: torch.Tensor, decay: torch.Tensor
                  ) -> torch.Tensor:
    """acc[t] = deltas[t] + decay[t] * acc[t+1] over [B, T], acc[T] = 0."""
    out = torch.empty_like(deltas)
    acc = torch.zeros_like(deltas[:, 0])
    for t in range(deltas.shape[1] - 1, -1, -1):
        acc = deltas[:, t] + decay[:, t] * acc
        out[:, t] = acc
    return out


def compute_gae(rewards, values, dones, bootstrap_value, *,
                gamma: float = 0.99, lam: float = 0.95):
    """Returns (advantages, value_targets), same shape as rewards ([T] or
    [B, T]); ``bootstrap_value`` is [] or [B]. ``dones`` is 1 where the
    episode ended at t."""
    (r, v, d, boot), host = _as_f32(rewards, values, dones, bootstrap_value)
    if r.ndim == 1:
        adv, vt = compute_gae(r[None], v[None], d[None], boot.reshape(1),
                              gamma=gamma, lam=lam)
        adv, vt = adv[0], vt[0]
    else:
        cont = 1.0 - d
        next_values = torch.cat([v[:, 1:], boot[:, None]], dim=1)
        # next value is 0 where the episode terminated at t
        deltas = r + gamma * next_values * cont - v
        adv = _reverse_scan(deltas, gamma * lam * cont)
        vt = adv + v
    if host:
        return adv.numpy(), vt.numpy()
    return adv, vt


def vtrace(behavior_logp, target_logp, rewards, values, dones,
           bootstrap_value, *, gamma: float = 0.99, clip_rho: float = 1.0,
           clip_c: float = 1.0) -> Tuple:
    """IMPALA v-trace targets (Espeholt et al. 2018) over [B, T] columns.

    Returns (vs, pg_advantages): vs are the corrected value targets; the
    policy gradient uses rho_t * (r_t + gamma*vs_{t+1} - V(s_t)). The
    reference stops the gradient at both; callers pass detached inputs."""
    (blogp, tlogp, r, v, d, boot), host = _as_f32(
        behavior_logp, target_logp, rewards, values, dones, bootstrap_value)
    rho = torch.exp(tlogp - blogp)
    rho_c = torch.clamp(rho, max=clip_rho)
    c = torch.clamp(rho, max=clip_c)
    cont = 1.0 - d

    next_values = torch.cat([v[:, 1:], boot[:, None]], dim=1)
    deltas = rho_c * (r + gamma * next_values * cont - v)
    vs = v + _reverse_scan(deltas, gamma * cont * c)

    next_vs = torch.cat([vs[:, 1:], boot[:, None]], dim=1)
    pg_adv = rho_c * (r + gamma * next_vs * cont - v)
    if host:
        return vs.numpy(), pg_adv.numpy()
    return vs, pg_adv
