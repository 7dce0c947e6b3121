"""RLModule: the model abstraction of the RL stack (counterpart of the JAX
package's ``rllib/core/rl_module.py``).

Functional, as the reference: params are an explicit tree of tensors in the
reference's names and layouts, and the module object holds only
architecture. ``init(generator)`` draws the params on the generator's
device. The default MLPModule covers the CartPole/classic-control family;
CNNModule (Atari) is in catalog.py.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

Params = Any


class RLModule:
    """Interface. forward returns {"logits": [B, A], "vf": [B]}."""

    def init(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def forward(self, params: Params, obs: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    # ------------------------------------------------------- action sampling

    def action_dist(self, logits: torch.Tensor) -> "CategoricalDist":
        return CategoricalDist(logits)

    def forward_inference(self, params: Params,
                          obs: torch.Tensor) -> torch.Tensor:
        """Greedy action."""
        return self.forward(params, obs)["logits"].argmax(-1)

    def forward_exploration(
        self, params: Params, obs: torch.Tensor, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sampled action, its logp, and the value estimate."""
        out = self.forward(params, obs)
        dist = self.action_dist(out["logits"])
        action = dist.sample(generator)
        return action, dist.logp(action), out["vf"]


class CategoricalDist:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Gumbel-max, as ``jax.random.categorical``; the draws come from
        ``generator`` (on the logits' device), not from jax.random, so a
        sampled action matches the reference only in distribution."""
        u = torch.rand(self.logits.shape, generator=generator,
                       device=self.logits.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return (self.logits.float() + gumbel).argmax(-1)

    def logp(self, action: torch.Tensor) -> torch.Tensor:
        logp_all = torch.log_softmax(self.logits, dim=-1)
        return logp_all.gather(-1, action[..., None].long())[..., 0]

    def entropy(self) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(logp.exp() * logp).sum(-1)


def _orthogonal(generator: torch.Generator, n: int) -> torch.Tensor:
    """An n x n orthogonal matrix: Q of a normal matrix's QR, its columns'
    signs fixed by R's diagonal (the distribution of
    ``jax.random.orthogonal``)."""
    a = torch.randn(n, n, generator=generator, device=generator.device)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def _dense_init(generator: torch.Generator, n_in: int, n_out: int,
                scale: float = float(np.sqrt(2.0))) -> Params:
    w = _orthogonal(generator, max(n_in, n_out))[:n_in, :n_out] * scale
    return {"w": w.contiguous(),
            "b": torch.zeros(n_out, device=generator.device)}


def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


class MLPModule(RLModule):
    """Separate policy/value MLP trunks (reference models/catalog.py default
    fcnet); orthogonal init, tanh activations — the classic PPO recipe."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)

    def init(self, generator: torch.Generator) -> Params:
        sizes = (self.obs_dim,) + self.hiddens
        n = len(self.hiddens)
        pi = [_dense_init(generator, sizes[i], sizes[i + 1])
              for i in range(n)]
        vf = [_dense_init(generator, sizes[i], sizes[i + 1])
              for i in range(n)]
        pi.append(_dense_init(generator, sizes[-1], self.num_actions,
                              scale=0.01))
        vf.append(_dense_init(generator, sizes[-1], 1, scale=1.0))
        return {"pi": pi, "vf": vf}

    def forward(self, params: Params, obs: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = obs.float()
        h = x
        for layer in params["pi"][:-1]:
            h = torch.tanh(_dense(layer, h))
        logits = _dense(params["pi"][-1], h)
        h = x
        for layer in params["vf"][:-1]:
            h = torch.tanh(_dense(layer, h))
        vf = _dense(params["vf"][-1], h)[..., 0]
        return {"logits": logits, "vf": vf}
