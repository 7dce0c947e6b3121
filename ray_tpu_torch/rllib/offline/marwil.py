"""MARWIL: Monotonic Advantage Re-Weighted Imitation Learning (counterpart
of the JAX package's ``rllib/offline/marwil.py``).

Parity: reference rllib/algorithms/marwil — offline imitation where each
logged action's log-likelihood is weighted by exp(beta * advantage), with
the advantage = (Monte-Carlo return - V(s)) and a trained value head. At
beta=0 this degrades to plain BC (the reference documents the same limit);
larger beta biases the policy toward better-than-average logged actions,
letting it exceed the behavior policy.

Data layout: the same transition shards BC/CQL read (offline/io.py), with
Monte-Carlo returns computed once at corpus load by segmenting on `dones`
and discounted-suffix-summing inside each episode — an O(n) numpy pass on
the host before batches ship to the learner.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..algorithm import Algorithm, LearnerFactory
from ..algorithm_config import AlgorithmConfig
from ..core.learner import TorchLearner
from .io import iter_offline_batches, load_columns

def monte_carlo_returns(rewards: np.ndarray, dones: np.ndarray,
                        gamma: float) -> np.ndarray:
    """Discounted suffix sums per episode (episodes delimited by dones;
    a trailing partial episode is treated as ending at the array end —
    its returns are biased low, matching the reference's truncation
    behavior for incomplete logged episodes).

    Assumes transitions of an episode are CONTIGUOUS in time order — the
    write_transitions layout. Fragment shards (write_fragments) interleave
    vectorized envs when N>1; for such corpora write a precomputed
    "returns" column instead (training_step uses it verbatim if present).
    """
    n = len(rewards)
    out = np.zeros(n, dtype=np.float32)
    if n == 0:
        return out
    r = rewards.astype(np.float64)
    if gamma == 0.0:
        return r.astype(np.float32)
    starts = np.concatenate(([0], np.flatnonzero(dones[:-1]) + 1))
    ends = np.concatenate((starts[1:], [n]))
    lengths = ends - starts
    # Scaled-cumsum trick: within an episode,
    #   G[i] = sum_{j>=i} gamma^(j-i) r[j] = suffix-cumsum(r * w)[i] / w[i]
    # with w = gamma^position. Valid only while gamma^position stays well
    # above underflow — cap position at B so the weight never drops below
    # ~1e-12 (beyond that the division amplifies rounding into garbage,
    # and past ~gamma^-700 it underflows to 0/0 = NaN outright).
    B = n if gamma >= 1.0 else max(1, min(n, int(-27.6 / np.log(gamma))))
    # Vectorized path for every episode of length <= B at once: ONE global
    # cumsum; per-element suffix sums via the episode-end cumsum value.
    # (A bandit corpus of millions of 1-step episodes takes this path with
    # zero interpreter iterations.)
    pos = np.arange(n) - np.repeat(starts, lengths)
    short_el = np.repeat(lengths <= B, lengths)
    w = gamma ** np.minimum(pos, B)  # clamp: long-episode tails unused
    z = np.where(short_el, r * w, 0.0)
    C = np.cumsum(z)
    ce = np.repeat(C[ends - 1], lengths)
    with np.errstate(invalid="ignore"):
        G = (ce - C + z) / w
    out[short_el] = G[short_el].astype(np.float32)
    # Long episodes: chunked scaled cumsum from the episode end, carrying
    # the bootstrap return across chunks — O(L/B) numpy ops per episode,
    # no underflow because positions restart each chunk.
    for s, e in zip(starts[lengths > B], ends[lengths > B]):
        acc = 0.0
        for ce_ in range(e, s, -B):
            cs = max(s, ce_ - B)
            seg = r[cs:ce_]
            k = np.arange(len(seg))
            wk = gamma ** k
            Gc = np.cumsum((seg * wk)[::-1])[::-1] / wk \
                + acc * gamma ** (len(seg) - k)
            out[cs:ce_] = Gc.astype(np.float32)
            acc = Gc[0]
    return out


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MARWIL)
        self.input_path: str = ""
        self.steps_per_iteration: int = 32
        self.beta: float = 1.0
        self.vf_coeff: float = 1.0
        # Clip on the exp() weights (reference marwil.py caps the
        # advantage exponent so one lucky trajectory can't dominate).
        self.max_weight: float = 20.0

    def offline_data(self, *, input_path: str,
                     steps_per_iteration: int = None) -> "MARWILConfig":
        self.input_path = input_path
        if steps_per_iteration is not None:
            self.steps_per_iteration = steps_per_iteration
        return self

    def marwil(self, *, beta: float = None, vf_coeff: float = None,
               max_weight: float = None) -> "MARWILConfig":
        if beta is not None:
            self.beta = beta
        if vf_coeff is not None:
            self.vf_coeff = vf_coeff
        if max_weight is not None:
            self.max_weight = max_weight
        return self


class MARWILLearner(TorchLearner):
    """exp(beta * normalized advantage)-weighted NLL + value regression.

    The advantage is normalized by the batch RMS (the reference keeps a
    running average of the squared advantage for the same purpose:
    marwil's `moving_average_sqd_adv_norm`); the weight is detached so the
    value head is trained only by its own regression term.
    """

    def __init__(self, module, *, beta: float, vf_coeff: float,
                 max_weight: float, **kw):
        self.beta = beta
        self.vf_coeff = vf_coeff
        self.max_weight = max_weight
        super().__init__(module, **kw)

    def loss(self, params, batch, generator):
        out = self.module.forward(params, batch["obs"])
        dist = self.module.action_dist(out["logits"])
        logp = dist.logp(batch["actions"])
        adv = batch["returns"] - out["vf"]
        # Means over the whole minibatch (every rank's rows on a mesh),
        # the RMS included.
        n = self.mask_sum(torch.ones_like(adv))
        vf_loss = 0.5 * (adv ** 2).sum() / n
        # Weight from the DETACHED advantage: the exp must not backprop
        # into the value head (reference torch impl detaches the same way).
        adv_sg = adv.detach()
        rms = torch.sqrt(self.global_sum(adv_sg ** 2) / n + 1e-8)
        w = torch.exp((self.beta * adv_sg / rms).clamp(
            max=math.log(self.max_weight)))
        policy_loss = -(w * logp).sum() / n
        total = policy_loss + self.vf_coeff * vf_loss
        return total, {"marwil_loss": total, "policy_loss": policy_loss,
                       "vf_loss": vf_loss, "mean_weight": w.sum() / n,
                       "entropy": dist.entropy().detach().sum() / n}


class MARWIL(Algorithm):
    config_cls = MARWILConfig

    def _learner_factory(self):
        cfg = self._algo_config
        return LearnerFactory(
            MARWILLearner, self._module_factory(), beta=cfg.beta,
            vf_coeff=cfg.vf_coeff, max_weight=cfg.max_weight, lr=cfg.lr,
            grad_clip=cfg.grad_clip, mesh=cfg.learner_mesh, seed=cfg.seed,
            device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._algo_config
        if not cfg.input_path:
            raise ValueError("MARWIL requires offline_data(input_path=...)")
        cache = getattr(self, "_offline_columns", None)
        if cache is None:
            cache = load_columns(cfg.input_path)
            if "returns" not in cache:
                if not {"rewards", "dones"} <= set(cache):
                    raise ValueError(
                        "MARWIL needs rewards+dones (or precomputed "
                        "returns) columns in the offline shards")
                cache["returns"] = monte_carlo_returns(
                    cache["rewards"], cache["dones"], cfg.gamma)
            self._offline_columns = cache
        metrics: Dict[str, Any] = {}
        steps = 0
        for batch in iter_offline_batches(
                cache, cfg.minibatch_size or 128,
                seed=cfg.seed + self._iteration):
            metrics = self.learner_group.update(dict(batch))
            steps += 1
            if steps >= cfg.steps_per_iteration:
                break
        out = dict(metrics)
        out["sgd_steps_this_iter"] = steps
        out["env_steps_this_iter"] = 0
        return out
