"""Tree-structured Parzen Estimator searcher — the built-in model-based
optimizer (the port's copy of the JAX package's ``tune/search/tpe.py``:
the same suggestions for a seed and the same observed results).

Parity: the reference ships model-based search via external libraries
(tune/search/hyperopt/, optuna/ — HyperOpt's core algorithm IS TPE); none
of those are in this image, so the algorithm itself lives here, dependency
free, behind the same Searcher interface (search/searcher.py).

Standard TPE (Bergstra et al., NeurIPS 2011): after ``n_initial`` random
trials, split observations at the ``gamma`` quantile of the metric into
good/bad sets; model each with Parzen windows (per-dimension Gaussian KDE
for Float/Integer — log-space when the domain is log — and smoothed
category frequencies for Categorical); draw candidates from the good
model and keep the one maximizing l_good(x)/l_bad(x). Dimensions are
modeled independently (the "tree" factorization over the flat space).
"""
from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from .basic_variant import _set_path, _walk
from .sample import Categorical, Domain, Float, Integer, Normal, is_grid
from .searcher import Searcher


class TPESearcher(Searcher):
    def __init__(
        self,
        space: Dict[str, Any],
        *,
        metric: str,
        mode: str = "max",
        n_initial: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
        max_trials: Optional[int] = None,
        seed: int = 0,
    ):
        super().__init__(metric=metric, mode=mode)
        self.space = space
        self.dims: List[Tuple[Tuple[str, ...], Domain]] = [
            (path, dom) for path, dom in _walk(space)
            if isinstance(dom, Domain)
        ]
        self.fixed: List[Tuple[Tuple[str, ...], Any]] = [
            (path, v) for path, v in _walk(space)
            if not isinstance(v, Domain)
        ]
        # grid_search markers and callable leaves only mean something to the
        # variant generator; passed through as "fixed" they would land
        # verbatim in trial configs — refuse upfront instead.
        for path, v in self.fixed:
            if is_grid(v):
                raise ValueError(
                    f"TPESearcher does not support grid_search (at "
                    f"{'.'.join(path)}); use tune.choice(...) so TPE can "
                    f"model the dimension")
            if callable(v):
                raise ValueError(
                    f"TPESearcher does not support callable/sample_from "
                    f"leaves (at {'.'.join(path)}); use a Domain from "
                    f"tune.search.sample")
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.max_trials = max_trials
        self.rng = random.Random(seed)
        self._suggested: Dict[str, Dict[str, Any]] = {}
        # (flat config values per dim, score) for completed trials
        self._obs: List[Tuple[List[Any], float]] = []
        self._count = 0

    # ----------------------------------------------------------- modeling

    def _split(self) -> Tuple[List[List[Any]], List[List[Any]]]:
        obs = sorted(self._obs, key=lambda o: o[1],
                     reverse=(self.mode == "max"))
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        good = [o[0] for o in obs[:n_good]]
        bad = [o[0] for o in obs[n_good:]] or good
        return good, bad

    @staticmethod
    def _to_model_space(dom: Domain, v: Any) -> float:
        if isinstance(dom, Float) and dom.log:
            return math.log(v)
        return float(v)

    @staticmethod
    def _extent(dom: Domain) -> Tuple[float, float, bool]:
        """(lo, hi, bounded) of the domain in model space. Normal is
        unbounded; its +/-3sd prior extent only sizes the KDE bandwidth."""
        if isinstance(dom, Float) and dom.log:
            return math.log(dom.lower), math.log(dom.upper), True
        if isinstance(dom, (Float, Integer)):
            return float(dom.lower), float(dom.upper), True
        if isinstance(dom, Normal):
            return dom.mean - 3.0 * dom.sd, dom.mean + 3.0 * dom.sd, False
        raise TypeError(dom)

    def _kde_logpdf(self, dom: Domain, values: List[float], x: float) -> float:
        """Parzen window: mixture of Gaussians at observed values with a
        shared rule-of-thumb bandwidth over the domain extent."""
        lo, hi, _ = self._extent(dom)
        bw = max((hi - lo) / max(len(values) ** 0.5, 1.0), 1e-12)
        acc = 0.0
        for mu in values:
            z = (x - mu) / bw
            acc += math.exp(-0.5 * z * z)
        return math.log(max(acc / (len(values) * bw), 1e-300))

    def _cat_logp(self, dom: Categorical, values: List[Any], x: Any) -> float:
        k = len(dom.categories)
        counts = {c: 1.0 for c in dom.categories}  # +1 smoothing
        for v in values:
            counts[v] = counts.get(v, 1.0) + 1.0
        return math.log(counts[x] / (len(values) + k))

    def _score(self, cand: List[Any], good, bad) -> float:
        """log l(x|good) - log l(x|bad), factorized over dims."""
        s = 0.0
        for i, (_, dom) in enumerate(self.dims):
            if isinstance(dom, Categorical):
                s += (self._cat_logp(dom, [g[i] for g in good], cand[i])
                      - self._cat_logp(dom, [b[i] for b in bad], cand[i]))
            else:
                x = self._to_model_space(dom, cand[i])
                gv = [self._to_model_space(dom, g[i]) for g in good]
                bv = [self._to_model_space(dom, b[i]) for b in bad]
                s += (self._kde_logpdf(dom, gv, x)
                      - self._kde_logpdf(dom, bv, x))
        return s

    def _sample_from_good(self, good: List[List[Any]]) -> List[Any]:
        """Draw one candidate from the good model: pick a good observation
        per dim and jitter it by the bandwidth (Gaussian for numeric,
        frequency-weighted resample for categorical)."""
        cand: List[Any] = []
        for i, (_, dom) in enumerate(self.dims):
            anchor = self.rng.choice(good)[i]
            if isinstance(dom, Categorical):
                # Mostly keep; occasionally explore by frequency smoothing.
                if self.rng.random() < 1.0 / (len(good) + 1):
                    cand.append(dom.sample(self.rng))
                else:
                    cand.append(anchor)
                continue
            lo, hi, bounded = self._extent(dom)
            mu = self._to_model_space(dom, anchor)
            bw = max((hi - lo) / max(len(good) ** 0.5, 1.0), 1e-12)
            x = self.rng.gauss(mu, bw)
            if bounded:
                x = min(hi, max(lo, x))
            if isinstance(dom, Integer):
                v = int(round(x))
                v = max(dom.lower, min(dom.upper - 1, (v // dom.q) * dom.q))
                cand.append(v)
            elif isinstance(dom, Float) and dom.log:
                cand.append(math.exp(x))
            else:  # linear Float or unbounded Normal
                cand.append(x)
        return cand

    # ----------------------------------------------------------- Searcher

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self.max_trials is not None and self._count >= self.max_trials:
            return Searcher.FINISHED
        self._count += 1
        if len(self._obs) < self.n_initial or not self.dims:
            flat = [dom.sample(self.rng) for _, dom in self.dims]
        else:
            good, bad = self._split()
            cands = [self._sample_from_good(good)
                     for _ in range(self.n_candidates)]
            flat = max(cands, key=lambda c: self._score(c, good, bad))
        cfg: Dict[str, Any] = {}
        for (path, _), v in zip(self.dims, flat):
            _set_path(cfg, path, v)
        for path, v in self.fixed:
            _set_path(cfg, path, v)
        self._suggested[trial_id] = {"flat": flat}
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        info = self._suggested.pop(trial_id, None)
        if info is None or error or not result or self.metric not in result:
            return
        self._obs.append((info["flat"], float(result[self.metric])))

    def get_state(self):
        return {"obs": self._obs, "count": self._count,
                "rng": self.rng.getstate()}

    def set_state(self, state):
        self._obs = [(list(f), s) for f, s in state.get("obs", [])]
        self._count = state.get("count", 0)
        if "rng" in state:
            self.rng.setstate(tuple(
                tuple(x) if isinstance(x, list) else x
                for x in state["rng"]))
