"""Search-space primitives (the port's copy of the JAX package's
``tune/search/sample.py``: the same ``random.Random`` draws).

Parity: reference python/ray/tune/search/sample.py (Domain/Float/Integer/
Categorical + sampler attachment) — the public helpers `tune.uniform`,
`tune.loguniform`, `tune.choice`, `tune.randint`, `tune.qrandint`,
`tune.randn`, `tune.grid_search` used inside `param_space` dicts.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Sequence


class Domain:
    """A dimension of the search space that knows how to draw a sample."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError

    # PBT-style perturbation support: resample by default.
    def perturb(self, value: Any, rng: random.Random) -> Any:
        return self.sample(rng)


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log = float(lower), float(upper), log

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math

            return math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)

    def perturb(self, value: Any, rng: random.Random) -> float:
        factor = rng.choice([0.8, 1.2])
        return min(self.upper, max(self.lower, float(value) * factor))


class Integer(Domain):
    def __init__(self, lower: int, upper: int, q: int = 1):
        self.lower, self.upper, self.q = int(lower), int(upper), int(q)

    def sample(self, rng: random.Random) -> int:
        v = rng.randrange(self.lower, self.upper)
        return max(self.lower, (v // self.q) * self.q)

    def perturb(self, value: Any, rng: random.Random) -> int:
        factor = rng.choice([0.8, 1.2])
        v = int(round(int(value) * factor))
        return min(self.upper - 1, max(self.lower, (v // self.q) * self.q))


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)

    def perturb(self, value: Any, rng: random.Random) -> Any:
        # Move to a neighboring category (reference pbt.py explore behavior).
        try:
            i = self.categories.index(value)
        except ValueError:
            return self.sample(rng)
        j = max(0, min(len(self.categories) - 1, i + rng.choice([-1, 1])))
        return self.categories[j]


class Normal(Domain):
    def __init__(self, mean: float, sd: float):
        self.mean, self.sd = float(mean), float(sd)

    def sample(self, rng: random.Random) -> float:
        return rng.gauss(self.mean, self.sd)


# ------------------------------------------------------------- public helpers


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def grid_search(values: Sequence[Any]) -> Dict[str, List[Any]]:
    """Marker dict, expanded as a cross-product by the variant generator
    (reference: tune/search/variant_generator.py grid handling)."""
    return {"grid_search": list(values)}


def is_grid(spec: Any) -> bool:
    return isinstance(spec, dict) and set(spec.keys()) == {"grid_search"}
