"""BasicVariantGenerator: grid cross-product x random sampling (the port's
copy of the JAX package's ``tune/search/basic_variant.py``: the same
variants for a seed).

Parity: reference tune/search/basic_variant.py (grid expansion + num_samples
repetition; each `grid_search` key multiplies the variant count, Domain values
are drawn per variant). Nested dicts in param_space are traversed; values that
are Domains are sampled, `grid_search` markers are expanded, callables are
invoked with the resolved spec, and plain values pass through.
"""
from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .sample import Domain, is_grid
from .searcher import Searcher


def _walk(spec: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(spec, dict) and not is_grid(spec):
        for k, v in spec.items():
            yield from _walk(v, path + (str(k),))
    else:
        yield path, spec


def _set_path(d: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    cur = d
    for p in path[:-1]:
        cur = cur.setdefault(p, {})
    cur[path[-1]] = value


def generate_variants(
    param_space: Dict[str, Any], num_samples: int, seed: Optional[int] = None
) -> List[Dict[str, Any]]:
    """Fully materialize the variant list (grids x num_samples draws)."""
    rng = random.Random(seed)
    grid_items: List[Tuple[Tuple[str, ...], List[Any]]] = []
    other_items: List[Tuple[Tuple[str, ...], Any]] = []
    for path, leaf in _walk(param_space):
        if is_grid(leaf):
            grid_items.append((path, leaf["grid_search"]))
        else:
            other_items.append((path, leaf))

    grids = [vals for _, vals in grid_items] or [[None]]
    variants: List[Dict[str, Any]] = []
    for _ in range(num_samples):
        for combo in itertools.product(*grids):
            cfg: Dict[str, Any] = {}
            if grid_items:
                for (path, _), val in zip(grid_items, combo):
                    _set_path(cfg, path, val)
            deferred = []
            for path, leaf in other_items:
                if isinstance(leaf, Domain):
                    _set_path(cfg, path, leaf.sample(rng))
                elif callable(leaf):
                    deferred.append((path, leaf))  # lambdas see the resolved spec
                else:
                    _set_path(cfg, path, leaf)
            for path, fn in deferred:
                _set_path(cfg, path, fn(cfg))
            variants.append(cfg)
    return variants


class BasicVariantGenerator(Searcher):
    """Default searcher: pre-materialized grid/random variants."""

    def __init__(
        self,
        param_space: Optional[Dict[str, Any]] = None,
        num_samples: int = 1,
        metric: Optional[str] = None,
        mode: str = "max",
        seed: Optional[int] = None,
    ):
        super().__init__(metric=metric, mode=mode)
        self._queue: List[Dict[str, Any]] = (
            generate_variants(param_space or {}, num_samples, seed)
        )
        self._idx = 0

    @property
    def total_variants(self) -> int:
        return len(self._queue)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._idx >= len(self._queue):
            return Searcher.FINISHED
        cfg = self._queue[self._idx]
        self._idx += 1
        return cfg

    def get_state(self):
        return {"idx": self._idx, "queue": self._queue}

    def set_state(self, state):
        self._idx = state["idx"]
        self._queue = state["queue"]
