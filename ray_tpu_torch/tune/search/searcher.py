"""Searcher interface + ConcurrencyLimiter (the port's copy of the JAX
package's ``tune/search/searcher.py``).

Parity: reference tune/search/searcher.py (Searcher.suggest/on_trial_result/
on_trial_complete, save/restore) and concurrency_limiter.py. External
optimizers (Optuna/HyperOpt/...) plug in behind this interface exactly as in
the reference; BasicVariantGenerator is the built-in default.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class Searcher:
    """Suggests configs; observes results. Subclasses implement `suggest`."""

    FINISHED = "FINISHED"

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config, None to wait, or Searcher.FINISHED."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict[str, Any]] = None, error: bool = False
    ) -> None:
        pass

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference: search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(metric=searcher.metric, mode=searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None and cfg != Searcher.FINISHED:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    def get_state(self):
        return {"inner": self.searcher.get_state()}

    def set_state(self, state):
        self.searcher.set_state(state.get("inner", {}))
