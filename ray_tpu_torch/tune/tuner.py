"""Tuner + TuneConfig + ResultGrid — the public experiment API.

The port's counterpart of the JAX package's ``tune/tuner.py``: the same
API with no cluster to start (the trials are processes of this host,
``tune_controller.py``). Parity: reference tune/tuner.py:344 (Tuner.fit), tune/tune_config.py,
tune/result_grid.py (get_best_result, get_dataframe), tuner restore
(tuner.py Tuner.restore — resumes unfinished trials from experiment state).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

from ..train.checkpoint import Checkpoint
from ..train.config import RunConfig

from .callbacks import (Callback, CSVLoggerCallback, JsonLoggerCallback,
                        TensorBoardLoggerCallback)
from .experiment import ERROR, TERMINATED, Trial, load_experiment_state
from .schedulers import FIFOScheduler, TrialScheduler
from .search.basic_variant import BasicVariantGenerator
from .search.searcher import Searcher
from .trainable import resolve_trainable
from .tune_controller import TuneController


@dataclass
class TuneConfig:
    """reference tune/tune_config.py — experiment-wide knobs."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 0
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    seed: Optional[int] = None


@dataclass
class TrialResult:
    metrics: Dict[str, Any]
    config: Dict[str, Any]
    path: str
    checkpoint: Optional[Checkpoint]
    error: Optional[str] = None

    @property
    def metrics_dataframe(self):
        import pandas as pd

        import json

        p = os.path.join(self.path, "result.json")
        rows = []
        if os.path.exists(p):
            with open(p) as f:
                rows = [json.loads(line) for line in f if line.strip()]
        return pd.DataFrame(rows)


class ResultGrid:
    """reference tune/result_grid.py."""

    def __init__(self, results: List[TrialResult], metric: Optional[str], mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> TrialResult:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self._results if r.error]

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric or pass one)")
        candidates = [r for r in self._results if metric in r.metrics]
        if not candidates:
            raise RuntimeError(f"no trial reported metric {metric!r}")
        key: Callable = lambda r: r.metrics[metric]
        return max(candidates, key=key) if mode == "max" else min(candidates, key=key)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = dict(r.metrics)
            row.update({f"config/{k}": v for k, v in r.config.items()})
            row["trial_path"] = r.path
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(
        self,
        trainable: Union[type, Callable, Any],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _restore_path: Optional[str] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_path = _restore_path

    # ---------------------------------------------------------------- restore

    @classmethod
    def restore(cls, path: str, trainable: Union[type, Callable, Any]) -> "Tuner":
        """Resume an interrupted experiment from its directory
        (reference tuner.py Tuner.restore)."""
        return cls(trainable, _restore_path=path)

    # -------------------------------------------------------------------- fit

    def _experiment_dir(self) -> str:
        if self._restore_path:
            return self._restore_path
        name = self.run_config.name or "tune_experiment"
        base = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "rtpu_results"
        )
        d = os.path.join(os.path.expanduser(base), name)
        os.makedirs(d, exist_ok=True)
        return d

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        exp_dir = self._experiment_dir()

        restored_trials: List[Trial] = []
        searcher = tc.search_alg
        if self._restore_path:
            state = load_experiment_state(self._restore_path)
            if state:
                meta = state.get("meta", {})
                tc.metric = tc.metric or meta.get("metric")
                if meta.get("mode"):
                    tc.mode = meta["mode"]
                for td in state["trials"]:
                    t = Trial.from_json(td)
                    if t.status not in (TERMINATED, ERROR):
                        t.status = "PENDING"  # re-run unfinished work
                    restored_trials.append(t)
            searcher = searcher or BasicVariantGenerator(
                param_space={}, num_samples=0, metric=tc.metric, mode=tc.mode
            )
            if state and searcher is not None:
                try:
                    searcher.set_state(state.get("searcher", {}))
                except Exception:
                    pass
        if searcher is None:
            searcher = BasicVariantGenerator(
                param_space=self.param_space,
                num_samples=tc.num_samples,
                metric=tc.metric,
                mode=tc.mode,
                seed=tc.seed,
            )
        scheduler = tc.scheduler or FIFOScheduler(metric=tc.metric, mode=tc.mode)

        callbacks: List[Callback] = [JsonLoggerCallback(), CSVLoggerCallback(),
                             TensorBoardLoggerCallback()]
        if self.run_config.callbacks:
            callbacks.extend(self.run_config.callbacks)

        trainable_cls = resolve_trainable(self.trainable)
        # with_resources' request, else the trainable class's own (a
        # trainer's: its workers' cards).
        resources = (getattr(self.trainable, "_tune_resources", None)
                     or getattr(trainable_cls, "_tune_resources", None)
                     or {"num_cpus": 1})
        # Reference semantics (tune/impl/tuner_internal.py): unset
        # checkpoint_at_end defaults to True for the class API (which
        # implements save_checkpoint) and False for function trainables
        # (they report checkpoints in-band; forcing a save would produce
        # phantom empty checkpoint dirs).
        ckpt_at_end = self.run_config.checkpoint_config.checkpoint_at_end
        if ckpt_at_end is None:
            from .trainable import FunctionTrainable

            ckpt_at_end = not issubclass(trainable_cls, FunctionTrainable)

        controller = TuneController(
            trainable_cls,
            searcher,
            scheduler,
            exp_dir,
            metric=tc.metric,
            mode=tc.mode,
            max_concurrent=tc.max_concurrent_trials,
            max_failures=self.run_config.failure_config.max_failures,
            checkpoint_freq=getattr(self.run_config.checkpoint_config, "checkpoint_frequency", 0),
            checkpoint_at_end=bool(ckpt_at_end),
            stop=self.run_config.stop,
            callbacks=callbacks,
            resources_per_trial=resources,
            trials=restored_trials,
            # The basic variant generator consumes num_samples itself
            # (grid_size x num_samples trials, then FINISHED) — capping it
            # at TuneConfig.num_samples (default 1) would drop its grid
            # variants. The controller-level cap is for OTHER user-supplied
            # searchers, which suggest forever (reference semantics:
            # num_samples bounds Optuna/HyperOpt searchers too).
            num_samples=(tc.num_samples
                         if tc.search_alg is not None
                         and not isinstance(tc.search_alg,
                                            BasicVariantGenerator)
                         else None),
        )
        trials = controller.run()

        results = [
            TrialResult(
                metrics=t.last_result,
                config=t.config,
                path=t.local_dir,
                checkpoint=(
                    Checkpoint.from_directory(t.checkpoint_path)
                    if t.checkpoint_path
                    else None
                ),
                error=t.error_msg,
            )
            for t in trials
        ]
        return ResultGrid(results, tc.metric, tc.mode)


def with_resources(trainable, resources: Dict[str, float]):
    """Attach per-trial resource requests (reference tune/trainable/util.py
    tune.with_resources)."""
    trainable._tune_resources = resources
    return trainable


def run(
    trainable,
    *,
    config: Optional[Dict[str, Any]] = None,
    num_samples: int = 1,
    metric: Optional[str] = None,
    mode: str = "max",
    scheduler: Optional[TrialScheduler] = None,
    search_alg: Optional[Searcher] = None,
    stop: Optional[Dict[str, Any]] = None,
    max_failures: int = 0,
    checkpoint_freq: int = 0,
    checkpoint_at_end: bool = False,
    name: Optional[str] = None,
    storage_path: Optional[str] = None,
    callbacks: Optional[list] = None,
    max_concurrent_trials: Optional[int] = None,
) -> ResultGrid:
    """Legacy `tune.run` facade over Tuner (reference tune/tune.py run())."""
    from ..train.config import CheckpointConfig, FailureConfig, RunConfig

    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            scheduler=scheduler,
            search_alg=search_alg,
            max_concurrent_trials=max_concurrent_trials,
        ),
        run_config=RunConfig(
            name=name,
            storage_path=storage_path,
            stop=stop,
            callbacks=callbacks,
            failure_config=FailureConfig(max_failures=max_failures),
            checkpoint_config=CheckpointConfig(
                checkpoint_frequency=checkpoint_freq,
                checkpoint_at_end=checkpoint_at_end,
            ),
        ),
    )
    return tuner.fit()
