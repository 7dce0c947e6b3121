"""Trial schedulers: FIFO, ASHA, MedianStopping, PBT (the port's copy of
the JAX package's ``tune/schedulers.py``: the same decisions on the same
results).

Parity: reference tune/schedulers/ — trial_scheduler.py (decision protocol
CONTINUE/PAUSE/STOP), async_hyperband.py (ASHA rungs + reduction factor),
median_stopping_rule.py, pbt.py (exploit top quantile's checkpoint + explore
by perturbing hyperparams). Decisions are made per-result; the controller
enacts them.
"""
from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from .experiment import RUNNING, TERMINATED, Trial

CONTINUE = "CONTINUE"
PAUSE = "PAUSE"
STOP = "STOP"


class TrialScheduler:
    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def _score(self, value: float) -> float:
        """Normalize so larger is always better."""
        return value if self.mode == "max" else -value

    def on_trial_add(self, trial: Trial) -> None:
        pass

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial: Trial, result: Dict[str, Any]) -> None:
        pass

    def on_trial_error(self, trial: Trial) -> None:
        pass

    def choose_trial_to_run(self, pending: List[Trial]) -> Optional[Trial]:
        return pending[0] if pending else None


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion in submission order."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference schedulers/async_hyperband.py _Bracket): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung is stopped
    unless it is in the top 1/reduction_factor of results recorded there."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        reduction_factor: float = 3.0,
        max_t: int = 100,
    ):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # rung milestones: grace, grace*rf, grace*rf^2, ... < max_t
        self.rungs: Dict[float, List[float]] = {}
        m = float(grace_period)
        while m < max_t:
            self.rungs[m] = []
            m *= reduction_factor
        self._next_rung: Dict[str, List[float]] = {}

    def on_trial_add(self, trial: Trial) -> None:
        self._next_rung[trial.trial_id] = sorted(self.rungs.keys())

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        pending_rungs = self._next_rung.setdefault(
            trial.trial_id, sorted(self.rungs.keys())
        )
        while pending_rungs and t >= pending_rungs[0]:
            rung = pending_rungs.pop(0)
            recorded = self.rungs[rung]
            score = self._score(float(v))
            recorded.append(score)
            k = max(1, int(len(recorded) / self.rf))
            cutoff = sorted(recorded, reverse=True)[k - 1]
            if score < cutoff:
                # Cut at the first failed rung; don't pollute later rungs'
                # populations with a score the trial never legitimately
                # reached (it would drag their cutoffs down).
                return STOP
        return CONTINUE


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of the
    running averages of completed/running trials at the same step
    (reference schedulers/median_stopping_rule.py)."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = {}

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        v = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if v is None:
            return CONTINUE
        hist = self._avgs.setdefault(trial.trial_id, [])
        hist.append(self._score(float(v)))
        if t < self.grace_period or len(self._avgs) < self.min_samples:
            return CONTINUE
        my_avg = sum(hist) / len(hist)
        others = [sum(h) / len(h) for tid, h in self._avgs.items() if tid != trial.trial_id]
        if not others:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        return STOP if my_avg < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference schedulers/pbt.py): every perturbation_interval, a
    bottom-quantile trial clones the checkpoint of a top-quantile trial
    (exploit) and perturbs its hyperparameters (explore). The controller reads
    the decision `PAUSE` + `trial._pbt_new_config/_pbt_donor` to enact the
    clone-and-restart."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = {}
        self._population: List[Trial] = []

    def on_trial_add(self, trial: Trial) -> None:
        self._population.append(trial)

    def _quantiles(self) -> (List[Trial], List[Trial]):
        scored = [
            t
            for t in self._population
            if t.metric_value(self.metric) is not None and t.status == RUNNING
        ]
        if len(scored) < 2:
            return [], []
        scored.sort(key=lambda t: self._score(t.metric_value(self.metric)))
        n = max(1, int(math.ceil(len(scored) * self.quantile)))
        if n > len(scored) / 2:
            n = len(scored) // 2
        return scored[:n], scored[-n:] if n else []

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from .search.sample import Domain

        new = dict(config)
        for key, spec in self.mutations.items():
            cur = new.get(key)
            if isinstance(spec, list):
                if self.rng.random() < self.resample_p or cur not in spec:
                    new[key] = self.rng.choice(spec)
                else:
                    i = spec.index(cur)
                    j = max(0, min(len(spec) - 1, i + self.rng.choice([-1, 1])))
                    new[key] = spec[j]
            elif isinstance(spec, Domain):
                if self.rng.random() < self.resample_p:
                    new[key] = spec.sample(self.rng)
                else:
                    new[key] = spec.perturb(cur, self.rng)
            elif callable(spec):
                new[key] = spec()
        return new

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        bottom, top = self._quantiles()
        if trial in bottom and top:
            donor = self.rng.choice(top)
            # The controller checkpoints the donor on demand (its trial
            # process is live); no need for a pre-existing checkpoint here.
            trial._pbt_donor = donor  # type: ignore[attr-defined]
            trial._pbt_new_config = self._explore(donor.config)  # type: ignore
            return PAUSE  # controller performs exploit+explore
        return CONTINUE

    def on_trial_complete(self, trial: Trial, result: Dict[str, Any]) -> None:
        if trial in self._population:
            self._population.remove(trial)

    def on_trial_error(self, trial: Trial) -> None:
        if trial in self._population:
            self._population.remove(trial)
