"""TuneController: drives trial processes to completion.

The port's counterpart of the JAX package's ``tune/tune_controller.py``.
Parity: reference tune/execution/tune_controller.py (step loop: start
trials, collect training results, apply scheduler decisions, retry
failures, persist experiment state). Where the JAX package hosts each
trial in an actor of its control plane, the port hosts it in a process
of this host (``util/procs.py``'s core, as the Train layer's workers;
spawned, or forked from a fork server, below): one
:class:`procs.Worker` a running trial, serving a
:class:`_TrialRunner` around the Trainable. ``train()`` is a call sent to
it; the step loop waits on every trial process at once
(``procs.wait``) and sees a process that died as a trial error, which
restores from the trial's last checkpoint under ``max_failures``, as an
exception does.

Resources: a trial asks ``num_cpus`` (counted against this host's cores)
and ``num_gpus`` (against the visible cards; a fraction below 1 packs
trials onto one card). The controller assigns each trial its cards, and
the trial process sets ``CUDA_VISIBLE_DEVICES`` to them before anything
touches CUDA, so the trainable, and a Train trial's workers, see the
trial's cards as cards 0, 1, .... A trial that asks for more cards than
are visible, or for any card without CUDA, raises before any process
starts.

The trainable class goes to the trial process by plain pickle, by
reference (``procs.dumps``): one that cannot raises ``TypeError`` here,
before any process starts, naming module level. The trial processes are
not daemonic: a Train trial's fit starts its own workers, which leave
with it (stopped by the fit as the trial stops, and at once if the trial
process dies: ``procs.serve`` leaves when its caller is gone).

A trial that takes cards, or runs a trainer or an RLlib algorithm,
will load torch and the port's model, train and RL modules, seconds in
every fresh process (6-15 s on the H100's host, PERF.md section 5): such
trials fork from multiprocessing's fork server, which imported them once
(``TRIAL_PRELOAD``) and never starts CUDA, so a forked trial takes its
cards as a spawned one would. The server lives until this process ends,
as multiprocessing keeps it, or until ``procs.stop_fork_server()`` (the
serve layer's shutdown calls it). Any other trial is spawned: one that
runs numpy never loads torch.
"""
from __future__ import annotations

import logging
import math
import multiprocessing
import os
import pickle
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..util import procs
from . import schedulers as sched
from .callbacks import Callback
from .experiment import (
    ERROR,
    PAUSED,
    PENDING,
    RUNNING,
    TERMINATED,
    Trial,
    save_experiment_state,
)
from .search.searcher import Searcher
from .trainable import RESULT_DONE, STOP_JOIN_S

logger = logging.getLogger(__name__)

# Seconds the step loop waits for a result before it looks again.
WAIT_S = 10.0
# Seconds a graceful stop of a trial may take before its process is
# stopped anyway (a stopping function trainable waits STOP_JOIN_S).
STOP_CALL_S = STOP_JOIN_S + 10.0
RESOURCE_KEYS = ("num_cpus", "num_gpus")
# What the fork server imports for the trials that take cards.
TRIAL_PRELOAD = ["torch", "ray_tpu_torch.tune.tune_controller",
                 "ray_tpu_torch.train.data_parallel_trainer",
                 "ray_tpu_torch.train.step",
                 "ray_tpu_torch.ops.flash_attention",
                 "ray_tpu_torch.rllib.algorithm"]


class TrialCallError(RuntimeError):
    """A call on a trial process raised: its traceback is the message."""


class TrialProcessDied(RuntimeError):
    """A trial process ended before it answered."""


class _TrialRunner:
    """Hosts one Trainable inside a trial process."""

    def __init__(self, trainable_cls: type, config: Dict[str, Any]):
        self._trainable = trainable_cls(config)

    def train(self) -> Dict[str, Any]:
        return self._trainable.train()

    def save(self, checkpoint_dir: str) -> str:
        return self._trainable.save(checkpoint_dir)

    def restore(self, checkpoint_path: str) -> None:
        self._trainable.restore(checkpoint_path)

    def reset(self, new_config: Dict[str, Any]) -> bool:
        return self._trainable.reset(new_config)

    def stop(self) -> None:
        self._trainable.stop()


def _trial_main(conn, cards: Optional[str], blob: bytes,
                config: Dict[str, Any], environ: Dict[str, str]) -> None:
    """A trial process: take the controller's environment of the moment
    it was asked for (a fork server's is older) and the trial's cards
    (before anything touches CUDA), then serve the Trainable until the
    controller sends None or goes away."""
    os.environ.clear()
    os.environ.update(environ)
    tempfile.tempdir = None  # read TMPDIR again
    if cards is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = cards
    procs.serve(conn, lambda: _TrialRunner(pickle.loads(blob), config),
                ready={"cards": cards})


class _TrialProcess(procs.Worker):
    def __init__(self, ctx, trial: Trial, cards: Optional[str],
                 blob: bytes):
        super().__init__(ctx, _trial_main,
                         (cards, blob, trial.config, dict(os.environ)),
                         f"rtpu-tune-trial-{trial.trial_id}")
        self.trial = trial


def _loads_torch(trainable_cls: type) -> bool:
    """Does a trial of ``trainable_cls`` load torch whatever it computes:
    a trainer's (``as_trainable``) or an RLlib algorithm?"""
    from .trainable import wrap_trainer_as_trainable

    rebuild = getattr(trainable_cls, "_rebuild", None)
    return (rebuild is not None and rebuild[0] is wrap_trainer_as_trainable
            or any(c.__module__.startswith("ray_tpu_torch.rllib.")
                   for c in trainable_cls.__mro__))


def _trial_context(preloaded: bool):
    """Fork from the preloaded fork server, or spawn."""
    if not preloaded:
        return multiprocessing.get_context("spawn")
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(TRIAL_PRELOAD)
    return ctx


def check_resources(resources: Dict[str, float]) -> int:
    """The number of visible cards a trial asking ``resources`` can use;
    raises, before any trial process starts, where they cannot serve one
    trial."""
    unknown = set(resources) - set(RESOURCE_KEYS)
    if unknown:
        raise ValueError(f"unknown trial resources {sorted(unknown)}: a "
                         f"trial asks {RESOURCE_KEYS}")
    gpus = float(resources.get("num_gpus", 0) or 0)
    if not gpus:
        return 0
    if gpus > 1 and gpus != int(gpus):
        raise ValueError(f"num_gpus {gpus}: a trial takes a fraction of one "
                         "card or whole cards")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"a trial asks for num_gpus={gpus} and CUDA is "
                           "not available")
    cards = torch.cuda.device_count()
    if gpus > cards:
        raise ValueError(f"a trial asks for num_gpus={gpus}, {cards} cards "
                         "are visible")
    return cards


class _Cards:
    """The visible cards and the share of each that running trials hold."""

    def __init__(self, count: int):
        self.load = [0.0] * count
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        self.names = ([c.strip() for c in visible.split(",")][:count]
                      if visible else [str(i) for i in range(count)])

    def capacity(self, gpus: float) -> int:
        """Trials of ``gpus`` cards each that fit at once."""
        if gpus >= 1:
            return len(self.load) // int(gpus)
        return len(self.load) * int(math.floor(1.0 / gpus + 1e-9))

    def take(self, gpus: float) -> Optional[List[int]]:
        if gpus >= 1:
            free = [i for i, x in enumerate(self.load) if x == 0.0]
            if len(free) < int(gpus):
                return None
            picked = free[:int(gpus)]
            for i in picked:
                self.load[i] = 1.0
            return picked
        for i, x in enumerate(self.load):
            if x + gpus <= 1.0 + 1e-9:
                self.load[i] = x + gpus
                return [i]
        return None

    def give(self, picked: List[int], gpus: float) -> None:
        for i in picked:
            self.load[i] = max(0.0, self.load[i] - min(gpus, 1.0))

    def visible(self, picked: List[int]) -> str:
        return ",".join(self.names[i] for i in picked)


class TuneController:
    def __init__(
        self,
        trainable_cls: type,
        searcher: Searcher,
        scheduler: sched.TrialScheduler,
        experiment_dir: str,
        *,
        metric: Optional[str] = None,
        mode: str = "max",
        max_concurrent: int = 0,
        max_failures: int = 0,
        checkpoint_freq: int = 0,
        checkpoint_at_end: bool = False,
        stop: Optional[Dict[str, Any]] = None,
        callbacks: Optional[List[Callback]] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        trials: Optional[List[Trial]] = None,
        num_samples: Optional[int] = None,
    ):
        self.resources_per_trial = resources_per_trial or {"num_cpus": 1}
        n_cards = check_resources(self.resources_per_trial)
        self.trainable_blob = procs.dumps(
            trainable_cls, "the trainable", "trial processes",
            "define the trainable (function or class) and any function it "
            "is given at module level, not inside a function or as a "
            "lambda")
        self.searcher = searcher
        self.scheduler = scheduler
        self.metric = metric
        self.mode = mode
        self.experiment_dir = experiment_dir
        self.max_failures = max_failures
        self.checkpoint_freq = checkpoint_freq
        self.checkpoint_at_end = checkpoint_at_end
        # Trial-count cap applying to ANY searcher (reference semantics:
        # num_samples bounds Optuna/HyperOpt searchers too, not just the
        # basic variant generator). None falls back to the runaway
        # backstop.
        self.num_samples = num_samples
        self.stop_criteria = stop or {}
        self.callbacks = callbacks or []
        self._gpus = float(self.resources_per_trial.get("num_gpus", 0) or 0)
        self._cards = _Cards(n_cards)
        if max_concurrent <= 0:
            per = self.resources_per_trial.get("num_cpus", 1) or 1
            max_concurrent = max(1, int((os.cpu_count() or 1) // per))
        if self._gpus:
            max_concurrent = min(max_concurrent,
                                 self._cards.capacity(self._gpus))
        self.max_concurrent = max_concurrent

        self.trials: List[Trial] = trials or []
        # Injected (restored) trials must still enter the scheduler's
        # population or PBT/ASHA silently ignore them.
        for t in self.trials:
            self.scheduler.on_trial_add(t)
        self._ctx = _trial_context(bool(self._gpus)
                                   or _loads_torch(trainable_cls))
        self._procs: Dict[str, _TrialProcess] = {}
        self._held: Dict[str, List[int]] = {}  # trial id -> its cards
        self._inflight: Dict[int, Trial] = {}  # seq of a train call -> trial
        # Replies read while waiting for another call of the same process.
        self._stash: List[procs.Reply] = []
        self._searcher_done = False
        # Per trial id: the wall clock of each process start, ready, first
        # result and end, the processes' pids and cards (not persisted).
        self.timeline: Dict[str, Dict[str, Any]] = {}

    # ----------------------------------------------------------------- helpers

    def _trial_dir(self, trial: Trial) -> str:
        d = os.path.join(self.experiment_dir, trial.trial_id)
        os.makedirs(d, exist_ok=True)
        return d

    def _times(self, trial: Trial) -> Dict[str, Any]:
        return self.timeline.setdefault(trial.trial_id, {
            "starts": [], "ready": [], "ends": [], "pids": [], "cards": [],
            "first_result": None})

    def _spawn(self, trial: Trial) -> Optional[_TrialProcess]:
        cards: Optional[str] = None
        if self._gpus:
            picked = self._cards.take(self._gpus)
            if picked is None:
                return None
            self._held[trial.trial_id] = picked
            cards = self._cards.visible(picked)
        times = self._times(trial)
        times["starts"].append(time.time())
        times["cards"].append(cards)
        proc = _TrialProcess(self._ctx, trial, cards, self.trainable_blob)
        times["pids"].append(proc.pid)
        self._procs[trial.trial_id] = proc
        return proc

    def _call(self, proc: _TrialProcess, method: str, *args,
              timeout: Optional[float] = None) -> Any:
        """``method(*args)`` on a trial process, waited for; replies of its
        earlier calls are kept for the step loop."""
        seq = proc.send(method, args)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"trial {proc.trial.trial_id}: {method} "
                                   f"did not answer in {timeout} s")
            replies, dead = procs.wait([proc], left)
            for reply in replies:
                if reply[1] != seq:
                    self._stash.append(reply)
                    continue
                if reply[2] == "err":
                    raise TrialCallError(reply[3])
                return reply[3]
            if dead:
                raise TrialProcessDied(self._death(proc))

    def _death(self, proc: _TrialProcess) -> str:
        msg = (f"trial {proc.trial.trial_id}'s process {proc.pid} ended "
               f"(exit code {proc.exitcode()})")
        if proc.ready_error:
            msg += f"; its trainable did not build:\n{proc.ready_error}"
        return msg

    def _start_trial(self, trial: Trial, restore_path: Optional[str] = None) -> bool:
        trial.local_dir = self._trial_dir(trial)
        proc = self._spawn(trial)
        if proc is None:
            return False
        if restore_path:
            try:
                self._call(proc, "restore", restore_path)
            except Exception as e:
                # A broken/unreachable checkpoint is a *trial* failure, not an
                # experiment abort: count it against max_failures like any
                # other trial error (reference: trial-level FailureConfig).
                logger.exception(
                    "restore of trial %s from %s failed", trial.trial_id,
                    restore_path)
                trial.status = RUNNING  # so _handle_error's retry accounting runs
                self._handle_error(trial, e)
                return True
        trial.status = RUNNING
        self._submit_train(trial)
        return True

    def _submit_train(self, trial: Trial) -> None:
        seq = self._procs[trial.trial_id].send("train")
        self._inflight[seq] = trial

    def _kill_actor(self, trial: Trial, graceful: bool = True) -> None:
        proc = self._procs.pop(trial.trial_id, None)
        if proc is None:
            return
        self._inflight = {s: t for s, t in self._inflight.items()
                          if t is not trial}
        self._stash = [r for r in self._stash if r[0] is not proc]
        if graceful:
            try:
                self._call(proc, "stop", timeout=STOP_CALL_S)
            except Exception:
                pass
        procs.stop([proc])
        picked = self._held.pop(trial.trial_id, None)
        if picked is not None:
            self._cards.give(picked, self._gpus)
        self._times(trial)["ends"].append(time.time())

    def _checkpoint_trial(self, trial: Trial) -> Optional[str]:
        proc = self._procs.get(trial.trial_id)
        if proc is None:
            return None
        n = trial.iteration
        d = os.path.join(trial.local_dir, f"checkpoint_{n:06d}")
        try:
            path = self._call(proc, "save", d)
            trial.checkpoint_path = path
            return path
        except Exception:
            logger.exception("checkpoint of trial %s failed", trial.trial_id)
            return None

    def _should_stop(self, result: Dict[str, Any]) -> bool:
        if result.get(RESULT_DONE):
            return True
        for k, v in self.stop_criteria.items():
            if k in result and result[k] >= v:
                return True
        return False

    # ------------------------------------------------------------ trial intake

    def _trial_cap(self) -> int:
        """num_samples when set, else the runaway backstop. Trial intake and
        the run loop's done-check MUST use the same cap or they diverge."""
        return self.num_samples or 10_000

    def _maybe_request_trials(self) -> None:
        while not self._searcher_done and len(self.trials) < self._trial_cap():
            live = sum(1 for t in self.trials if t.status in (PENDING, RUNNING, PAUSED))
            if live >= self.max_concurrent * 2:
                return
            tid = uuid.uuid4().hex[:8]
            cfg = self.searcher.suggest(tid)
            if cfg == Searcher.FINISHED:
                self._searcher_done = True
                return
            if cfg is None:
                return
            trial = Trial(config=cfg, trial_id=tid)
            self.trials.append(trial)
            self.scheduler.on_trial_add(trial)
            for cb in self.callbacks:
                cb.on_trial_start(trial)

    # ------------------------------------------------------------- result path

    def _complete(self, trial: Trial, result: Dict[str, Any], status: str) -> None:
        if status == TERMINATED and (self.checkpoint_at_end or self.checkpoint_freq):
            self._checkpoint_trial(trial)
        self._kill_actor(trial)
        trial.status = status
        self.scheduler.on_trial_complete(trial, result)
        self.searcher.on_trial_complete(trial.trial_id, result, error=False)
        for cb in self.callbacks:
            cb.on_trial_complete(trial)

    def _handle_result(self, trial: Trial, result: Dict[str, Any]) -> None:
        times = self._times(trial)
        if times["first_result"] is None:
            times["first_result"] = time.time()
        trial.record_result(result)
        for cb in self.callbacks:
            cb.on_trial_result(trial, result)
        self.searcher.on_trial_result(trial.trial_id, result)

        if self._should_stop(result):
            self._complete(trial, result, TERMINATED)
            return

        decision = self.scheduler.on_trial_result(trial, result)
        if decision == sched.STOP:
            self._complete(trial, result, TERMINATED)
        elif decision == sched.PAUSE:
            donor: Optional[Trial] = getattr(trial, "_pbt_donor", None)
            new_config: Optional[Dict] = getattr(trial, "_pbt_new_config", None)
            if donor is not None and new_config is not None:
                self._exploit(trial, donor, new_config)
            else:
                self._checkpoint_trial(trial)
                self._kill_actor(trial)
                trial.status = PAUSED
        else:
            if self.checkpoint_freq and trial.iteration % self.checkpoint_freq == 0:
                self._checkpoint_trial(trial)
            self._submit_train(trial)

    def _exploit(self, trial: Trial, donor: Trial, new_config: Dict[str, Any]) -> None:
        """PBT exploit+explore: replace trial's state with donor's checkpoint
        and a perturbed config (reference pbt.py _exploit)."""
        trial._pbt_donor = None  # type: ignore[attr-defined]
        trial._pbt_new_config = None  # type: ignore[attr-defined]
        donor_ckpt = self._checkpoint_trial(donor) or donor.checkpoint_path
        if donor_ckpt is None:
            self._submit_train(trial)
            return
        self._kill_actor(trial, graceful=False)
        trial.config = new_config
        if not self._start_trial(trial, restore_path=donor_ckpt):
            trial.checkpoint_path = donor_ckpt
            trial.status = PAUSED  # resumed from the donor's checkpoint

    def _handle_error(self, trial: Trial, err: BaseException) -> None:
        trial.num_failures += 1
        for cb in self.callbacks:
            cb.on_trial_error(trial)
        if self.max_failures < 0 or trial.num_failures <= self.max_failures:
            logger.warning(
                "trial %s failed (%s), retry %d/%d",
                trial.trial_id, err, trial.num_failures, self.max_failures,
            )
            self._kill_actor(trial, graceful=False)
            if not self._start_trial(trial, restore_path=trial.checkpoint_path):
                trial.status = PAUSED  # its cards went to another trial
            return
        self._kill_actor(trial, graceful=False)
        trial.status = ERROR
        trial.error_msg = str(err)
        self.scheduler.on_trial_error(trial)
        self.searcher.on_trial_complete(trial.trial_id, None, error=True)
        for cb in self.callbacks:
            cb.on_trial_complete(trial)

    # -------------------------------------------------------------- main loop

    def _running(self) -> int:
        return sum(1 for t in self.trials if t.status == RUNNING)

    def _wait(self) -> Tuple[List[procs.Reply], List[procs.Worker]]:
        if self._stash:
            replies, self._stash = self._stash, []
            return replies, []
        return procs.wait(list(self._procs.values()), WAIT_S)

    def step(self) -> bool:
        """One controller iteration; returns False when the experiment is done."""
        self._maybe_request_trials()

        pending = [t for t in self.trials if t.status == PENDING]
        paused = [t for t in self.trials if t.status == PAUSED]
        while pending and self._running() < self.max_concurrent:
            trial = self.scheduler.choose_trial_to_run(pending)
            if trial is None:
                break
            # Restored trials resume from their last checkpoint rather than
            # retraining from scratch (reference: trial restore on resume).
            if not self._start_trial(trial, restore_path=trial.checkpoint_path):
                break
            pending.remove(trial)
        # Resume paused trials when capacity allows.
        while paused and self._running() < self.max_concurrent:
            if not self._start_trial(paused[0],
                                     restore_path=paused[0].checkpoint_path):
                break
            paused.pop(0)

        if not self._inflight:
            live = [t for t in self.trials if t.status in (PENDING, RUNNING, PAUSED)]
            # Done when nothing is live AND no further trial can be
            # requested — either the searcher said FINISHED or the
            # num_samples cap is reached (a searcher that never finishes,
            # e.g. TPE without max_trials, must not spin this loop forever).
            can_request = (not self._searcher_done
                           and len(self.trials) < self._trial_cap())
            return bool(live) or can_request

        replies, dead = self._wait()
        for proc, seq, status, value in replies:
            times = self._times(proc.trial)
            if proc.ready is not None and len(times["ready"]) < len(
                    times["starts"]):
                times["ready"].append(proc.ready["t_ready"])
            trial = self._inflight.pop(seq, None)
            if trial is None or trial.status != RUNNING:
                continue  # stale reply from a replaced process
            if status == "err":
                self._handle_error(trial, TrialCallError(value))
                continue
            self._handle_result(trial, value)
        for proc in dead:
            trial = proc.trial
            if self._procs.get(trial.trial_id) is not proc:
                continue  # already stopped or replaced
            self._handle_error(trial, TrialProcessDied(self._death(proc)))
        return True

    def run(self) -> List[Trial]:
        for cb in self.callbacks:
            cb.on_experiment_start(self)
        last_save = 0.0
        try:
            while self.step():
                if time.time() - last_save > 5:
                    save_experiment_state(
                        self.experiment_dir, self.trials, self.searcher.get_state(),
                        meta={"metric": self.metric, "mode": self.mode},
                    )
                    last_save = time.time()
        finally:
            for t in self.trials:
                if t.status == RUNNING:
                    self._kill_actor(t, graceful=False)
                    t.status = ERROR
                    t.error_msg = "experiment interrupted"
            save_experiment_state(
                self.experiment_dir, self.trials, self.searcher.get_state(),
                meta={"metric": self.metric, "mode": self.mode},
            )
            for cb in self.callbacks:
                cb.on_experiment_end(self)
        return self.trials
