"""Trainable: the unit of execution Tune schedules.

The port's counterpart of the JAX package's ``tune/trainable.py``.
Parity: reference tune/trainable/trainable.py (class API: setup/step/
save_checkpoint/load_checkpoint, driven by train()/save()/restore()) and
tune/trainable/function_trainable.py (function API: user fn runs on its own
thread, `tune.report(...)` hands results to the controller one step at a
time). `wrap_trainer_as_trainable` is the Train->Tune glue the reference
builds in base_trainer._generate_trainable_cls (:693).

A trainable class goes to its trial process by plain pickle, by
reference (the JAX package sends it with cloudpickle). The classes that
``wrap_function`` and ``wrap_trainer_as_trainable`` build pickle as the
call that builds them again, with the function (by reference) or the
trainer (by value) as its argument: a function defined inside another or
a lambda raises in the calling process, before any trial process
starts.
"""
from __future__ import annotations

import copy
import copyreg
import dataclasses
import functools
import inspect
import os
import pickle
import queue
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ..train.checkpoint import Checkpoint

RESULT_DONE = "done"
TRAINING_ITERATION = "training_iteration"

# Seconds a stopping function trainable waits for its function to end
# (a Train trial's fit shuts its workers down first).
STOP_JOIN_S = 60.0


class Trainable:
    """Class API: subclass and override setup/step/save_checkpoint/load_checkpoint."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self._iteration = 0
        self._start_time = time.time()
        self.setup(self.config)

    # -------------------------------------------------------------- overrides

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        """Write state into checkpoint_dir."""
        raise NotImplementedError

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        raise NotImplementedError

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """In-place config swap (PBT fast path). Return True if handled."""
        return False

    # -------------------------------------------------------- controller API

    def train(self) -> Dict[str, Any]:
        result = self.step() or {}
        self._iteration += 1
        result.setdefault(TRAINING_ITERATION, self._iteration)
        result.setdefault("time_total_s", time.time() - self._start_time)
        result.setdefault(RESULT_DONE, False)
        return result

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        d = checkpoint_dir or tempfile.mkdtemp(prefix="rtpu_trial_ckpt_")
        os.makedirs(d, exist_ok=True)
        self.save_checkpoint(d)
        with open(os.path.join(d, ".tune_metadata.pkl"), "wb") as f:
            pickle.dump({"iteration": self._iteration}, f)
        return d

    def restore(self, checkpoint_path: str) -> None:
        self.load_checkpoint(checkpoint_path)
        meta = os.path.join(checkpoint_path, ".tune_metadata.pkl")
        if os.path.exists(meta):
            with open(meta, "rb") as f:
                self._iteration = pickle.load(f)["iteration"]

    def reset(self, new_config: Dict[str, Any]) -> bool:
        if self.reset_config(new_config):
            self.config = dict(new_config)
            return True
        return False

    def stop(self) -> None:
        self.cleanup()


# ---------------------------------------------------------------- function API

_session = threading.local()


class TrialStopped(Exception):
    """Raised by ``tune.report`` in a function trainable whose trial the
    controller stopped: the function unwinds (a Train trial's fit shuts
    its workers down on the way)."""


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Called from inside a function trainable (reference: tune.report /
    ray.train.report under Tune)."""
    sess = getattr(_session, "current", None)
    if sess is None:
        raise RuntimeError("tune.report() called outside a Tune function trainable")
    sess.put(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    sess = getattr(_session, "current", None)
    return sess.restore_checkpoint if sess else None


class _FnSession:
    def __init__(self, restore_checkpoint: Optional[Checkpoint]):
        self.results: "queue.Queue[Any]" = queue.Queue()
        self.resume: "queue.Queue[None]" = queue.Queue()
        self.restore_checkpoint = restore_checkpoint
        self.stopping = False

    def put(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint]) -> None:
        if self.stopping:
            raise TrialStopped("the trial was stopped")
        self.results.put((dict(metrics), checkpoint))
        self.resume.get()  # block until the result was taken (backpressure)
        if self.stopping:
            raise TrialStopped("the trial was stopped")


class _Rebuilt(type):
    """The type of the classes ``wrap_function`` and
    ``wrap_trainer_as_trainable`` build: such a class pickles as
    ``_rebuild``, the call that builds it again."""


copyreg.pickle(_Rebuilt, lambda cls: cls._rebuild)


class FunctionTrainable(Trainable):
    """Adapts `def train_fn(config)` to the class API via a worker thread."""

    _fn: Callable = None  # set by subclass factory

    def setup(self, config: Dict[str, Any]) -> None:
        self._sess = _FnSession(restore_checkpoint=None)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._latest_checkpoint: Optional[Checkpoint] = None
        self._last_metrics: Dict[str, Any] = {}

    def _runner(self) -> None:
        _session.current = self._sess
        try:
            fn = type(self)._fn
            sig = inspect.signature(fn)
            if len(sig.parameters) >= 1:
                fn(self.config)
            else:
                fn()
        except BaseException as e:  # surfaced on the next train()
            self._error = e
        finally:
            self._sess.results.put(None)  # sentinel: function returned

    def step(self) -> Dict[str, Any]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._runner, daemon=True)
            self._thread.start()
        item = self._sess.results.get()
        if item is None:
            if self._error is not None:
                raise self._error
            # Terminal result keeps the last reported metrics (reference:
            # function_trainable delivers the final report with done=True).
            final = dict(self._last_metrics)
            final[RESULT_DONE] = True
            return final
        metrics, checkpoint = item
        if checkpoint is not None:
            self._latest_checkpoint = checkpoint
        self._sess.resume.put(None)
        metrics.setdefault(RESULT_DONE, False)
        self._last_metrics = dict(metrics)
        return metrics

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        if self._latest_checkpoint is not None:
            self._latest_checkpoint.to_directory(checkpoint_dir)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        self._sess.restore_checkpoint = Checkpoint.from_directory(checkpoint_dir)

    def cleanup(self) -> None:
        """Unwind the function: its next (or pending) ``report`` raises
        :class:`TrialStopped`; wait for it to end (bounded)."""
        self._sess.stopping = True
        self._sess.resume.put(None)
        if self._thread is not None:
            self._thread.join(STOP_JOIN_S)


def _function_class(name: str, fn: Callable, rebuild) -> type:
    return _Rebuilt(name, (FunctionTrainable,),
                    {"_fn": staticmethod(fn), "_rebuild": rebuild,
                     "__module__": __name__})


def wrap_function(fn: Callable) -> type:
    """Build a FunctionTrainable subclass bound to `fn`."""
    name = getattr(fn, "__name__", "fn")
    return _function_class(f"FnTrainable_{name}", fn, (wrap_function, (fn,)))


def _report_train_item(item: Dict[str, Any]) -> None:
    """A rank-0 ``train.report`` of a fit inside a trial, as an
    intermediate Tune result numbered by the loop's reports."""
    report({**item["metrics"], TRAINING_ITERATION: item["iteration"]})


def _fit_trainer(trainer, config: Dict[str, Any]) -> None:
    t = copy.copy(trainer)
    merged = dict(t.train_loop_config or {})
    merged.update(config.get("train_loop_config", config))
    t.train_loop_config = merged
    # Trials of one trainer may fit at once: each its own storage.
    name = t.run_config.name or "train"
    t.run_config = dataclasses.replace(
        t.run_config, name=f"{name}_{uuid.uuid4().hex[:8]}")
    t._tune_report_hook = _report_train_item
    result = t.fit()
    report(dict(result.metrics), checkpoint=result.checkpoint)


def wrap_trainer_as_trainable(trainer) -> type:
    """Train->Tune glue (reference base_trainer._generate_trainable_cls:693):
    a trial runs `trainer.fit()` with the trial's config merged into
    train_loop_config. Each rank-0 `train.report` inside the fit streams to
    the Tune controller as an intermediate result (so ASHA/PBT can act
    mid-trial), and the final result carries the best checkpoint. The
    class asks, for its trial, one CPU and the cards of the trainer's
    workers (``ScalingConfig``): a trial's workers take its cards."""
    cls = _function_class(
        f"TrainerTrainable_{type(trainer).__name__}",
        functools.partial(_fit_trainer, trainer),
        (wrap_trainer_as_trainable, (trainer,)))
    scaling = trainer.scaling_config
    cls._tune_resources = {
        "num_cpus": 1,
        "num_gpus": scaling.num_workers if scaling.use_gpu else 0}
    return cls


def resolve_trainable(trainable) -> type:
    """Accept a class or function; normalize to a Trainable class."""
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        return trainable
    if callable(trainable):
        return wrap_function(trainable)
    if hasattr(trainable, "as_trainable"):
        return trainable.as_trainable()
    raise TypeError(f"not a trainable: {trainable!r}")
