"""Training callbacks (reference: the AIR/session callback hooks plus the
framework-integration callbacks — Lightning/Transformers reporting — that
ride them; air/config.py RunConfig(callbacks=...)).

Callbacks observe the DRIVER-side training loop: every worker report, each
checkpoint registration, run start/end. They must never throw into the
loop — exceptions are swallowed per-callback (a broken logger cannot kill
a 2-hour run)."""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional


class TrainCallback:
    """Override any subset; all hooks are optional."""

    def on_start(self, config: Optional[Dict[str, Any]]) -> None:
        pass

    def on_report(self, iteration: int, metrics: Dict[str, Any],
                  checkpoint: Any = None) -> None:
        pass

    def on_end(self, metrics: Dict[str, Any],
               error: Optional[BaseException]) -> None:
        pass


class JsonLineLogger(TrainCallback):
    """One JSON line per report (reference JsonLoggerCallback shape)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def on_start(self, config) -> None:
        self._f = open(self.path, "a", buffering=1)

    def on_report(self, iteration, metrics, checkpoint=None) -> None:
        if self._f:
            self._f.write(json.dumps(
                {"iteration": iteration, "ts": time.time(), **metrics},
                default=str) + "\n")

    def on_end(self, metrics, error) -> None:
        if self._f:
            self._f.close()
            self._f = None


class ProgressPrinter(TrainCallback):
    """Human progress lines every ``every_n`` reports."""

    def __init__(self, every_n: int = 1, file=None):
        self.every_n = max(1, every_n)
        self.file = file or sys.stderr

    def on_report(self, iteration, metrics, checkpoint=None) -> None:
        if iteration % self.every_n:
            return
        keys = [f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in list(metrics.items())[:6]]
        print(f"[train iter {iteration}] " + " ".join(keys),
              file=self.file)


class TransformersCallbackAdapter(TrainCallback):
    """Drive a ``transformers.TrainerCallback`` from this loop (the
    HF-integration analog: the reference ships framework report callbacks
    that translate its session reports into the framework's own callback
    protocol; here the translation runs the other way — our reports feed
    an HF callback's ``on_log``)."""

    def __init__(self, hf_callback: Any):
        self.hf_callback = hf_callback
        self._state = None
        self._control = None
        self._args = None

    def _ensure(self):
        if self._state is not None:
            return
        from transformers import TrainerControl, TrainerState

        class _Args:  # minimal TrainingArguments surface on_log touches
            logging_dir = None
            process_index = 0
            local_process_index = 0
            world_size = 1

        self._state = TrainerState()
        self._control = TrainerControl()
        self._args = _Args()

    def on_report(self, iteration, metrics, checkpoint=None) -> None:
        self._ensure()
        self._state.global_step = iteration
        self._state.log_history.append(dict(metrics))
        self.hf_callback.on_log(self._args, self._state, self._control,
                                logs=dict(metrics))

    def on_end(self, metrics, error) -> None:
        if self._state is None:
            return
        try:
            self.hf_callback.on_train_end(self._args, self._state,
                                          self._control)
        except AttributeError:
            pass


class CallbackList:
    """Fan a hook out to every callback, isolating failures."""

    def __init__(self, callbacks: Optional[List[TrainCallback]]):
        self.callbacks = [c for c in (callbacks or [])
                          if isinstance(c, TrainCallback)]

    def _fan(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(*args)
            except Exception as e:  # noqa: BLE001 — observer must not kill
                print(f"[train] callback {type(cb).__name__}.{hook} "
                      f"failed: {e!r}", file=sys.stderr)

    def on_start(self, config) -> None:
        self._fan("on_start", config)

    def on_report(self, iteration, metrics, checkpoint=None) -> None:
        self._fan("on_report", iteration, metrics, checkpoint)

    def on_end(self, metrics, error) -> None:
        self._fan("on_end", metrics, error)
