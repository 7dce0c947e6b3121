"""Callbacks + built-in loggers (the port's copy of the JAX package's
``tune/callbacks.py``: the same files, byte for byte).

Parity: reference tune/callback.py (Callback hooks) and tune/logger/
(CSVLoggerCallback, JsonLoggerCallback) — per-trial progress.csv,
result.json (jsonl) and params.json files in the trial dir, the layout
analysis tools expect.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, Optional, TextIO


class Callback:
    def on_experiment_start(self, controller) -> None:
        pass

    def on_trial_start(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial) -> None:
        pass

    def on_trial_error(self, trial) -> None:
        pass

    def on_experiment_end(self, controller) -> None:
        pass


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


class JsonLoggerCallback(Callback):
    """Appends each result as a JSON line to <trial_dir>/result.json and
    writes params.json once."""

    def __init__(self):
        self._files: Dict[str, TextIO] = {}

    def _ensure(self, trial) -> Optional[TextIO]:
        if not trial.local_dir:
            return None
        f = self._files.get(trial.trial_id)
        if f is None:
            with open(os.path.join(trial.local_dir, "params.json"), "w") as pf:
                json.dump(trial.config, pf, default=str)
            f = open(os.path.join(trial.local_dir, "result.json"), "a")
            self._files[trial.trial_id] = f
        return f

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        f = self._ensure(trial)
        if f:
            f.write(json.dumps(result, default=str) + "\n")
            f.flush()

    def on_experiment_end(self, controller) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class CSVLoggerCallback(Callback):
    """Appends flattened results to <trial_dir>/progress.csv.

    Buffers rows in memory and rewrites the file whenever a new metric key
    first appears, so late-appearing columns aren't dropped; appends to an
    existing file (experiment restore) only when its header still matches.
    """

    def __init__(self):
        # trial_id -> {"path", "fields": [..], "rows": [...], "file": f|None}
        self._state: Dict[str, Dict[str, Any]] = {}

    def _rewrite(self, st: Dict[str, Any]) -> None:
        if st["file"] is not None:
            st["file"].close()
        f = open(st["path"], "w", newline="")
        w = csv.DictWriter(f, fieldnames=st["fields"], restval="")
        w.writeheader()
        for row in st["rows"]:
            w.writerow(row)
        st["file"] = f

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        if not trial.local_dir:
            return
        flat = _flatten(result)
        st = self._state.get(trial.trial_id)
        if st is None:
            path = os.path.join(trial.local_dir, "progress.csv")
            st = {"path": path, "fields": list(flat.keys()), "rows": [],
                  "file": None}
            if os.path.exists(path):
                # Resumed trial: keep prior rows so restore doesn't truncate
                # history (result.json appends; the two must stay in sync).
                try:
                    with open(path, newline="") as old:
                        reader = csv.DictReader(old)
                        if reader.fieldnames:
                            st["fields"] = list(reader.fieldnames)
                            st["rows"] = list(reader)
                except Exception:
                    pass
            self._state[trial.trial_id] = st
        new_keys = [k for k in flat if k not in st["fields"]]
        st["rows"].append(flat)
        if new_keys or st["file"] is None:
            st["fields"].extend(new_keys)
            self._rewrite(st)
        else:
            csv.DictWriter(st["file"], fieldnames=st["fields"],
                           restval="", extrasaction="ignore").writerow(flat)
        st["file"].flush()

    def on_experiment_end(self, controller) -> None:
        for st in self._state.values():
            if st["file"] is not None:
                st["file"].close()
        self._state.clear()


class TensorBoardLoggerCallback(Callback):
    """Per-trial TensorBoard event files under <trial_dir>/ (reference:
    tune/logger/tensorboardx.py TBXLoggerCallback; writer is the
    dependency-free util/tensorboard.py — the image ships no tensorboardX).
    Steps use the result's training_iteration when present."""

    def __init__(self):
        self._writers: Dict[str, Any] = {}
        self._steps: Dict[str, int] = {}

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        if not trial.local_dir:
            return
        w = self._writers.get(trial.trial_id)
        if w is None:
            from ..util.tensorboard import EventFileWriter

            w = self._writers[trial.trial_id] = EventFileWriter(
                trial.local_dir)
        step = result.get("training_iteration")
        if not isinstance(step, int):
            step = self._steps.get(trial.trial_id, 0) + 1
        self._steps[trial.trial_id] = step
        w.add_scalars(_flatten(result), step=step)

    def on_experiment_end(self, controller) -> None:
        for w in self._writers.values():
            w.close()
        self._writers.clear()
