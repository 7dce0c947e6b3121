#!/usr/bin/env python3
"""What a Tune trial process's start costs: one trial at a time, a
trainable that reports once, run ``--runs`` times; prints the medians of
the fit's wall, the seconds from the spawn to the process being ready
(the trainable built) and to its first result, for a trainable that
runs numpy (no torch in the trial process) and one that imports torch.
Runs on the CPU; from the repo root:

    python3 tools/tune_trial_start.py --runs 5
"""
import argparse
import json
import statistics
import sys
import tempfile
import time

sys.path.insert(0, ".")

from ray_tpu_torch import tune  # noqa: E402
from ray_tpu_torch.train import RunConfig  # noqa: E402


def numpy_trial(config):
    tune.report({"torch": "torch" in sys.modules})


def torch_trial(config):
    import torch  # noqa: F401

    tune.report({"torch": "torch" in sys.modules})


class _Watch(tune.Callback):
    def on_experiment_end(self, controller):
        (self.times,) = controller.timeline.values()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    root = tempfile.mkdtemp(prefix="rtpu_trial_start_")
    for fn in (numpy_trial, torch_trial):
        rows = []
        for i in range(args.runs):
            watch = _Watch()
            t0 = time.perf_counter()
            grid = tune.Tuner(fn, run_config=RunConfig(
                name=f"{fn.__name__}_{i}", storage_path=root,
                callbacks=[watch])).fit()
            fit_s = time.perf_counter() - t0
            tl = watch.times
            rows.append((fit_s, tl["ready"][0] - tl["starts"][0],
                         tl["first_result"] - tl["starts"][0]))
        fit_s, ready_s, first_s = (statistics.median(c) for c in zip(*rows))
        print(json.dumps({"trainable": fn.__name__, "runs": args.runs,
                          "torch_in_trial": grid[0].metrics["torch"],
                          "fit_s": fit_s, "spawn_to_ready_s": ready_s,
                          "spawn_to_first_result_s": first_s}), flush=True)
