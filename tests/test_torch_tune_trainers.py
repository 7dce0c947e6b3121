"""Trainers as Tune trials (``ray_tpu_torch.tune``) on the CPU:
``TorchTrainer`` through ``Tuner`` on gpt2_tiny, its losses bit for bit
the same trainer's ``fit()`` outside Tune; a Train trial's workers (the
trial process's children) gone after an ASHA stop mid-fit and after the
trial process is killed with SIGKILL. Trainables are at module level (a
trial process and its workers import this module again); its top
imports no jax and nothing of RLlib (PPO through Tune is in
test_torch_tune_rllib.py).
"""
import concurrent.futures
import json
import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import tune
from ray_tpu_torch.train import (CheckpointConfig, DataParallelTrainer,
                                 FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer, TrainCallback)
from ray_tpu_torch.util import procs
from test_torch_tune import _alive

GPT_B, GPT_S, GPT_STEPS = 4, 16, 3


def _no_children():
    assert multiprocessing.active_children() == []


def _none_alive(pids, within_s=10.0):
    """True once none of ``pids`` is alive (an orphan leaves when it sees
    its caller gone)."""
    deadline = time.time() + within_s
    while any(_alive(p) for p in pids):
        if time.time() > deadline:
            return False
        time.sleep(0.05)
    return True


@pytest.fixture(scope="module", autouse=True)
def _worker_tmpdir(tmp_path_factory):
    """Trial processes and their workers inherit TMPDIR: their temporary
    dict checkpoints land in the test's directory. Trainer trials fork
    from the preloaded fork server, stopped at the end."""
    old = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = str(tmp_path_factory.mktemp("trial_tmp"))
    yield
    procs.stop_fork_server()
    if old is None:
        del os.environ["TMPDIR"]
    else:
        os.environ["TMPDIR"] = old


# ------------------------------------------------------ TorchTrainer in Tune


class AdamWAt:
    """The default optimizer's AdamW at learning rate ``lr``."""

    def __init__(self, lr):
        self.lr = lr

    def __call__(self, leaves):
        return torch.optim.AdamW(leaves, lr=self.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.0)


def _gpt_tiny_loop(config):
    """gpt2_tiny on the backend's mesh (RULES_DP), params from a seed:
    GPT_STEPS AdamW steps at the config's lr, each loss reported; the last
    report carries a dict checkpoint."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.parallel import RULES_DP

    torch.set_num_threads(1)
    cfg = configs.gpt2_tiny(dtype=torch.float32)
    ts = train.transformer_train_step(cfg, train.get_mesh(), rules=RULES_DP,
                                      optimizer=AdamWAt(config["lr"]))
    params, opt = ts.init(torch.Generator().manual_seed(config["seed"]))
    batch = ts.shard_batch({"tokens": torch.from_numpy(config["tokens"])})
    for step in range(GPT_STEPS):
        params, opt, loss = ts.step(params, opt, batch)
        ckpt = None
        if step == GPT_STEPS - 1:
            ckpt = train.Checkpoint.from_dict({"step": step,
                                               "loss": float(loss)})
        train.report({"loss": float(loss), "step": step,
                      "pid": os.getpid()},
                     checkpoint=ckpt if train.get_context()
                     .get_world_rank() == 0 else None)


class _Record(TrainCallback):
    def __init__(self):
        self.reports = []

    def on_report(self, iteration, metrics, checkpoint=None):
        self.reports.append(dict(metrics))


def test_torch_trainer_through_tune_matches_its_fit(tmp_path):
    """TorchTrainer(device="cpu", num_workers=2) on gpt2_tiny as a Tune
    trainable: a grid of two learning rates, the trials' intermediate
    results numbered by the loop's reports, each trial's losses bit for
    bit those of the same trainer's fit() outside Tune; the best result's
    checkpoint reads back; no trial process or worker left."""
    from ray_tpu_torch.models import configs

    cfg = configs.gpt2_tiny(dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (GPT_B, GPT_S)).astype(np.int64)

    def trainer(lr, rec=None):
        return TorchTrainer(
            _gpt_tiny_loop,
            train_loop_config={"lr": lr, "seed": 0, "tokens": tokens},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name=f"fit_{lr}", storage_path=str(tmp_path),
                                 callbacks=[rec] if rec else None),
            device="cpu")

    assert issubclass(trainer(1e-3).as_trainable(), tune.FunctionTrainable)
    recs = {lr: _Record() for lr in (3e-4, 3e-3)}
    # The two fits outside Tune side by side: they mostly wait on their
    # workers.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(trainer(lr, rec).fit)
                  for lr, rec in recs.items()]:
            f.result()
    _no_children()
    want = {lr: [r["loss"] for r in rec.reports] for lr, rec in recs.items()}
    grid = tune.Tuner(
        trainer(1e-3),
        param_space={"train_loop_config": {
            "lr": tune.grid_search([3e-4, 3e-3])}},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(
            name="tuned", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(checkpoint_at_end=True)),
    ).fit()
    _no_children()
    assert not grid.errors
    pids = set()
    for r in grid:
        with open(os.path.join(r.path, "result.json")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        steps = [row for row in rows if "step" in row and not row["done"]]
        assert [row["training_iteration"] for row in steps[:GPT_STEPS]] == [
            1, 2, 3]
        lr = r.config["train_loop_config"]["lr"]
        assert [row["loss"] for row in steps[:GPT_STEPS]] == want[lr], lr
        pids |= {row["pid"] for row in rows}
    best = grid.get_best_result()
    assert best.metrics["loss"] == min(v[-1] for v in want.values())
    assert best.checkpoint.to_dict()["step"] == GPT_STEPS - 1
    assert _none_alive(pids)


# ---------------------------------------------- a Train trial's workers leave


def _numpy_loop(config):
    """Steps of nothing on every rank, each worker's pid in a file; rank
    0 reports every step. With ``kill_at``, rank 0 kills its parent, the
    trial process, once (a marker file)."""
    from ray_tpu_torch import train

    rank = train.get_context().get_world_rank()
    with open(os.path.join(config["pid_dir"], f"{os.getpid()}"), "w"):
        pass
    for step in range(config["steps"]):
        time.sleep(0.02)
        marker = config.get("marker")
        if (rank == 0 and step == config.get("kill_at")
                and not os.path.exists(marker)):
            open(marker, "w").close()
            deadline = time.time() + 30  # every worker's pid is written
            while len(os.listdir(config["pid_dir"])) < config["workers"] \
                    and time.time() < deadline:
                time.sleep(0.01)
            os.kill(os.getppid(), signal.SIGKILL)
            time.sleep(30)  # the worker leaves once it sees its caller gone
        train.report({"score": config["quality"] * (step + 1),
                      "step": step})


def _numpy_trainer(tmp_path, workers=2, **config):
    return DataParallelTrainer(
        _numpy_loop, train_loop_config=dict(config, workers=workers),
        scaling_config=ScalingConfig(num_workers=workers),
        run_config=RunConfig(storage_path=str(tmp_path / "train")))


def test_asha_stops_a_train_trial_mid_fit_and_its_workers_leave(tmp_path):
    """Train trials under ASHA, one at a time: the weak one is stopped at
    a rung while its fit runs, its workers shut down with it; no trial
    process or worker is left."""
    pid_dir = tmp_path / "pids"
    pid_dir.mkdir()
    grid = tune.Tuner(
        _numpy_trainer(tmp_path, workers=1, steps=12, pid_dir=str(pid_dir)),
        param_space={"train_loop_config": {
            "quality": tune.grid_search([1.0, 0.1])}},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=1,
            scheduler=tune.AsyncHyperBandScheduler(
                metric="score", mode="max", grace_period=2,
                reduction_factor=2, max_t=100)),
        run_config=RunConfig(name="asha_train", storage_path=str(tmp_path)),
    ).fit()
    _no_children()
    assert not grid.errors
    its = {r.config["train_loop_config"]["quality"]:
           r.metrics["training_iteration"] for r in grid}
    assert its[1.0] >= 12 and its[0.1] == 2, its
    pids = [int(p) for p in os.listdir(pid_dir)]
    assert len(pids) == 2  # a worker a trial
    assert _none_alive(pids, within_s=0.0)


def test_killed_train_trial_takes_its_workers_and_is_retried(tmp_path):
    """The trial process of a Train trial killed with SIGKILL mid-fit
    (by its worker): the worker leaves at once (its caller is gone), and
    the trial runs again in a new process with a new worker and
    finishes."""
    pid_dir = tmp_path / "pids"
    pid_dir.mkdir()
    grid = tune.Tuner(
        _numpy_trainer(tmp_path, workers=1, steps=4, pid_dir=str(pid_dir),
                       kill_at=2, marker=str(tmp_path / "killed_once"),
                       quality=1.0),
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="killed_train", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    _no_children()
    assert not grid.errors
    (r,) = grid
    assert r.metrics["score"] == 4.0
    pids = [int(p) for p in os.listdir(pid_dir)]
    assert len(pids) == 2  # the worker of each of the trial's processes
    assert _none_alive(pids)
