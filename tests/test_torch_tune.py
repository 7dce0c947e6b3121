"""The port's Tune layer (``ray_tpu_torch.tune``) against the JAX
package's (``ray_tpu.tune``) on the CPU.

Every case of tests/test_tune.py, with its trainables at module level (a
trial process imports this module again to find them, so its top
imports neither jax nor torch); the searchers, schedulers, loggers and
the experiment state fed the same inputs through both packages; and the
trial processes: a trainable that does not pickle, a card asked without
CUDA, a trial process killed with SIGKILL, and no process left after any
fit. The Train and RLlib trainables through Tune are in
test_torch_tune_trainers.py and test_torch_tune_rllib.py.
"""
import json
import multiprocessing
import os
import random
import signal
import struct
import sys

import pytest

from ray_tpu_torch import tune
from ray_tpu_torch.train import CheckpointConfig, FailureConfig, RunConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune.search.basic_variant import generate_variants


def _no_children():
    assert multiprocessing.active_children() == []


def _fit(tuner):
    """fit(), then check that no trial process is left, pass or fail."""
    try:
        return tuner.fit()
    finally:
        _no_children()


def _run_config(tmp_path, name, **kw):
    return RunConfig(name=name, storage_path=str(tmp_path), **kw)


# ------------------------------------------------------------- search spaces


def test_generate_variants_grid_and_samples():
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.uniform(0.0, 1.0),
        "opt": "adam",
        "nested": {"units": tune.choice([32, 64])},
    }
    variants = generate_variants(space, num_samples=3, seed=0)
    assert len(variants) == 6  # 2 grid values x 3 samples
    for v in variants:
        assert v["lr"] in (0.1, 0.01)
        assert 0.0 <= v["wd"] <= 1.0
        assert v["opt"] == "adam"
        assert v["nested"]["units"] in (32, 64)


def test_domain_sampling_bounds():
    rng = random.Random(0)
    assert all(1 <= tune.randint(1, 10).sample(rng) < 10 for _ in range(50))
    lg = tune.loguniform(1e-4, 1e-1)
    assert all(1e-4 <= lg.sample(rng) <= 1e-1 for _ in range(50))


# ---------------------------------------------------------- function trainable


def _acc_fn(config):
    acc = 0.0
    for i in range(5):
        acc += config["lr"]
        tune.report({"acc": acc, "step": i,
                     "torch_loaded": "torch" in sys.modules})


def test_function_trainable_fit(tmp_path):
    tuner = tune.Tuner(
        _acc_fn,
        param_space={"lr": tune.grid_search([0.1, 0.2, 0.3])},
        tune_config=tune.TuneConfig(metric="acc", mode="max"),
        run_config=_run_config(tmp_path, "fn_exp"),
    )
    grid = _fit(tuner)
    assert len(grid) == 3
    best = grid.get_best_result()
    assert best.config["lr"] == pytest.approx(0.3)
    assert best.metrics["acc"] == pytest.approx(1.5)
    # A trial process running numpy never loads torch.
    assert best.metrics["torch_loaded"] is False
    # logger artifacts
    assert os.path.exists(os.path.join(best.path, "result.json"))
    assert os.path.exists(os.path.join(best.path, "progress.csv"))
    df = grid.get_dataframe()
    assert len(df) == 3


# --------------------------------------------------------------- class API


class _Quadratic(tune.Trainable):
    def setup(self, config):
        self.x = 0.0
        self.lr = config["lr"]

    def step(self):
        self.x += self.lr
        return {"score": -((self.x - 1.0) ** 2)}

    def save_checkpoint(self, d):
        with open(os.path.join(d, "x.txt"), "w") as f:
            f.write(str(self.x))

    def load_checkpoint(self, d):
        with open(os.path.join(d, "x.txt")) as f:
            self.x = float(f.read())


def test_class_trainable_with_stop(tmp_path):
    grid = _fit(tune.Tuner(
        _Quadratic,
        param_space={"lr": tune.grid_search([0.05, 0.2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=_run_config(tmp_path, "cls_exp",
                               stop={"training_iteration": 10}),
    ))
    assert len(grid) == 2
    best = grid.get_best_result()
    # at iteration 10 (stop): lr=0.05 -> x=0.5, score=-0.25; lr=0.2 -> x=2.0,
    # score=-1.0. Best-by-last-result is lr=0.05.
    assert best.config["lr"] == pytest.approx(0.05)
    assert best.metrics["training_iteration"] == 10
    assert best.checkpoint is not None  # checkpoint_at_end


def test_asha_rung_cutoff_unit():
    """A weak trial reaching a rung after a strong one is cut (async ASHA
    semantics: rung cutoff is the top-1/rf quantile of results recorded so
    far — reference schedulers/async_hyperband.py _Bracket.on_result)."""
    from ray_tpu_torch.tune.experiment import Trial
    from ray_tpu_torch.tune.schedulers import (CONTINUE, STOP,
                                               AsyncHyperBandScheduler)

    s = AsyncHyperBandScheduler(
        metric="score", mode="max", grace_period=2, reduction_factor=2, max_t=100
    )
    good, bad = Trial(config={}), Trial(config={})
    s.on_trial_add(good)
    s.on_trial_add(bad)
    assert s.on_trial_result(good, {"training_iteration": 2, "score": 10.0}) == CONTINUE
    assert s.on_trial_result(bad, {"training_iteration": 2, "score": 1.0}) == STOP
    # max_t bound stops even the good trial
    assert s.on_trial_result(good, {"training_iteration": 100, "score": 99.0}) == STOP


def _quality_fn(config):
    for i in range(20):
        tune.report({"score": config["quality"] * (i + 1)})


def test_asha_e2e_best_result(tmp_path):
    grid = _fit(tune.Tuner(
        _quality_fn,
        param_space={"quality": tune.grid_search([0.01, 0.02, 0.03, 1.0])},
        tune_config=tune.TuneConfig(
            metric="score",
            mode="max",
            max_concurrent_trials=4,
            scheduler=tune.AsyncHyperBandScheduler(
                metric="score", mode="max", grace_period=2, reduction_factor=2,
                max_t=20,
            ),
        ),
        run_config=_run_config(tmp_path, "asha"),
    ))
    best = grid.get_best_result()
    assert best.config["quality"] == 1.0


def _flaky(config):
    marker = config["marker"]
    tune.report({"ok": 1})
    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("boom")
    tune.report({"ok": 2})


def test_trial_failure_retry(tmp_path):
    marker = str(tmp_path / "fail_once")
    grid = _fit(tune.Tuner(
        _flaky,
        param_space={"marker": marker},
        tune_config=tune.TuneConfig(metric="ok", mode="max"),
        run_config=_run_config(
            tmp_path, "flaky", failure_config=FailureConfig(max_failures=2)),
    ))
    assert not grid.errors
    assert grid.get_best_result().metrics["ok"] == 2


def _pbt_fn(config):
    import time as _time

    ckpt = tune.get_checkpoint()
    x = ckpt.to_dict()["x"] if ckpt else 0.0
    lr = config["lr"]
    for _ in range(30):
        x += lr
        # PBT needs an overlapping population: pace iterations so both
        # trials are alive across several perturbation intervals.
        _time.sleep(0.05)
        tune.report({"score": x, "pid": os.getpid()},
                    checkpoint=Checkpoint.from_dict({"x": x}))


def test_pbt_exploits_and_perturbs(tmp_path):
    pbt = tune.PopulationBasedTraining(
        metric="score",
        mode="max",
        perturbation_interval=5,
        hyperparam_mutations={"lr": tune.uniform(0.0, 1.0)},
        seed=0,
    )
    grid = _fit(tune.Tuner(
        _pbt_fn,
        param_space={"lr": tune.grid_search([0.001, 1.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", scheduler=pbt, max_concurrent_trials=2
        ),
        run_config=_run_config(tmp_path, "pbt"),
    ))
    assert not grid.errors
    scores = sorted(r.metrics["score"] for r in grid)
    # the bad trial (lr=0.001 alone would reach 0.03) must have been lifted
    # by exploiting the good trial's checkpoint
    assert scores[0] > 0.05
    # The exploit replaced the bad trial's process: every process the
    # trials ran in is gone.
    pids = set()
    for r in grid:
        with open(os.path.join(r.path, "result.json")) as f:
            pids |= {json.loads(line)["pid"] for line in f if line.strip()}
    assert len(pids) >= 3, pids
    assert not [p for p in pids if _alive(p)]


def _m_fn(config):
    for i in range(3):
        tune.report({"m": config["v"] * (i + 1)})


def test_tuner_restore_resumes_unfinished(tmp_path):
    exp_dir = str(tmp_path / "resumable")
    grid = _fit(tune.Tuner(
        _m_fn,
        param_space={"v": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="m", mode="max"),
        run_config=_run_config(tmp_path, "resumable"),
    ))
    assert len(grid) == 2
    # restore: everything already terminal -> immediate completed grid
    grid2 = _fit(tune.Tuner.restore(exp_dir, _m_fn))
    assert len(grid2) == 2
    assert grid2.get_best_result().metrics["m"] == pytest.approx(6.0)


# ----------------------------------------------------------- the TPE searcher


def test_tpe_finds_quadratic_optimum():
    """TPE beats pure random on a smooth 2D objective within a fixed
    budget: the model-based phase concentrates samples near the optimum
    (reference: hyperopt-backed search; the TPE algorithm built in here)."""
    from ray_tpu_torch.tune.search import TPESearcher
    from ray_tpu_torch.tune.search.sample import Categorical, Float

    def objective(cfg):
        # max at x=0.7, y=0.2, bonus for arm "b"
        return (-(cfg["x"] - 0.7) ** 2 - (cfg["y"] - 0.2) ** 2
                + (0.05 if cfg["arm"] == "b" else 0.0))

    space = {"x": Float(0.0, 1.0), "y": Float(0.0, 1.0),
             "arm": Categorical(["a", "b", "c"])}

    def run(searcher_budget, seed):
        s = TPESearcher(space, metric="score", mode="max", n_initial=8,
                        seed=seed)
        for i in range(searcher_budget):
            tid = f"t{i}"
            cfg = s.suggest(tid)
            s.on_trial_complete(tid, {"score": objective(cfg)})
        # The mean of the LAST 10 suggestions' scores: convergence, not
        # luck.
        tail = []
        for i in range(10):
            tid = f"tail{i}"
            cfg = s.suggest(tid)
            sc = objective(cfg)
            s.on_trial_complete(tid, {"score": sc})
            tail.append(sc)
        return sum(tail) / len(tail)

    def run_random(budget, seed):
        rng = random.Random(seed)
        scores = [objective({"x": rng.uniform(0, 1), "y": rng.uniform(0, 1),
                             "arm": rng.choice(["a", "b", "c"])})
                  for _ in range(10)]
        return sum(scores) / len(scores)

    tpe_tail = sum(run(40, s) for s in range(3)) / 3
    rand_tail = sum(run_random(40, s) for s in range(3)) / 3
    assert tpe_tail > rand_tail + 0.05, (tpe_tail, rand_tail)


def test_tpe_domain_handling():
    """Normal domains are modeled (unbounded, no crash after warmup);
    grid_search and callable leaves are rejected upfront."""
    from ray_tpu_torch.tune.search import TPESearcher
    from ray_tpu_torch.tune.search.sample import Normal, grid_search

    s = TPESearcher({"w": Normal(0.0, 1.0)}, metric="m", mode="min",
                    n_initial=4, seed=1)
    for i in range(12):  # past warmup into the model-based phase
        cfg = s.suggest(f"t{i}")
        s.on_trial_complete(f"t{i}", {"m": (cfg["w"] - 0.5) ** 2})
    assert isinstance(cfg["w"], float)

    with pytest.raises(ValueError, match="grid_search"):
        TPESearcher({"bs": grid_search([32, 64])}, metric="m", mode="min")
    with pytest.raises(ValueError, match="callable"):
        TPESearcher({"lr": lambda: 3}, metric="m", mode="min")


def _log_lr_fn(config):
    import math

    # Best at lr = 1e-2.
    tune.report({"loss": abs(math.log10(config["lr"]) + 2)})


def test_tpe_with_tuner_end_to_end(tmp_path):
    from ray_tpu_torch.tune.search import TPESearcher
    from ray_tpu_torch.tune.search.sample import Float

    space = {"lr": Float(1e-4, 1e-1, log=True)}
    searcher = TPESearcher(space, metric="loss", mode="min", n_initial=5)
    tuner = tune.Tuner(
        _log_lr_fn,
        tune_config=tune.TuneConfig(search_alg=searcher, num_samples=15,
                                    metric="loss", mode="min"),
        run_config=_run_config(tmp_path, "tpe"),
    )
    results = _fit(tuner)
    assert len(results) == 15
    best = results.get_best_result(metric="loss", mode="min")
    assert best.metrics["loss"] < 1.0


def _loss_acc_fn(config):
    for i in range(3):
        tune.report({"loss": 1.0 / (i + 1), "acc": i * 0.1})


def _records(path):
    """The records of a TFRecord-framed file, each CRC checked."""
    from ray_tpu_torch.util.tensorboard import _masked_crc

    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "bad length CRC"
            (n,) = struct.unpack("<Q", header)
            rec = f.read(n)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert dcrc == _masked_crc(rec), "bad data CRC"
            out.append(rec)
    return out


def test_tensorboard_logger_writes_valid_event_files(tmp_path):
    """Tuner's default TB logger emits event files with VALID masked-CRC32C
    framing and scalar Summary protos (TensorBoard rejects bad CRCs, so the
    test re-verifies them rather than trusting the writer)."""
    import glob

    from ray_tpu_torch.data.tfrecord_lite import _fields

    _fit(tune.Tuner(
        _loss_acc_fn,
        param_space={"lr": tune.grid_search([0.1, 0.2])},
        run_config=_run_config(tmp_path, "exp"),
    ))
    files = glob.glob(str(tmp_path / "exp" / "*" / "events.out.tfevents.*"))
    assert len(files) == 2, files  # one per trial
    events = _records(files[0])
    # Event 0: file_version; later events carry scalar summaries.
    tags = set()
    steps = set()
    for rec in events[1:]:
        for fnum, wire, val in _fields(rec):
            if fnum == 2 and wire == 0:
                steps.add(val)
            if fnum == 5 and wire == 2:  # Summary
                for sf, sw, sv in _fields(val):
                    if sf == 1 and sw == 2:  # Value
                        for vf, vw, vv in _fields(sv):
                            if vf == 1 and vw == 2:
                                tags.add(bytes(vv).decode())
    assert {"loss", "acc"} <= tags, tags
    assert {1, 2, 3} <= steps, steps


# ------------------------------------ the same inputs through both packages


def test_variants_match_the_jax_package():
    """generate_variants and BasicVariantGenerator give the JAX package's
    variants for a seed: grids, nested domains, every kind of draw, a
    callable leaf that reads the resolved spec."""
    from ray_tpu import tune as jtune
    from ray_tpu.tune.search.basic_variant import (
        generate_variants as jgenerate)

    def space(t):
        return {
            "lr": t.loguniform(1e-4, 1e-1),
            "bs": t.grid_search([16, 32]),
            "wd": t.uniform(0.0, 0.1),
            "layers": t.randint(1, 9),
            "width": t.qrandint(32, 256, 32),
            "noise": t.randn(0.0, 2.0),
            "opt": {"name": t.choice(["adam", "sgd", "lamb"]),
                    "beta": t.grid_search([0.9, 0.99])},
            "double_bs": _double_bs,
            "fixed": 7,
        }

    for seed in (0, 1, 17):
        want = jgenerate(space(jtune), num_samples=3, seed=seed)
        got = generate_variants(space(tune), num_samples=3, seed=seed)
        assert got == want
        jgen = jtune.BasicVariantGenerator(space(jtune), num_samples=2,
                                           seed=seed)
        gen = tune.BasicVariantGenerator(space(tune), num_samples=2,
                                         seed=seed)
        assert gen.total_variants == jgen.total_variants == 8
        for i in range(9):
            assert gen.suggest(f"t{i}") == jgen.suggest(f"t{i}")
        assert gen.get_state() == jgen.get_state()


def _double_bs(spec):
    return 2 * spec["bs"]


def test_tpe_suggestions_match_the_jax_package():
    """TPESearcher suggests the JAX package's configs for a seed after the
    same observed results, through the random and the model phases, on
    Float (linear and log), Integer, Categorical and Normal dimensions."""
    from ray_tpu.tune.search import TPESearcher as JTPE
    from ray_tpu.tune.search import sample as jsample
    from ray_tpu_torch.tune.search import TPESearcher
    from ray_tpu_torch.tune.search import sample

    def space(s):
        return {"x": s.Float(0.0, 1.0), "lr": s.Float(1e-4, 1e-1, log=True),
                "n": s.Integer(1, 64, q=4), "arm": s.Categorical("abc"),
                "w": s.Normal(0.0, 1.0), "fixed": "keep"}

    for seed in (0, 5):
        j = JTPE(space(jsample), metric="m", mode="min", n_initial=6,
                 seed=seed)
        p = TPESearcher(space(sample), metric="m", mode="min", n_initial=6,
                        seed=seed)
        for i in range(20):
            got, want = p.suggest(f"t{i}"), j.suggest(f"t{i}")
            assert got == want, i
            score = (got["x"] - 0.3) ** 2 + abs(got["w"]) + got["n"] / 64
            if i % 7 != 3:  # some trials never report
                p.on_trial_complete(f"t{i}", {"m": score})
                j.on_trial_complete(f"t{i}", {"m": score})
        assert p.get_state() == j.get_state()


def _stream(n_trials, iters, seed):
    """A scripted stream of results: (trial index, result) in an
    interleaved arrival order."""
    rng = random.Random(seed)
    quality = [rng.uniform(0.1, 2.0) for _ in range(n_trials)]
    cursor = [0] * n_trials
    out = []
    while any(c < iters for c in cursor):
        i = rng.choice([k for k in range(n_trials) if cursor[k] < iters])
        cursor[i] += 1
        t = cursor[i]
        out.append((i, {"training_iteration": t,
                        "score": quality[i] * t + rng.gauss(0, 0.3)}))
    return out


@pytest.mark.parametrize("kind", ["asha", "median", "pbt"])
def test_scheduler_decisions_match_the_jax_package(kind):
    """ASHA, MedianStoppingRule and PBT (seeded) make the JAX package's
    decision on every result of the same scripted stream; PBT's donors and
    new configs are the same too."""
    from ray_tpu import tune as jtune
    from ray_tpu.tune.experiment import RUNNING as JRUNNING
    from ray_tpu.tune.experiment import Trial as JTrial
    from ray_tpu_torch.tune.experiment import RUNNING, Trial

    def make(t):
        if kind == "asha":
            return t.AsyncHyperBandScheduler(
                metric="score", mode="max", grace_period=2,
                reduction_factor=2, max_t=16)
        if kind == "median":
            return t.MedianStoppingRule(metric="score", mode="max",
                                        grace_period=3,
                                        min_samples_required=3)
        return t.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=3,
            hyperparam_mutations={"lr": t.uniform(0.0, 1.0),
                                  "bs": [16, 32, 64, 128],
                                  "layers": t.randint(1, 8)},
            seed=3)

    n = 8
    configs = [{"lr": 0.1 * (i + 1), "bs": 32, "layers": 2 + i % 5}
               for i in range(n)]
    jsched, psched = make(jtune), make(tune)
    jtrials = [JTrial(config=dict(c), trial_id=f"t{i}")
               for i, c in enumerate(configs)]
    ptrials = [Trial(config=dict(c), trial_id=f"t{i}")
               for i, c in enumerate(configs)]
    for jt, pt in zip(jtrials, ptrials):
        jt.status, pt.status = JRUNNING, RUNNING
        jsched.on_trial_add(jt)
        psched.on_trial_add(pt)
    stopped = set()
    decisions = []
    for i, result in _stream(n, 16, seed=11):
        if i in stopped:
            continue
        jt, pt = jtrials[i], ptrials[i]
        jt.record_result(dict(result))
        pt.record_result(dict(result))
        jd = jsched.on_trial_result(jt, dict(result))
        pd = psched.on_trial_result(pt, dict(result))
        assert pd == jd, (i, result)
        decisions.append(pd)
        if pd == "STOP":
            stopped.add(i)
            jsched.on_trial_complete(jt, result)
            psched.on_trial_complete(pt, result)
        elif pd == "PAUSE":
            assert pt._pbt_donor.trial_id == jt._pbt_donor.trial_id
            assert pt._pbt_new_config == jt._pbt_new_config
            pt.config = pt._pbt_new_config
            jt.config = jt._pbt_new_config
    assert len(set(decisions)) >= 2, decisions  # the stream decides


def test_logger_files_match_the_jax_package(tmp_path, monkeypatch):
    """The JSON, CSV and TensorBoard loggers write the JAX package's files
    byte for byte for the same results (the wall clock fixed): nested
    metrics, a key that appears late (the CSV is rewritten), strings,
    booleans and numpy scalars."""
    import time

    import numpy as np

    from ray_tpu.tune import callbacks as jcb
    from ray_tpu.tune.experiment import Trial as JTrial
    from ray_tpu_torch.tune import callbacks as pcb
    from ray_tpu_torch.tune.experiment import Trial

    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    results = [
        {"training_iteration": 1, "loss": 0.5, "done": False,
         "info": {"lr": 0.1, "tag": "a"}},
        {"training_iteration": 2, "loss": np.float32(0.25), "done": False,
         "info": {"lr": 0.1, "tag": "b"}, "late": 3},
        {"loss": 0.125, "done": True, "info": {"lr": 0.2, "tag": "c"},
         "late": np.int64(4)},
    ]
    dirs = {}
    for name, cb, trial_cls in (("jax", jcb, JTrial), ("port", pcb, Trial)):
        d = tmp_path / name
        d.mkdir()
        trial = trial_cls(config={"lr": 0.1, "nested": {"k": [1, 2]}},
                          trial_id="t0")
        trial.local_dir = str(d)
        loggers = [cb.JsonLoggerCallback(), cb.CSVLoggerCallback(),
                   cb.TensorBoardLoggerCallback()]
        for r in results:
            for lg in loggers:
                lg.on_trial_result(trial, dict(r))
        for lg in loggers:
            lg.on_experiment_end(None)
        dirs[name] = d
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"]))
    assert {"params.json", "result.json", "progress.csv"} <= set(names)
    assert any(n.startswith("events.out.tfevents.") for n in names)
    for n in names:
        want = (dirs["jax"] / n).read_bytes()
        assert (dirs["port"] / n).read_bytes() == want, n
        assert want


def test_experiment_state_from_the_jax_package_loads(tmp_path):
    """An experiment state that the JAX package's save_experiment_state
    wrote loads in the port's load_experiment_state to the same trials."""
    from ray_tpu.tune.experiment import Trial as JTrial
    from ray_tpu.tune.experiment import save_experiment_state
    from ray_tpu_torch.tune.experiment import (Trial, load_experiment_state)

    jtrials = []
    for i, status in enumerate(["TERMINATED", "ERROR", "RUNNING",
                                "PAUSED", "PENDING"]):
        t = JTrial(config={"lr": 0.1 * i, "nested": {"bs": 32}},
                   trial_id=f"t{i}")
        t.status = status
        t.record_result({"training_iteration": i, "m": i * 1.5})
        t.checkpoint_path = f"/ckpt/{i}" if i % 2 else None
        t.error_msg = "boom" if status == "ERROR" else None
        t.num_failures = i % 3
        t.local_dir = f"/exp/t{i}"
        jtrials.append(t)
    save_experiment_state(str(tmp_path), jtrials, {"idx": 5},
                          meta={"metric": "m", "mode": "min"})
    state = load_experiment_state(str(tmp_path))
    assert state["searcher"] == {"idx": 5}
    assert state["meta"] == {"metric": "m", "mode": "min"}
    trials = [Trial.from_json(d) for d in state["trials"]]
    assert [t.to_json() for t in trials] == [t.to_json() for t in jtrials]
    assert load_experiment_state(str(tmp_path / "none")) is None


# ----------------------------------------------------------- trial processes


def _gpu_fn(config):
    tune.report({"x": 1})


def test_trainable_that_does_not_pickle_raises_before_any_spawn(tmp_path):
    def nested(config):
        tune.report({"x": 1})

    for fn in (nested, lambda config: None):
        with pytest.raises(TypeError, match="at module level"):
            tune.Tuner(fn, run_config=_run_config(tmp_path, "nested")).fit()
        _no_children()


def test_card_without_cuda_raises_before_any_spawn(tmp_path):
    tuner = tune.Tuner(tune.with_resources(_gpu_fn, {"num_gpus": 1}),
                       run_config=_run_config(tmp_path, "gpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tuner.fit()
    _no_children()
    with pytest.raises(ValueError, match="unknown trial resources"):
        tune.Tuner(tune.with_resources(_acc_fn_copy, {"TPU": 1}),
                   run_config=_run_config(tmp_path, "tpu")).fit()
    _no_children()


def _acc_fn_copy(config):
    tune.report({"x": 1})


class _Killed(tune.Trainable):
    """Counts; its process kills itself with SIGKILL once, at step 3."""

    def setup(self, config):
        self.x = 0

    def step(self):
        self.x += 1
        marker = self.config["marker"]
        if self.x == 3 and not os.path.exists(marker):
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return {"x": self.x, "pid": os.getpid()}

    def save_checkpoint(self, d):
        with open(os.path.join(d, "x.txt"), "w") as f:
            f.write(str(self.x))

    def load_checkpoint(self, d):
        with open(os.path.join(d, "x.txt")) as f:
            self.x = int(f.read())


def test_killed_trial_process_is_retried_from_its_checkpoint(tmp_path):
    """A trial process killed with SIGKILL is a trial error: under
    max_failures it starts again in a new process from its last
    checkpoint (every iteration here) and finishes."""
    grid = _fit(tune.Tuner(
        _Killed,
        param_space={"marker": str(tmp_path / "killed_once")},
        tune_config=tune.TuneConfig(metric="x", mode="max"),
        run_config=_run_config(
            tmp_path, "killed", stop={"training_iteration": 5},
            failure_config=FailureConfig(max_failures=1),
            checkpoint_config=CheckpointConfig(checkpoint_frequency=1)),
    ))
    assert not grid.errors
    (r,) = grid
    assert r.metrics["x"] == 5 and r.metrics["training_iteration"] == 5
    with open(os.path.join(r.path, "result.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    # Iterations 1-2 in the first process; 3-5 in the second, resumed at
    # the checkpoint of iteration 2.
    assert [row["x"] for row in rows] == [1, 2, 3, 4, 5]
    assert [row["training_iteration"] for row in rows] == [1, 2, 3, 4, 5]
    first, second = rows[0]["pid"], rows[-1]["pid"]
    assert first != second and rows[2]["pid"] == second
    assert not _alive(first) and not _alive(second)

    # Without a retry left, the death is the trial's error.
    grid = _fit(tune.Tuner(
        _Killed,
        param_space={"marker": str(tmp_path / "killed_again")},
        run_config=_run_config(tmp_path, "killed2",
                               stop={"training_iteration": 5}),
    ))
    (r,) = grid
    assert r.error and "exit code -9" in r.error, r.error


def _alive(pid):
    """Is process ``pid`` alive (a zombie counts as gone)?"""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_asha_stop_leaves_no_trial_process(tmp_path):
    """Four trials under ASHA, two at a time: the stopped ones' processes
    are gone as soon as they are stopped, the others' at their end."""
    from ray_tpu_torch.tune.callbacks import Callback

    class Watch(Callback):
        def __init__(self):
            self.left = []

        def on_trial_complete(self, trial):
            self.left.append([c.pid for c in
                              multiprocessing.active_children()])

    watch = Watch()
    grid = _fit(tune.Tuner(
        _quality_fn,
        param_space={"quality": tune.grid_search([1.0, 0.01, 0.02, 0.5])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=tune.AsyncHyperBandScheduler(
                metric="score", mode="max", grace_period=2,
                reduction_factor=2, max_t=20)),
        run_config=_run_config(tmp_path, "asha_left", callbacks=[watch]),
    ))
    stopped = [r for r in grid if r.metrics["training_iteration"] < 20]
    assert stopped, [r.metrics for r in grid]
    # At most the other running trial's process when one completes.
    assert all(len(left) <= 1 for left in watch.left), watch.left
    assert len(watch.left) == 4


def _card_fn(config):
    import tempfile

    tune.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                 "tmpdir": tempfile.gettempdir(), "ppid": os.getppid(),
                 "pid": os.getpid(),
                 "torch_loaded": "torch" in sys.modules})


@pytest.mark.parametrize("gpus,cards,at_once", [(1, 2, 2), (0.5, 1, 2)])
def test_card_trials_fork_with_their_cards(tmp_path, monkeypatch, gpus,
                                           cards, at_once):
    """Trials that take cards (here on a CPU made to show ``cards`` of
    them; the trainable touches no card) fork from the preloaded fork
    server: torch is there before the trial imports anything, and the
    trial has the controller's environment of the moment it was asked for
    (TMPDIR) and the cards the controller gave it in
    CUDA_VISIBLE_DEVICES: distinct whole cards, or shares of one card
    packed on it. No trial process is left, and the fork server is
    stopped with procs.stop_fork_server."""
    from ray_tpu_torch.tune import tune_controller
    from ray_tpu_torch.util import procs

    monkeypatch.setattr(tune_controller, "check_resources",
                        lambda resources: cards)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ctl = []

    class Watch(tune.Callback):
        def on_experiment_end(self, controller):
            ctl.append(controller)

    try:
        grid = _fit(tune.Tuner(
            tune.with_resources(_card_fn_copy(gpus), {"num_gpus": gpus}),
            param_space={"i": tune.grid_search([0, 1, 2])},
            run_config=_run_config(tmp_path, f"cards_{gpus}_{cards}",
                                   callbacks=[Watch()])))
    finally:
        procs.stop_fork_server()
    assert not grid.errors
    (controller,) = ctl
    assert controller.max_concurrent == at_once
    got = [r.metrics for r in grid]
    assert all(m["torch_loaded"] and m["ppid"] != os.getpid()
               and m["tmpdir"] == str(tmp_path) for m in got), got
    if gpus == 1:
        assert all(m["visible"] in [str(c) for c in range(cards)]
                   for m in got), got
    else:
        assert {m["visible"] for m in got} == {"0"}, got
    assert not [m["pid"] for m in got if _alive(m["pid"])]


def _card_fn_copy(gpus):
    """A module-level trainable of its own for each resource request
    (with_resources marks the function it is given)."""
    return {1: _card_fn, 0.5: _card_fn_half}[gpus]


def _card_fn_half(config):
    _card_fn(config)
