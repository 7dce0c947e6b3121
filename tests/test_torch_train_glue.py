"""The port's Train layer (``ray_tpu_torch.train``: trainers, worker
processes, backends, session, checkpoints, callbacks, predictor) against
the JAX package's ``ray_tpu.train``.

Every case of ``tests/test_train.py`` runs through the port on spawned
CPU worker processes (gloo): the DP smoke, checkpoints and top-k
retention, restart from a checkpoint, the failure budget, ranks, the
profiler, callbacks. Then the port is held to the JAX package: the MNIST
loop's per-step losses (1e-6), ``TorchTrainer`` on gpt2_tiny against the
JAX sharded step on 2 virtual devices (1e-4), and ``TorchPredictor``
against ``JaxPredictor`` (1e-5). After every fit, passing or failing, no
child process is left.

A worker imports this module again to find its loop, so the module
imports neither jax nor the JAX package at the top: the reference side
imports them inside its functions. Spawning a worker costs seconds (an
interpreter and torch), so the runs that tests/test_train.py's cases read
start side by side in one module fixture, and cases that read one run
share it.
"""
import concurrent.futures
import glob
import json
import multiprocessing
import os
import shutil

import numpy as np
import pytest
import torch

from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    TrainCallback,
    TrainingFailedError,
)

torch.set_num_threads(2)

MLP_STEPS = 5
LOSS_ATOL_MNIST = 1e-6
LOSS_ATOL_GPT = 1e-4
LOGITS_ATOL = 1e-5
GPT_STEPS = 3
GPT_B, GPT_S = 4, 16


# ------------------------------------------------------- loops (workers)

def _mlp_train_loop(config):
    """tests/test_train.py's loop against the port: a numpy MLP on an
    MNIST-shaped problem, its gradients host-allreduced every step.
    ``fail_how="exit"`` makes rank 1 leave with ``os._exit`` at the failure
    step, as a killed worker does."""
    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.util import collective

    ctx = train.get_context()
    group = train.session.collective_group_name() or "train_default"
    rng = np.random.default_rng(ctx.get_world_rank())
    X = rng.standard_normal((64, 64)).astype(np.float32)
    true_w = rng.standard_normal((64, 10)).astype(np.float32)
    y = (X @ true_w).argmax(axis=1)

    w1 = np.zeros((64, 32), np.float32)
    w2 = np.zeros((32, 10), np.float32)
    rng0 = np.random.default_rng(0)
    if ctx.get_world_rank() == 0:
        w1 = rng0.standard_normal((64, 32)).astype(np.float32) * 0.1
        w2 = rng0.standard_normal((32, 10)).astype(np.float32) * 0.1
    w1 = collective.broadcast(w1, 0, group)
    w2 = collective.broadcast(w2, 0, group)

    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_dict()
        w1, w2, start = state["w1"], state["w2"], state["step"]

    lr = 0.1
    for step in range(start, config["steps"]):
        h = np.maximum(X @ w1, 0)
        logits = h @ w2
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        onehot = np.eye(10, dtype=np.float32)[y]
        loss = -np.mean(np.log(p[np.arange(len(y)), y] + 1e-9))
        dlogits = (p - onehot) / len(y)
        gw2 = h.T @ dlogits
        dh = dlogits @ w2.T
        dh[h <= 0] = 0
        gw1 = X.T @ dh
        n = collective.get_collective_group_size(group)
        gw1 = collective.allreduce(gw1, group) / n
        gw2 = collective.allreduce(gw2, group) / n
        w1 -= lr * gw1
        w2 -= lr * gw2
        ckpt_out = None
        if config.get("checkpoint") and ctx.get_world_rank() == 0:
            ckpt_out = Checkpoint.from_dict({"w1": w1, "w2": w2, "step": step + 1})
        if config.get("fail_at") is not None and step + 1 == config["fail_at"] \
                and not os.path.exists(config["fail_marker"]):
            if config.get("fail_how") == "exit":
                if ctx.get_world_rank() == 1:
                    with open(config["fail_marker"], "w") as f:
                        f.write("exited once")
                    os._exit(7)
            else:
                with open(config["fail_marker"], "w") as f:
                    f.write("failed once")
                raise RuntimeError("injected failure")
        train.report({"loss": float(loss), "step": step}, checkpoint=ckpt_out)


def _ranks_and_losses_loop(config):
    """The reference's rank probe, profile capture and callback loop in
    one run (a run costs a spawn): rank 0 profiles a matmul."""
    from ray_tpu_torch import train

    ctx = train.get_context()
    if ctx.get_world_rank() == 0:
        with train.session.profile(config["logdir"]):
            x = torch.ones((64, 64))
            (x @ x).sum().item()
    for i in range(3):
        train.report({"loss": 1.0 / (i + 1),
                      "world_rank": ctx.get_world_rank(),
                      "world_size": ctx.get_world_size(),
                      "local_rank": ctx.get_local_rank()})


def _always_fail(config):
    raise ValueError("boom")


def _slow_loop(config):
    import time

    from ray_tpu_torch import train

    for i in range(1000):
        train.report({"i": i})
        time.sleep(0.05)


def _gpt_loop(config):
    """gpt2_tiny on the backend's mesh (RULES_DP), from the JAX params:
    GPT_STEPS AdamW steps; the last saves the state sharded and reports
    the params gathered whole."""
    from ray_tpu_torch import convert, train
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.parallel import sharding as shd

    cfg = configs.gpt2_tiny(dtype=torch.float32)
    mesh = train.get_mesh()
    ts = train.transformer_train_step(cfg, mesh, rules=shd.RULES_DP)
    params = convert.params_to_mesh(config["params"], cfg, mesh, shd.RULES_DP)
    opt = ts.init_opt_state(params)
    batch = ts.shard_batch(config["batch"])
    rank = train.get_context().get_world_rank()
    for step in range(GPT_STEPS):
        params, opt, loss = ts.step(params, opt, batch)
        metrics = {"loss": float(loss), "step": step,
                   "local_rows": batch["tokens"].to_local().shape[0]}
        ckpt = None
        if step == GPT_STEPS - 1:
            ckpt = Checkpoint.save_sharded(ts.state_tree(params, opt),
                                           config["ckpt_dir"])
            metrics["params"] = convert.params_to_numpy(params)
        train.report(metrics, checkpoint=ckpt if rank == 0 else None)


# ---------------------------------------------------------------- helpers

class _Record(TrainCallback):
    def __init__(self):
        self.reports = []

    def on_report(self, iteration, metrics, checkpoint=None):
        self.reports.append(dict(metrics))


def _no_children():
    assert multiprocessing.active_children() == []


def _fit(trainer):
    """fit(), then check that no worker process is left, pass or fail."""
    try:
        return trainer.fit()
    finally:
        _no_children()


def _run_config(tmp_path, name, **kw):
    return RunConfig(name=name, storage_path=str(tmp_path), **kw)


@pytest.fixture(scope="module", autouse=True)
def _worker_tmpdir(tmp_path_factory):
    """The workers inherit TMPDIR: their temporary dict checkpoints (which
    the trainer copies into storage) land in the test's directory."""
    old = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = str(tmp_path_factory.mktemp("worker_tmp"))
    yield
    if old is None:
        del os.environ["TMPDIR"]
    else:
        os.environ["TMPDIR"] = old


def _outcome(trainer):
    """fit()'s result, or the exception it raised."""
    try:
        return trainer.fit()
    except Exception as e:  # noqa: BLE001 — a case asserts on it
        return e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tests/test_train.py runs that read one fit each, started side by
    side (each spawns its own workers, and a spawn is most of a run): the
    MNIST smoke (5 steps, rank 0 checkpointing, top-2 kept), the ranks /
    profile / callbacks run, the restart after a raised failure, the
    restart after a worker's os._exit, and the exhausted budget. Once every
    fit has returned, no worker process is left."""
    from ray_tpu_torch.train.callbacks import (JsonLineLogger,
                                               TransformersCallbackAdapter)

    tmp = {n: tmp_path_factory.mktemp(n) for n in (
        "mnist", "ranks", "restart", "exit", "fail")}
    recs = {n: _Record() for n in ("mnist", "ranks", "restart", "exit")}
    probe, hf = _Probe(), _HFProbe()
    jl = tmp["ranks"] / "log.jsonl"

    def mlp(name, loop_config, **run):
        return DataParallelTrainer(
            _mlp_train_loop, train_loop_config=loop_config,
            scaling_config=ScalingConfig(num_workers=2),
            run_config=_run_config(tmp[name], name, callbacks=[recs[name]],
                                   **run))

    restart = {"steps": 6, "checkpoint": True, "fail_at": 3}
    trainers = {
        "mnist": mlp("mnist", {"steps": MLP_STEPS, "checkpoint": True},
                     checkpoint_config=CheckpointConfig(num_to_keep=2)),
        "restart": mlp("restart", dict(
            restart, fail_marker=str(tmp["restart"] / "marker")),
            failure_config=FailureConfig(max_failures=1)),
        "exit": mlp("exit", dict(
            restart, fail_marker=str(tmp["exit"] / "marker"),
            fail_how="exit"), failure_config=FailureConfig(max_failures=1)),
        "ranks": DataParallelTrainer(
            _ranks_and_losses_loop,
            train_loop_config={"logdir": str(tmp["ranks"] / "trace")},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=_run_config(tmp["ranks"], "cbtest", callbacks=[
                probe, recs["ranks"], JsonLineLogger(str(jl)),
                TransformersCallbackAdapter(hf)])),
        "fail": DataParallelTrainer(
            _always_fail, train_loop_config={},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=_run_config(tmp["fail"], "dp_fail")),
    }
    with concurrent.futures.ThreadPoolExecutor(len(trainers)) as pool:
        futures = {n: pool.submit(_outcome, t) for n, t in trainers.items()}
        out = {n: f.result() for n, f in futures.items()}
    _no_children()
    return {"out": out, "reports": {n: r.reports for n, r in recs.items()},
            "tmp": tmp, "probe": probe, "hf": hf, "jl": jl}


@pytest.fixture(scope="module")
def mnist(runs):
    return runs["out"]["mnist"], runs["reports"]["mnist"]


class _Probe(TrainCallback):
    def __init__(self):
        self.started = self.ended = False
        self.error = "unset"

    def on_start(self, config):
        self.started = True

    def on_end(self, metrics, error):
        self.ended = True
        self.error = error


class _HFProbe:  # transformers.TrainerCallback duck type
    def __init__(self):
        self.logs = []
        self.train_ended = False

    def on_log(self, args, state, control, logs=None, **kw):
        self.logs.append((state.global_step, dict(logs or {})))

    def on_train_end(self, args, state, control, **kw):
        self.train_ended = True


# ---------------------------------------------- tests/test_train.py cases

def test_data_parallel_allreduce_smoke(mnist):
    result, reports = mnist
    assert result.error is None
    assert result.metrics["step"] == MLP_STEPS - 1
    assert result.metrics["loss"] < 2.5  # moved off init loss
    assert [r["step"] for r in reports] == list(range(MLP_STEPS))
    assert len(result.spawn_s) == 1


def test_checkpoint_and_metrics(mnist):
    result, _ = mnist
    assert result.checkpoint is not None
    state = result.checkpoint.to_dict()
    assert state["step"] == MLP_STEPS
    # top-k retention: the two newest kept, the rest deleted from storage
    assert len(result.best_checkpoints) == 2
    kept = sorted(os.listdir(result.path))
    assert kept == [f"checkpoint_{i:06d}" for i in (3, 4)], kept


def test_failure_restart_resumes_from_checkpoint(runs):
    result = runs["out"]["restart"]
    assert result.error is None
    assert os.path.exists(runs["tmp"]["restart"] / "marker")  # it failed
    assert result.metrics["step"] == 5
    assert result.checkpoint.to_dict()["step"] == 6
    # Steps 0-1 reported, step 2 failed, the restart resumed at step 2.
    assert [r["step"] for r in runs["reports"]["restart"]] == [0, 1, 2, 3,
                                                               4, 5]
    assert len(result.spawn_s) == 2


def test_failure_budget_exhausted(runs):
    error = runs["out"]["fail"]
    assert isinstance(error, TrainingFailedError)
    assert "ValueError: boom" in str(error)


def test_worker_context_ranks(runs):
    result = runs["out"]["ranks"]
    assert result.metrics["world_size"] == 2
    assert result.metrics["world_rank"] == 0
    assert result.metrics["local_rank"] == 0


def test_session_profile_capture(runs):
    """session.profile wraps torch.profiler on a train worker: rank 0's
    Chrome trace lands in the logdir, with the matmul in it."""
    logdir = runs["tmp"]["ranks"] / "trace"
    files = glob.glob(os.path.join(logdir, "*"))
    assert [os.path.basename(f) for f in files] == ["trace_rank0.json"]
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_train_callbacks_and_hf_adapter(runs):
    """RunConfig(callbacks=...) observes every rank-0 report: the JSONL
    logger captures them and a transformers.TrainerCallback receives
    on_log through the adapter."""
    probe, hf, jl = runs["probe"], runs["hf"], runs["jl"]
    assert probe.started and probe.ended and probe.error is None
    assert [r["loss"] for r in runs["reports"]["ranks"]] == [1.0, 0.5,
                                                            1 / 3]
    lines = [json.loads(line) for line in jl.read_text().splitlines()]
    assert [line["iteration"] for line in lines] == [1, 2, 3]
    assert len(lines) == 3 and lines[0]["loss"] == 1.0
    assert hf.logs and hf.logs[-1][0] == 3
    assert hf.train_ended


# ------------------------------------------------ the port against JAX

def test_mnist_losses_match_the_jax_package(mnist, ray_start_regular,
                                            tmp_path):
    """The same loop, seeds and world on both sides: the reference's
    DataParallelTrainer on 2 control-plane workers (its rendezvous actor)
    and the port's on 2 gloo workers; per-step losses within 1e-6."""
    import test_train
    from ray_tpu.train import DataParallelTrainer as JaxDPTrainer
    from ray_tpu.train import RunConfig as JaxRunConfig
    from ray_tpu.train import ScalingConfig as JaxScalingConfig
    from ray_tpu.train.callbacks import TrainCallback as JaxTrainCallback

    class JaxRecord(JaxTrainCallback):
        def __init__(self):
            self.losses = []

        def on_report(self, iteration, metrics, checkpoint=None):
            self.losses.append(metrics["loss"])

    rec = JaxRecord()
    JaxDPTrainer(
        test_train._mlp_train_loop,
        train_loop_config={"steps": MLP_STEPS},
        scaling_config=JaxScalingConfig(num_workers=2),
        run_config=JaxRunConfig(name="dp_ref", storage_path=str(tmp_path),
                                callbacks=[rec]),
    ).fit()
    port = [r["loss"] for r in mnist[1]]
    assert len(rec.losses) == len(port) == MLP_STEPS
    np.testing.assert_allclose(port, rec.losses, atol=LOSS_ATOL_MNIST,
                               rtol=0)


def _jax_gpt2_tiny():
    import jax

    from ray_tpu.models import configs as jconfigs
    from ray_tpu.models import transformer as jtfm

    jcfg = jconfigs.gpt2_tiny(dtype=jax.numpy.float32)
    params = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0),
                                                       jcfg))
    return jcfg, params


def test_torch_trainer_matches_the_jax_sharded_step(tmp_path):
    """TorchTrainer(device="cpu", mesh_shape={"data": 2}) on gpt2_tiny, the
    flash attention through its plain versions: 3 AdamW steps' losses
    within 1e-4 of the JAX package's sharded step on 2 virtual devices
    from the same params; the sharded checkpoint the ranks save reads back
    whole in the test's process, with no process group."""
    import jax

    from ray_tpu.parallel import RULES_DP, MeshSpec, make_mesh
    from ray_tpu.train.step import transformer_train_step

    jcfg, params = _jax_gpt2_tiny()
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (GPT_B, GPT_S)).astype(np.int32)
    rec = _Record()
    trainer = TorchTrainer(
        _gpt_loop,
        train_loop_config={"params": params, "batch": {"tokens": tokens},
                           "ckpt_dir": str(tmp_path / "sharded")},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=_run_config(tmp_path, "gpt", callbacks=[rec]),
        mesh_shape={"data": 2}, device="cpu",
    )
    # fit() mostly waits on its workers: the JAX side runs here
    # meanwhile.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fit = pool.submit(_fit, trainer)
        ts = transformer_train_step(
            jcfg, make_mesh(MeshSpec(data=2), devices=jax.devices()[:2]),
            rules=RULES_DP)
        jparams = jax.device_put(params, ts.param_shardings)
        opt = jax.jit(ts.optimizer.init)(jparams)
        batch = ts.shard_batch({"tokens": tokens})
        want = []
        for _ in range(GPT_STEPS):
            jparams, opt, loss = ts.step(jparams, opt, batch)
            want.append(float(loss))
        result = fit.result()

    assert [r["local_rows"] for r in rec.reports] == [GPT_B // 2] * GPT_STEPS
    np.testing.assert_allclose([r["loss"] for r in rec.reports], want,
                               atol=LOSS_ATOL_GPT, rtol=0)
    # The checkpoint: copied into storage by fit(), read whole here.
    assert result.checkpoint.path.startswith(str(tmp_path / "gpt"))
    tree = result.checkpoint.load_sharded()
    got = rec.reports[-1]["params"]
    assert sorted(tree["params"]) == sorted(got)
    for k, v in got.items():
        if k == "layers":
            for name, leaf in v.items():
                np.testing.assert_array_equal(
                    tree["params"]["layers"][name].numpy(), leaf)
        else:
            np.testing.assert_array_equal(tree["params"][k].numpy(), v)
    assert sorted(tree["opt_state"]["embed"]) == ["exp_avg", "exp_avg_sq",
                                                  "step"]
    assert float(tree["opt_state"]["embed"]["step"]) == GPT_STEPS


def test_torch_predictor_matches_jax_predictor():
    from ray_tpu.models import transformer as jtfm
    from ray_tpu.train import JaxPredictor
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.train import TorchPredictor

    jcfg, params = _jax_gpt2_tiny()
    cfg = configs.gpt2_tiny(dtype=torch.float32)
    ckpt = Checkpoint.from_dict({"params": params})
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = JaxPredictor(lambda p, x: jtfm.forward(p, x, jcfg),
                        params).predict(tokens)
    pred = TorchPredictor.from_checkpoint(
        ckpt, lambda p, x: tfm.forward(p, x, cfg), device="cpu")
    got = pred.predict(tokens)
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGITS_ATOL,
                               rtol=0)
    # A dict batch: the predictions land beside the input column.
    out = TorchPredictor(lambda p, x: tfm.forward(p, x, cfg),
                         ckpt.to_dict()["params"], input_column="tokens",
                         device="cpu").predict({"tokens": tokens})
    assert sorted(out) == ["predictions", "tokens"]
    np.testing.assert_array_equal(out["predictions"], got)
    shutil.rmtree(ckpt.path)


# ----------------------------------------------- the port's own process model

def test_dead_worker_counts_as_one_failure_and_resumes(runs):
    """Rank 1 leaves with os._exit mid-loop (it sends nothing): the trainer
    sees its process gone, counts one failure and restarts the group from
    the latest checkpoint."""
    result = runs["out"]["exit"]
    assert os.path.exists(runs["tmp"]["exit"] / "marker")
    assert result.metrics["step"] == 5
    assert result.checkpoint.to_dict()["step"] == 6
    assert len(result.spawn_s) == 2
    steps = [r["step"] for r in runs["reports"]["exit"]]
    # Rank 0 may report step 2 before rank 1's death stops it; the restart
    # resumes from the checkpoint of the last step rank 0 reported.
    assert steps[-4:] == [2, 3, 4, 5] and steps[:2] == [0, 1], steps


def test_interrupted_fit_leaves_no_worker(tmp_path):
    """A KeyboardInterrupt in the trainer process mid-run (here from a callback)
    still shuts every worker down."""
    class Interrupt(TrainCallback):
        def on_report(self, iteration, metrics, checkpoint=None):
            if iteration == 2:
                raise KeyboardInterrupt

    trainer = DataParallelTrainer(
        _slow_loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=_run_config(tmp_path, "interrupt",
                               callbacks=[Interrupt()]))
    with pytest.raises(KeyboardInterrupt):
        _fit(trainer)


def test_loop_that_does_not_pickle_raises_before_any_spawn(tmp_path):
    def nested(config):
        pass

    for loop in (nested, lambda config: None):
        trainer = DataParallelTrainer(
            loop, train_loop_config={},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=_run_config(tmp_path, "nested"))
        with pytest.raises(TypeError, match="define the train loop and any "
                                            "function it is given at module "
                                            "level"):
            trainer.fit()
        _no_children()
    # A trainer is a Tune trainable (the loop is pickled only when a
    # trial is sent, so wrapping it raises nothing).
    from ray_tpu_torch import tune

    assert issubclass(trainer.as_trainable(), tune.FunctionTrainable)


def _current_card(config):
    from ray_tpu_torch import train

    train.report({"card": torch.cuda.current_device()})


def test_train_thread_takes_the_workers_card(monkeypatch):
    """A CUDA worker's train loop runs on a thread of its own, and the
    current card is per thread: the thread takes the worker's card before
    the loop runs (else rank 1's collectives would build their buffers on
    card 0)."""
    from ray_tpu_torch.train.session import TrainContext, _shutdown_session
    from ray_tpu_torch.train.worker_group import RayTrainWorker

    cards = {"current": 0}
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda card: cards.update(current=card))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: cards["current"])
    worker = RayTrainWorker(card=1)
    cards["current"] = 0  # a new thread's card
    worker.init_session(TrainContext(world_size=2, world_rank=1))
    worker.start_training(_current_card, {})
    try:
        assert worker.next_result(timeout=30)["metrics"] == {"card": 1}
        assert worker.next_result(timeout=30)["type"] == "done"
    finally:
        worker.finish()
        _shutdown_session()


def test_profile_exit_swallows_stop_profile_errors(tmp_path):
    """C7: as the reference's, ``session.profile``'s exit swallows what
    ``stop_profile`` raises: a body that stopped the trace itself returns
    normally, and a body that raises still raises its own exception."""
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.session import TrainContext, _init_session

    _init_session(TrainContext(world_size=1, world_rank=0))
    try:
        with session.profile(str(tmp_path / "a")):
            session.stop_profile()
        assert os.listdir(tmp_path / "a") == ["trace_rank0.json"]
        with pytest.raises(KeyError, match="the body's own"):
            with session.profile(str(tmp_path / "b")):
                session.stop_profile()
                raise KeyError("the body's own")
    finally:
        session._shutdown_session()


def test_checkpoint_dict_and_directory_round_trip(tmp_path):
    data = {"w": np.arange(6.0).reshape(2, 3), "step": 4, "tag": "x"}
    ckpt = Checkpoint.from_dict(data)
    ckpt.set_metadata({"epoch": 1})
    back = ckpt.to_dict()
    np.testing.assert_array_equal(back["w"], data["w"])
    assert (back["step"], back["tag"]) == (4, "x")
    dest = ckpt.to_directory(str(tmp_path / "copy"))
    copy = Checkpoint.from_directory(dest)
    assert copy.to_dict()["step"] == 4
    assert copy.get_metadata() == {"epoch": 1}
    with copy.as_directory() as d:
        assert d == copy.path and os.path.isdir(d)
    assert ckpt.to_directory(ckpt.path) == ckpt.path
    with pytest.raises(ValueError, match="not a dict checkpoint"):
        Checkpoint(str(tmp_path)).to_dict()
    shutil.rmtree(ckpt.path)


def test_placement_across_hosts_raises():
    """The workers are processes of one host: a strategy that asks to
    spread them is refused, not ignored."""
    for strategy in ("PACK", "STRICT_PACK"):
        ScalingConfig(num_workers=2, placement_strategy=strategy)
    for strategy in ("SPREAD", "STRICT_SPREAD"):
        with pytest.raises(ValueError, match="one host"):
            ScalingConfig(num_workers=2, placement_strategy=strategy)


def test_worker_device_takes_a_card_where_a_gpu_is_asked(monkeypatch):
    """A ``GPU`` resource puts the workers on the cards, one each, once
    the cards are enough; without one they run on the CPU."""
    from ray_tpu_torch.train.worker_group import _worker_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert _worker_device(2, {"CPU": 1, "GPU": 1}) == "cuda"
    assert _worker_device(4, {"CPU": 1}) == "cpu"
    with pytest.raises(ValueError, match="3 workers need 3 cards"):
        _worker_device(3, {"GPU": 1})
    with pytest.raises(ValueError, match="exactly one"):
        _worker_device(1, {"GPU": 2})
