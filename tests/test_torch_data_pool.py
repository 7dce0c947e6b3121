"""The port's data pool (``map_batches`` with a class UDF, and
``BatchPredictor`` over it) on spawned CPU worker processes, against the
JAX package's actor pool on the same seeded data.

Mirrors ``tests/test_data.py::test_map_batches_actor_pool``,
``tests/test_predictor.py::test_batch_predictor_over_dataset`` (rtol 1e-3
as there), a tiny ViT through ``BatchPredictor`` against the JAX
``vit.forward`` on the same params (atol/rtol 1e-4, as
``tests/test_torch_vit.py`` holds f32 logits), three cases of
``tests/test_data_fault_tolerance.py`` (a SIGKILLed worker healed, the
same rows out; fail-fast with ``RTPU_DATA_FT=0``; completion order with
no head-of-line blocking), ``TorchTrainer(datasets=...)`` on 2 gloo ranks
against the JAX package's ``split_shard``, and the refusal of a nested
class before any spawn. Pools have at most 2 workers. A worker imports
this module again to unpickle its UDF class, so the module imports
neither jax nor the JAX package nor torch at the top.
"""
import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch.data as td
from ray_tpu_torch.data import executor as tx

VIT_ATOL = VIT_RTOL = 1e-4


def _no_children():
    assert multiprocessing.active_children() == []


# --------------------------------------------------- UDFs (pool workers)

class AddConst:
    def __init__(self, c):
        self.c = c

    def __call__(self, batch):
        return {"y": batch["id"] + self.c}


class MarkingUDF:
    """Appends each batch's min id to a side-effect file, then
    transforms (the JAX package's test's UDF)."""

    def __init__(self, path, mult=2, delay=0.3):
        self.path = path
        self.mult = mult
        self.delay = delay

    def __call__(self, batch):
        with open(self.path, "a") as f:
            f.write(f"{int(batch['id'].min())}\n")
            f.flush()
        time.sleep(self.delay)
        batch["value"] = batch["id"] * self.mult
        return batch


class FirstSlow:
    def __call__(self, batch):
        if int(batch["id"].min()) == 0:
            time.sleep(1.5)
        batch["value"] = batch["id"] + 1
        return batch


class DiesOnBlock40:
    """Kills its worker process on the block that holds id 40, every
    time it is sent."""

    def __call__(self, batch):
        if 40 in batch["id"]:
            os._exit(3)
        return batch


def _mlp(params, x):
    import torch

    return torch.relu(x @ params["w1"]) @ params["w2"]


def _vit_tiny_f32(params, x):
    import torch

    from ray_tpu_torch.models import vit

    return vit.forward(params, x, vit.vit_tiny(dtype=torch.float32))


def _shard_loop(config):
    """Rank 0 reports every rank's blocks of its dataset shard."""
    import torch.distributed as dist

    from ray_tpu_torch import train

    shard = train.get_dataset_shard("train")
    blocks = [b["id"].tolist() for b in shard.iter_batches(batch_size=None)]
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, blocks)
    train.report({"blocks": ranks})


# ----------------------------------------------------------------- cases

@pytest.fixture(scope="module", autouse=True)
def _worker_tmpdir(tmp_path_factory):
    """The checkpoints the cases make land in the test's directory."""
    old = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = str(tmp_path_factory.mktemp("pool_tmp"))
    yield
    if old is None:
        del os.environ["TMPDIR"]
    else:
        os.environ["TMPDIR"] = old


def test_map_batches_actor_pool(ray_start_regular):
    from ray_tpu import data as rd

    ds = td.range(40, parallelism=4).map_batches(
        AddConst, fn_constructor_args=(5,), concurrency=2)
    out = ds.take_all()
    _no_children()
    assert sorted(r["y"] for r in out) == [i + 5 for i in range(40)]
    want = rd.range(40, parallelism=4).map_batches(
        AddConst, fn_constructor_args=(5,), concurrency=2).take_all()
    # Both preserve order: the same rows in the same order.
    assert [int(r["y"]) for r in out] == [int(r["y"]) for r in want]
    assert [r["y"].dtype for r in out] == [r["y"].dtype for r in want]
    pool = ds.stats().to_dict()["operators"][-1]
    assert pool["operator"] == "ActorPool[AddConst]"
    workers = pool["actor_pool"]["workers"]
    assert len(workers) == 2 and sum(w["blocks"] for w in workers) == 4
    assert all(w["card"] is None and w["init_s"] >= 0 for w in workers)


def _ckpt():
    from ray_tpu_torch.train import Checkpoint

    rng = np.random.default_rng(0)
    return Checkpoint.from_dict({"params": {
        "w1": rng.standard_normal((8, 16)).astype(np.float32),
        "w2": rng.standard_normal((16, 2)).astype(np.float32),
    }})


def test_batch_predictor_over_dataset(ray_start_regular):
    from ray_tpu import data as rd
    from ray_tpu import train as jtrain
    from ray_tpu_torch.train import BatchPredictor, TorchPredictor

    x = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    ckpt = _ckpt()
    bp = BatchPredictor(ckpt, TorchPredictor, apply_fn=_mlp,
                        input_column="data", device="cpu")
    rows = bp.predict(td.from_numpy(x), batch_size=16, max_scoring_workers=2,
                      num_gpus_per_actor=0).take_all()
    _no_children()
    assert len(rows) == 64
    preds = np.stack([r["predictions"] for r in rows])
    params = ckpt.to_dict()["params"]
    expect = np.maximum(x @ params["w1"], 0) @ params["w2"]
    np.testing.assert_allclose(preds, expect, rtol=1e-3, atol=1e-4)

    def japply(p, v):
        import jax.numpy as jnp

        return jnp.maximum(v @ p["w1"], 0.0) @ p["w2"]

    jrows = jtrain.BatchPredictor(
        jtrain.Checkpoint.from_dict(ckpt.to_dict()), jtrain.JaxPredictor,
        apply_fn=japply, input_column="data").predict(
            rd.from_numpy(x), batch_size=16, max_scoring_workers=2).take_all()
    np.testing.assert_allclose(
        preds, np.stack([r["predictions"] for r in jrows]), rtol=1e-3,
        atol=1e-4)


def test_batch_predictor_vit_matches_the_jax_forward():
    """A tiny ViT (f32) scored by one pool worker through BatchPredictor,
    against the JAX package's forward on the same params and images."""
    import jax
    import torch

    from ray_tpu.models import vit as jvit
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, TorchPredictor

    jcfg = jvit.vit_tiny(dtype=jax.numpy.float32)
    cfg = vit.vit_tiny(dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(0),
                                                     jcfg))
    imgs = np.random.default_rng(3).standard_normal(
        (12, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ckpt = Checkpoint.from_dict({"params": convert.vit_params_from_numpy(
        tree, cfg, "cpu")})
    rows = BatchPredictor(ckpt, TorchPredictor, apply_fn=_vit_tiny_f32,
                          input_column="image", device="cpu").predict(
        td.from_numpy(imgs, column="image").repartition(3), batch_size=4,
        num_gpus_per_actor=0).take_all()
    _no_children()
    got = np.stack([r["predictions"] for r in rows])
    want = np.asarray(jvit.forward(tree, imgs, jcfg))
    assert got.shape == (12, cfg.num_classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=VIT_ATOL, rtol=VIT_RTOL)


def _pool_pids():
    return [p.pid for p in multiprocessing.active_children()
            if p.name.startswith("rtpu-data-worker")]


def _kill_a_worker_after(mark, lines, killed):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            seen = open(mark).read().split()
        except FileNotFoundError:
            seen = []
        pids = _pool_pids()
        if len(seen) >= lines and pids:
            os.kill(pids[0], signal.SIGKILL)
            killed["pid"] = pids[0]
            return
        time.sleep(0.05)


def test_pool_worker_sigkill_identical_output(tmp_path):
    """SIGKILL a pool worker mid-map: the same rows out, in order, the
    resubmissions counted, side-effect replays bounded by them."""
    tx.reset_ft_counters()
    mark = str(tmp_path / "markers.txt")
    killed = {}
    ds = td.range(160, parallelism=8).map_batches(
        MarkingUDF, fn_constructor_args=(mark,), concurrency=2)
    t = threading.Thread(target=_kill_a_worker_after, args=(mark, 2, killed))
    t.start()
    out = ds.take_all()
    t.join()
    _no_children()
    assert killed.get("pid"), "the killer thread never found a pool worker"
    assert [int(r["id"]) for r in out] == list(range(160))
    assert [int(r["value"]) for r in out] == [2 * i for i in range(160)]
    counters = tx.ft_counters()
    assert counters["retries"] >= 1, counters
    attempts = [int(x) for x in open(mark).read().split()]
    dups = len(attempts) - len(set(attempts))
    assert dups <= counters["retries"], (dups, counters)
    assert set(attempts) == {20 * i for i in range(8)}
    pool = ds.stats().to_dict()["operators"][-1]
    assert pool["retries"] == counters["retries"]
    assert [w["incarnation"] for w in pool["actor_pool"]["workers"]].count(
        1) == 1


def test_ft_disabled_fail_fast(tmp_path, monkeypatch):
    """RTPU_DATA_FT=0: a SIGKILLed pool worker fails the stage with a typed
    error naming the worker and its exit code, and no worker is left."""
    monkeypatch.setenv("RTPU_DATA_FT", "0")
    tx.reset_ft_counters()
    mark = str(tmp_path / "markers.txt")
    killed = {}
    ds = td.range(160, parallelism=8).map_batches(
        MarkingUDF, fn_constructor_args=(mark,), concurrency=2)
    t = threading.Thread(target=_kill_a_worker_after, args=(mark, 2, killed))
    t.start()
    with pytest.raises(tx.PoolWorkerDiedError,
                       match=r"data pool worker \d \(pid \d+\) died \(exit "
                             r"code -9\)") as err:
        ds.take_all()
    t.join()
    _no_children()
    assert err.value.pid == killed["pid"]
    assert tx.ft_counters()["retries"] == 0


@pytest.mark.parametrize("budget", [0, 1])
def test_ft_retry_budget_spent_raises(budget, monkeypatch):
    """A block that kills every worker it is sent to is resent
    RTPU_DATA_FT_RETRIES times, each to a fresh worker on the same slot;
    then the stage raises a typed error saying so, and no worker is
    left."""
    monkeypatch.setenv("RTPU_DATA_FT_RETRIES", str(budget))
    tx.reset_ft_counters()
    ds = td.range(80, parallelism=4).map_batches(DiesOnBlock40,
                                                 concurrency=1)
    with pytest.raises(tx.PoolWorkerDiedError,
                       match=rf"data pool worker 0 \(pid \d+\) died \(exit "
                             rf"code 3\); a block already resent {budget} "
                             r"times \(RTPU_DATA_FT_RETRIES\)") as err:
        ds.take_all()
    _no_children()
    assert err.value.exitcode == 3
    assert tx.ft_counters()["retries"] >= budget


def test_completion_order_no_head_of_line_blocking():
    """With preserve_order off, a slow first block does not hold back the
    blocks other workers finish. The blocks go to the least-loaded worker
    (ties to the first): 0 and 40 to worker 0, 20 and 60 to worker 1. A
    worker runs its UDF on one thread, so 40 waits behind 0 on worker 0
    (the reference's actors run two calls at once, and its test expects 0
    last); 20 and 60 leave first, and with preserve_order on they would
    wait for 0."""
    ctx = td.DataContext.get_current()
    old = ctx.preserve_order
    ctx.preserve_order = False
    try:
        order, rows = [], 0
        ds = td.range(80, parallelism=4).map_batches(FirstSlow,
                                                     concurrency=2)
        for b in ds.iter_batches(batch_size=20):
            order.append(int(b["id"].min()))
            rows += len(b["id"])
        assert rows == 80
        assert sorted(order) == [0, 20, 40, 60]
        assert order[:3] == [20, 60, 0], order
    finally:
        ctx.preserve_order = old
    _no_children()


def test_torch_trainer_shards_match_the_jax_split_shard(tmp_path,
                                                        ray_start_regular):
    """datasets= with a Dataset: each of 2 gloo ranks gets, through
    get_dataset_shard, the blocks the JAX package's split_shard gives
    that rank for the same pipeline."""
    from ray_tpu import data as rd
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def pipeline(m):
        return m.range(50, parallelism=5).map_batches(
            lambda b: {"id": b["id"] * 3})

    result = TorchTrainer(
        _shard_loop, train_loop_config={}, device="cpu",
        scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": pipeline(td)},
        run_config=RunConfig(name="shards",
                             storage_path=str(tmp_path))).fit()
    _no_children()
    ref = pipeline(rd)
    for rank in range(2):
        want = [b["id"].tolist() for b in ref.split_shard(rank, 2)
                .iter_batches(batch_size=None)]
        assert result.metrics["blocks"][rank] == want


def test_nested_class_or_lambda_raises_before_any_spawn(monkeypatch):
    def no_spawn(*args, **kwargs):
        raise AssertionError("a pool worker was spawned")

    monkeypatch.setattr(tx, "_Slot", no_spawn)

    class Nested:
        def __call__(self, batch):
            return batch

    ds = td.range(8, parallelism=2)
    with pytest.raises(TypeError, match="define the class at module level"):
        ds.map_batches(Nested, concurrency=1)
    with pytest.raises(TypeError, match="pass no lambda"):
        ds.map_batches(AddConst, fn_constructor_args=(lambda: 1,),
                       concurrency=1)
    # A function runs on this process's threads: lambdas work there.
    assert [int(r["x"]) for r in ds.map_batches(
        lambda b: {"x": b["id"] + 1}).take_all()] == list(range(1, 9))
    # A module-level class reaches the spawn.
    with pytest.raises(AssertionError, match="a pool worker was spawned"):
        ds.map_batches(AddConst, fn_constructor_args=(1,),
                       concurrency=1).take_all()
    _no_children()
