"""The port's ingest: resumable iterators, streaming splits on a
coordinator thread, and ``TorchTrainer`` fed by a shuffled Dataset and by
streaming splits, against the JAX package's ``ray_tpu.data``.

Mirrors ``tests/test_data.py:174`` and
``tests/test_data_fault_tolerance.py:331, :359, :375``. Beyond them: the
split handout (first epoch first come, first served; the next one
round-robin) block for block the JAX package's under the same pull
order; ``IngestCursor`` resumed at several cuts of a shuffled pipeline
equal to the uninterrupted run; a split consumed from a spawned process
(its blocks arrive as files); a coordinator made again with the same
``resume_key`` (the port's failover, a divergence from the JAX package's
restarted actor) delivering every row once, to this process and to a
spawned consumer; the coordinator leaving no thread, socket or file; and
``TorchTrainer`` on 2 gloo workers taking the JAX package's
``split_shard`` rows of the same seeded shuffle, and every row of the
streaming splits once. Spawned processes import this module again, so
it keeps jax, the JAX package and torch out of its top.
"""
import gc
import multiprocessing
import os
import threading

import pytest

import ray_tpu_torch.data as td


@pytest.fixture(scope="module")
def rd(ray_start_regular):
    from ray_tpu import data

    return data


@pytest.fixture
def ckpt_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("RTPU_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    return tmp_path / "ckpt"


def _split_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("rtpu-split")]


def _ids(batches):
    return [i for b in batches for i in b["id"].tolist()]


# ------------------------------------------------------------ the mirrors

def test_streaming_split(rd):
    ds = td.range(40, parallelism=4)
    it0, it1 = ds.streaming_split(2)
    got0 = [b for b in it0.iter_batches(batch_size=None)]
    got1 = [b for b in it1.iter_batches(batch_size=None)]
    total = sum(len(b["id"]) for b in got0) + sum(len(b["id"]) for b in got1)
    assert total == 40
    j0, j1 = rd.range(40, parallelism=4).streaming_split(2)
    assert _ids(got0) == _ids(j0.iter_batches(batch_size=None))
    assert _ids(got1) == _ids(j1.iter_batches(batch_size=None))


@pytest.mark.parametrize("kwargs", [{"equal": True},
                                    {"locality_hints": ["node-0", "node-1"]}])
def test_streaming_split_refuses_equal_and_locality_hints(kwargs):
    """The port hands splits out first come, first served: asking for
    equal splits or locality raises before any coordinator starts."""
    ds = td.range(40, parallelism=4)
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        ds.streaming_split(2, **kwargs)
    assert ds._coordinators == []
    assert not [t for t in threading.enumerate()
                if t.name.startswith("rtpu-split")]


def test_iterator_resume_identical(rd, ckpt_dir):
    ds = td.range(100, parallelism=5)
    ref = [b["id"].tolist()
           for b in td.range(100, parallelism=5).iter_batches(batch_size=8)]
    assert ref == [b["id"].tolist() for b in rd.range(100, parallelism=5)
                   .iter_batches(batch_size=8)]
    it = ds.iterator(resume_key="trainA")
    g = it.iter_batches(batch_size=8)
    got = [next(g)["id"].tolist() for _ in range(5)]
    del g  # abandon mid-epoch
    it2 = ds.iterator(resume_key="trainA")
    rest = [b["id"].tolist() for b in it2.iter_batches(batch_size=8)]
    assert got + rest == ref
    it3 = ds.iterator(resume_key="trainA")
    assert it3.cursor.state["epoch"] == 1  # a full pass rolled the epoch


def test_cursor_rejects_shuffle_buffer(ckpt_dir):
    it = td.range(16, parallelism=2).iterator(resume_key="bad")
    with pytest.raises(ValueError):
        next(iter(it.iter_batches(batch_size=4,
                                  local_shuffle_buffer_size=8)))


def test_streaming_split_coordinator_failover(ckpt_dir):
    """The coordinator dies mid-stream (here: closed, as a driver that
    went away); one made again with the same key replays its journal,
    and the consumers finish with every row once."""
    ds = td.range(120, parallelism=6)
    its = ds.streaming_split(2, resume_key="splitjob")
    seen = []
    streams = [it.iter_batches(batch_size=10) for it in its]
    for g in streams:
        seen.extend(next(g)["id"].tolist())
    ds._coordinators[0].close()
    assert ds._coordinators[0].closed and not _split_threads()
    # The restarted driver calls streaming_split with the same key.
    again = td.range(120, parallelism=6)
    again.streaming_split(2, resume_key="splitjob")
    for g in streams:
        for b in g:
            seen.extend(b["id"].tolist())
    assert sorted(seen) == list(range(120)), (len(seen), len(set(seen)))


# ------------------------------------------------------ beyond the mirrors

def test_split_handout_matches_jax_block_for_block(rd):
    """The same pull order gives each split the JAX package's blocks: the
    first epoch first come, first served, the second round-robin."""
    order = [0, 0, 1, 0, 1, 1, 0]

    def pulls(its):
        streams = [it.iter_batches(batch_size=None) for it in its]
        got = [[], []]
        for s in order:
            got[s].append(next(streams[s])["id"].tolist())
        for s in (0, 1):
            got[s].extend(b["id"].tolist() for b in streams[s])
        again = [[b["id"].tolist() for b in it.iter_batches(batch_size=None)]
                 for it in its]
        return got, again

    pipe = lambda m: m.range(70, parallelism=9).random_shuffle(seed=5)  # noqa: E731
    assert pulls(pipe(td).streaming_split(2)) == \
        pulls(pipe(rd).streaming_split(2))


@pytest.mark.parametrize("cut", [1, 4, 9])
def test_ingest_cursor_resumes_the_uninterrupted_stream(ckpt_dir, cut):
    """A shuffled pipeline of uneven blocks, a batch size that divides no
    block: batches [0, cut) then a new iterator with the same key gives
    the rest of the uninterrupted run's batches."""
    ds = td.range(97, parallelism=6).random_shuffle(seed=11)
    ref = [b["id"].tolist() for b in ds.iter_batches(batch_size=7)]
    g = ds.iterator(resume_key=f"cut{cut}").iter_batches(batch_size=7)
    head = [next(g)["id"].tolist() for _ in range(cut)]
    g.close()
    rest = [b["id"].tolist() for b in ds.iterator(resume_key=f"cut{cut}")
            .iter_batches(batch_size=7)]
    assert head + rest == ref


def _consume_split(it, out, go=None, ready=None, first=1):
    """A consumer process: ``first`` batches, then (with ``go``) wait,
    then the rest of the split; puts the ids and the fetches."""
    stream = it.iter_batches(batch_size=6)
    ids = []
    for _ in range(first):
        ids.extend(next(stream)["id"].tolist())
    if go is not None:
        ready.set()
        go.wait(60)
    for b in stream:
        ids.extend(b["id"].tolist())
    out.put((ids, len(it.fetch_s)))


def test_split_consumed_from_a_spawned_process():
    """The other process gets its blocks as files through the
    coordinator's listener; when both splits end and the consumer has
    gone, no thread, socket or file of the coordinator is left."""
    ds = td.range(90, parallelism=9)
    its = ds.streaming_split(2)
    coord = ds._coordinators[0]
    ctx = multiprocessing.get_context("spawn")
    out, go, ready = ctx.Queue(), ctx.Event(), ctx.Event()
    proc = ctx.Process(target=_consume_split, args=(its[1], out, go, ready))
    proc.start()
    assert ready.wait(60)
    # The spawned consumer holds at least its first block; this process
    # takes its share, then lets it finish.
    mine = _ids(its[0].iter_batches(batch_size=6))
    go.set()
    theirs, fetches = out.get(timeout=60)
    proc.join(30)
    assert sorted(mine + theirs) == list(range(90))
    assert theirs and fetches >= 2  # its blocks and the end came remotely
    deadline = 50
    while coord.listening() and deadline:
        threading.Event().wait(0.1)
        deadline -= 1
    assert not coord.listening()
    assert not _split_threads()
    assert not os.path.exists(coord._listener.dir)
    assert not os.path.exists(coord.address)
    assert multiprocessing.active_children() == []


def test_recreated_coordinator_serves_a_spawned_consumer(ckpt_dir):
    """A consumer in another process keeps its iterator across the
    coordinator's end and its re-creation with the same key (the
    iterator finds it again at the key's address): every row once."""
    ds = td.range(96, parallelism=8).random_shuffle(seed=2)
    its = ds.streaming_split(2, resume_key="remote")
    ctx = multiprocessing.get_context("spawn")
    out, go, ready = ctx.Queue(), ctx.Event(), ctx.Event()
    proc = ctx.Process(target=_consume_split,
                       args=(its[1], out, go, ready, 2))
    proc.start()
    assert ready.wait(60)
    stream = its[0].iter_batches(batch_size=6)
    mine = _ids([next(stream)])
    ds._coordinators[0].close()
    again = td.range(96, parallelism=8).random_shuffle(seed=2)
    again.streaming_split(2, resume_key="remote")
    go.set()
    mine += _ids(stream)
    theirs, _ = out.get(timeout=60)
    proc.join(30)
    assert sorted(mine + theirs) == list(range(96)), (len(mine), len(theirs))
    again._coordinators[0].close()
    assert not _split_threads()


def test_coordinator_goes_with_its_dataset_and_iterators():
    ds = td.range(20, parallelism=4)
    its = ds.streaming_split(3)
    coord = ds._coordinators[0]
    path, folder = coord.address, coord._listener.dir
    assert _split_threads() and os.path.exists(path)
    del coord
    del ds
    gc.collect()
    assert _split_threads()  # the iterators still hold it
    del its
    gc.collect()
    assert not _split_threads()
    assert not os.path.exists(path) and not os.path.exists(folder)


def test_split_iterators_pickle_and_coordinator_does_not_travel():
    import pickle

    ds = td.range(10, parallelism=2)
    it = ds.streaming_split(1)[0]
    copy = pickle.loads(pickle.dumps(it))
    assert copy._owner is None and copy._address == it._address
    # In this process the copy calls the live coordinator directly.
    assert sorted(_ids(copy.iter_batches(batch_size=None))) == list(range(10))
    # A pickled Dataset carries its plan, not its coordinators.
    assert pickle.loads(pickle.dumps(ds))._coordinators == []


def test_first_come_handout_under_contention():
    """Many consumer threads (more than cores) pulling their splits at
    once, the switch interval shortened: every row is handed out once,
    and each split's second epoch replays its round-robin share."""
    import sys

    n = 2 * (os.cpu_count() or 4) + 1
    ds = td.range(600, parallelism=60).random_shuffle(seed=1)
    its = ds.streaming_split(n)
    got = [None] * n

    def consume(i):
        got[i] = _ids(its[i].iter_batches(batch_size=7))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(i for ids in got for i in ids) == list(range(600))
    coord = ds._coordinators[0]
    for i in range(n):
        want = [x for b in coord._epoch_blocks[i::n] for x in b["id"]]
        assert _ids(its[i].iter_batches(batch_size=None)) == want


# --------------------------------------------------------------- TorchTrainer

def ingest_loop(config):
    """Each rank: ``steps`` batches of its ``get_dataset_shard("train")``,
    then its streaming split to the end; rank 0 reports every rank's ids."""
    import torch.distributed as dist

    from ray_tpu_torch import train

    ctx = train.get_context()
    rank = ctx.get_world_rank()
    shard = train.get_dataset_shard("train")
    split = train.get_dataset_shard("splits")[rank]
    arm1 = []
    it = shard.iter_torch_batches(batch_size=config["batch"])
    for _ in range(config["steps"]):
        arm1.extend(next(it)["id"].tolist())
    arm2 = _ids(split.iter_batches(batch_size=config["batch"]))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {"arm1": arm1, "arm2": arm2,
                                   "fetches": len(split.fetch_s)})
    train.report({"ranks": ranks})


def test_torch_trainer_with_a_shuffled_dataset_and_streaming_splits(
        rd, tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    world, batch, steps = 2, 4, 3
    shuffled = td.range(64, parallelism=8).random_shuffle(seed=9)
    splits = shuffled.streaming_split(world)
    result = TorchTrainer(
        ingest_loop, train_loop_config={"batch": batch, "steps": steps},
        scaling_config=ScalingConfig(num_workers=world),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": shuffled, "splits": splits}, device="cpu").fit()
    ranks = result.metrics["ranks"]
    jax_shuffled = rd.range(64, parallelism=8).random_shuffle(seed=9) \
        .materialize()
    for r, got in enumerate(ranks):
        want = _ids(shuffled.materialize().split_shard(r, world)
                    .iter_batches(batch_size=None))
        assert got["arm1"] == want[:batch * steps]
        assert want == _ids(jax_shuffled.split_shard(r, world)
                            .iter_batches(batch_size=None))
        assert got["fetches"] >= 1
    assert sorted(i for got in ranks for i in got["arm2"]) == list(range(64))
    assert multiprocessing.active_children() == []
    coord = shuffled._coordinators[0]
    deadline = 50
    while coord.listening() and deadline:
        threading.Event().wait(0.1)
        deadline -= 1
    assert not coord.listening() and not _split_threads()
