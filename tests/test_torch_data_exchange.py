"""The port's all-to-all exchanges (``random_shuffle``, ``sort``, ``zip``,
``groupby``, ``randomize_block_order``) and the data layer's metrics
plane, against the JAX package's ``ray_tpu.data`` on the same seeded
pipelines.

Mirrors ``tests/test_data.py:66, :73, :86, :96, :105``. Beyond them, each
exchange is compared with the JAX package's block for block on several
seeds and partition counts: shuffle, sort (both directions), zip and
randomize_block_order bit for bit (values and dtypes); groupby's integer
results and ``count``/``min``/``max`` exactly and its float
``sum``/``mean``/``std`` within 1e-12 relative (pandas sums with Kahan
compensation, the port's numpy pairwise; an f32 column within 1e-6,
relative or absolute, a few f32 ulps of its values: pandas accumulates
it in f32, the port in f64 rounded once),
with pandas present and with pandas blocked. The JAX side runs on its cluster (``ray_start_regular``).
"""
import sys

import numpy as np
import pytest

import ray_tpu_torch.data as td
from ray_tpu_torch.data import executor as tx
from ray_tpu_torch.data import logical as TL

FLOAT_RTOL = 1e-12
F32_TOL = 1e-6


@pytest.fixture(scope="module")
def rd(ray_start_regular):
    from ray_tpu import data

    return data


def _jax_blocks(ds):
    import ray_tpu
    from ray_tpu.data.block import BlockAccessor

    return [BlockAccessor(ray_tpu.get(r)).to_numpy()
            for r in ds.to_block_refs()]


def _port_blocks(ds):
    return [{k: np.asarray(v) for k, v in b.items()} for b in ds._blocks()]


def _same_blocks(got, want, float_rtol=0.0):
    """Block for block: the same columns, dtypes and values (f64 within
    ``float_rtol`` relative where it is not 0, f32 then within F32_TOL
    relative or absolute; NaN where NaN)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w), (list(g), list(w))
        for k in w:
            assert g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
            if float_rtol and w[k].dtype == np.float32:
                np.testing.assert_allclose(g[k], w[k], rtol=F32_TOL,
                                           atol=F32_TOL)
            elif float_rtol and w[k].dtype.kind == "f":
                np.testing.assert_allclose(g[k], w[k], rtol=float_rtol,
                                           atol=0)
            else:
                np.testing.assert_array_equal(g[k], w[k])


# ------------------------------------------------------------ the mirrors

def test_random_shuffle_preserves_multiset(rd):
    ds = td.range(50, parallelism=4).random_shuffle(seed=7)
    vals = [r["id"] for r in ds.take_all()]
    assert sorted(vals) == list(range(50))
    assert vals != list(range(50))  # actually shuffled
    assert vals == [r["id"] for r in rd.range(50, parallelism=4)
                    .random_shuffle(seed=7).take_all()]


def test_sort(rd):
    items = [{"k": v} for v in [5, 3, 8, 1, 9, 2]]
    ds = td.from_items(items, parallelism=2)
    out = [r["k"] for r in ds.sort("k").take_all()]
    assert out == [1, 2, 3, 5, 8, 9]
    out_desc = [r["k"] for r in ds.sort("k", descending=True).take_all()]
    assert out_desc == [9, 8, 5, 3, 2, 1]
    ref = rd.from_items(items, parallelism=2)
    _same_blocks(_port_blocks(ds.sort("k", descending=True)),
                 _jax_blocks(ref.sort("k", descending=True)))


def test_union_zip(rd):
    a = td.range(10, parallelism=2)
    b = td.range(10, parallelism=2).map_batches(
        lambda x: {"other": x["id"] + 100})
    assert a.union(a).count() == 20
    z = a.zip(b).take_all()
    assert len(z) == 10
    for r in z:
        assert r["other"] == r["id"] + 100
    ja = rd.range(10, parallelism=2)
    jb = rd.range(10, parallelism=2).map_batches(
        lambda x: {"other": x["id"] + 100})
    _same_blocks(_port_blocks(a.zip(b)), _jax_blocks(ja.zip(jb)))


def test_groupby_agg(rd):
    items = [{"g": i % 3, "v": float(i)} for i in range(12)]
    ds = td.from_items(items, parallelism=3)
    out = ds.groupby("g").sum("v").take_all()
    got = {int(r["g"]): r["sum(v)"] for r in out}
    assert got == {0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10, 2: 2 + 5 + 8 + 11}
    cnt = ds.groupby("g").count().take_all()
    assert all(r["count()"] == 4 for r in cnt)
    ref = rd.from_items(items, parallelism=3)
    _same_blocks(_port_blocks(ds.groupby("g").sum("v")),
                 _jax_blocks(ref.groupby("g").sum("v")), FLOAT_RTOL)
    _same_blocks(_port_blocks(ds.groupby("g").count()),
                 _jax_blocks(ref.groupby("g").count()))


def test_global_aggregate(rd):
    ds = td.range(10, parallelism=2)
    out = ds.groupby(None).aggregate(("sum", "id"), ("mean", "id")).take_all()
    assert out[0]["sum(id)"] == 45
    assert out[0]["mean(id)"] == 4.5
    ref = rd.range(10, parallelism=2).groupby(None).aggregate(
        ("sum", "id"), ("mean", "id"))
    _same_blocks(_port_blocks(ds.groupby(None).aggregate(
        ("sum", "id"), ("mean", "id"))), _jax_blocks(ref))


# ------------------------------------------------- block for block with JAX

@pytest.mark.parametrize("seed,parallelism,partitions", [
    (0, 4, None), (7, 3, None), (123, 5, 3), (2024, 4, 6)])
def test_random_shuffle_matches_jax_block_for_block(rd, seed, parallelism,
                                                    partitions):
    from ray_tpu.data.context import DataContext as JCtx

    from ray_tpu_torch.data.context import DataContext as TCtx

    def pipe(m):
        return m.range_tensor(37, shape=(3,), parallelism=parallelism) \
            .map_batches(lambda b: {"id": b["data"][:, 0],
                                    "x": b["data"].astype(np.float32) / 3})

    tctx, jctx = TCtx.get_current(), JCtx.get_current()
    old = tctx.shuffle_partitions, jctx.shuffle_partitions
    tctx.shuffle_partitions = jctx.shuffle_partitions = partitions
    try:
        got = _port_blocks(pipe(td).random_shuffle(seed=seed))
        want = _jax_blocks(pipe(rd).random_shuffle(seed=seed))
    finally:
        tctx.shuffle_partitions, jctx.shuffle_partitions = old
    assert len(got) == (partitions or parallelism)
    _same_blocks(got, want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("seed,parallelism", [(0, 1), (1, 3), (5, 4),
                                              (11, 6)])
def test_sort_matches_jax_block_for_block(rd, seed, parallelism,
                                          descending):
    rng = np.random.default_rng(seed)
    # Ties and a float key column beside an int one.
    items = [{"k": int(k), "f": float(f), "row": i} for i, (k, f) in
             enumerate(zip(rng.integers(0, 25, 90), rng.standard_normal(90)))]
    for key in ("k", "f"):
        got = _port_blocks(td.from_items(items, parallelism=parallelism)
                           .sort(key, descending=descending))
        want = _jax_blocks(rd.from_items(items, parallelism=parallelism)
                           .sort(key, descending=descending))
        _same_blocks(got, want)
        flat = np.concatenate([b[key] for b in got if b])
        assert np.all(np.diff(flat) <= 0 if descending else
                      np.diff(flat) >= 0)


@pytest.mark.parametrize("left,right", [(2, 3), (4, 1), (3, 5)])
def test_zip_matches_jax_block_for_block(rd, left, right):
    def pipe(m):
        a = m.range(23, parallelism=left).map_batches(
            lambda b: {"id": b["id"], "v": b["id"] * 0.5})
        b = m.range(23, parallelism=right).map_batches(
            lambda b: {"id": b["id"] + 1000, "w": b["id"].astype(np.int32)})
        return a.zip(b)

    got = _port_blocks(pipe(td))
    _same_blocks(got, _jax_blocks(pipe(rd)))
    assert list(got[0]) == ["id", "v", "id_1", "w"]


def test_zip_unequal_counts_raise_the_jax_error(rd):
    with pytest.raises(ValueError) as jax_err:
        rd.range(5).zip(rd.range(6)).take_all()
    with pytest.raises(ValueError) as port_err:
        td.range(5).zip(td.range(6)).take_all()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_randomize_block_order_matches_jax(rd, seed):
    got = _port_blocks(td.range(40, parallelism=6)
                       .randomize_block_order(seed=seed))
    want = _jax_blocks(rd.range(40, parallelism=6)
                       .randomize_block_order(seed=seed))
    _same_blocks(got, want)


def _group_rows(seed, n=80):
    """Rows with int, float (NaN in places), f32 and string columns; the
    float key has NaNs too."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        v = float(rng.standard_normal() * 10)
        rows.append({
            "g": int(rng.integers(0, 7)),
            "s": "abcde"[int(rng.integers(0, 5))],
            "fk": float("nan") if i % 11 == 0 else float(rng.integers(0, 4)),
            "i": int(rng.integers(-50, 50)),
            "v": float("nan") if i % 7 == 3 else v,
            "f32": np.float32(v / 3),
        })
    return rows


AGGS = [
    ("count", ""), ("sum", "i"), ("sum", "v"), ("sum", "f32"),
    ("mean", "i"), ("mean", "v"), ("mean", "f32"), ("min", "i"),
    ("min", "v"), ("max", "i"), ("max", "f32"), ("std", "i"), ("std", "v"),
]


def _agg_blocks(m, rows, parallelism, key):
    ds = m.from_items(rows, parallelism=parallelism).groupby(key)
    return ds.aggregate(*AGGS) if key is not None else ds.aggregate(
        *[a for a in AGGS if a[0] != "count"])


@pytest.mark.parametrize("key", ["g", "s", "fk", None])
@pytest.mark.parametrize("seed,parallelism", [(0, 2), (4, 5), (9, 11)])
def test_groupby_matches_jax(rd, seed, parallelism, key):
    rows = _group_rows(seed)
    got = _port_blocks(_agg_blocks(td, rows, parallelism, key))
    want = _jax_blocks(_agg_blocks(rd, rows, parallelism, key))
    _same_blocks(got, want, FLOAT_RTOL)
    if key == "fk":  # NaN keys dropped, as pandas' dropna=True
        assert not any(np.isnan(b["fk"]).any() for b in got if b)


def test_groupby_without_pandas_gives_the_same_answers(rd, monkeypatch):
    rows = _group_rows(5)
    want = _port_blocks(_agg_blocks(td, rows, 4, "g"))
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    got = _port_blocks(_agg_blocks(td, rows, 4, "g"))
    _same_blocks(got, want)
    glob = _port_blocks(_agg_blocks(td, rows, 4, None))
    monkeypatch.undo()
    _same_blocks(glob, _jax_blocks(_agg_blocks(rd, rows, 4, None)),
                 FLOAT_RTOL)


def test_groupby_empty_partition_is_an_empty_block(rd):
    # Two keys over eight partitions: most partitions hold no row.
    rows = [{"g": i % 2, "v": i} for i in range(16)]
    got = _port_blocks(td.from_items(rows, parallelism=8).groupby("g")
                       .sum("v"))
    want = _jax_blocks(rd.from_items(rows, parallelism=8).groupby("g")
                       .sum("v"))
    assert len(got) == 8 and sum(1 for b in got if not b) >= 6
    _same_blocks(got, want)


def test_map_groups_matches_jax(rd):
    rows = [{"g": i % 4, "v": float(i)} for i in range(20)]

    def center(batch):
        return {"g": batch["g"], "v": batch["v"] - batch["v"].mean()}

    got = _port_blocks(td.from_items(rows, parallelism=3).groupby("g")
                       .map_groups(center))
    want = _jax_blocks(rd.from_items(rows, parallelism=3).groupby("g")
                       .map_groups(center))
    _same_blocks(got, want)


# --------------------------------------------------- the executor's plane

def test_stats_name_each_exchange_as_jax(rd):
    items = [{"k": i % 5, "v": i} for i in range(30)]
    # (A shuffle right before a sort is dropped by the optimizer.)
    ds = (td.from_items(items, parallelism=3).random_shuffle(seed=1)
          .zip(td.range(30, parallelism=2)).sort("k")
          .groupby("k").count())
    assert ds.count() == 5
    ops = [o["operator"] for o in ds.stats().operators]
    for label in ("RandomShuffle", "Sort", "Zip", "Aggregate"):
        assert label in ops
        assert f"{label}: " in ds.stats()
    ref = (rd.from_items(items, parallelism=3).random_shuffle(seed=1)
           .zip(rd.range(30, parallelism=2)).sort("k")
           .groupby("k").count())
    ref_ops = [o["operator"] for o in ref.stats().operators]
    assert [o for o in ops if o in ("RandomShuffle", "Sort", "Zip",
                                    "Aggregate")] == \
        [o for o in ref_ops if o in ("RandomShuffle", "Sort", "Zip",
                                     "Aggregate")]


def test_every_logical_op_executes():
    """No op of ``data/logical.py`` raises NotImplementedError any more."""
    blocks = [{"id": np.arange(6), "k": np.arange(6) % 2},
              {"id": np.arange(6, 9), "k": np.arange(6, 9) % 2}]
    ops = [TL.MapBatches(fn=lambda b: b), TL.MapRows(fn=lambda r: r),
           TL.FlatMap(fn=lambda r: [r]), TL.Filter(fn=lambda r: True),
           TL.Repartition(2), TL.RandomShuffle(seed=0), TL.Sort(key="id"),
           TL.Limit(8), TL.Union([[TL.InputData(refs=blocks)]]),
           TL.Zip([TL.InputData(refs=blocks)]),
           TL.Aggregate("k", [("count", "", "count()")])]
    kinds = {type(o) for o in ops} | {TL.InputData, TL.Read}
    defined = {c for c in vars(TL).values() if isinstance(c, type)
               and issubclass(c, TL.LogicalOp) and c is not TL.LogicalOp}
    assert defined == kinds
    for op in ops:
        out = td.Dataset([TL.InputData(refs=blocks), op]).take_all()
        assert out, type(op).__name__


def test_exchange_shards_are_the_drivers_arrays_with_no_lineage(monkeypatch):
    """A divergence by design: the JAX package records each exchange
    shard's producing call to re-derive it after a node loss
    (``_derivable``/``_register``/``ft_get``); the port's shards are numpy
    blocks of this process, so there is nothing to re-derive, and the
    exchanges give the same blocks with RTPU_DATA_FT on or off."""
    for name in ("ft_get", "_derivable", "_register", "_rederive"):
        assert not hasattr(tx, name)
        assert not hasattr(tx.StreamingExecutor, name)
    ds = td.range(30, parallelism=3).random_shuffle(seed=4).sort("id")
    monkeypatch.setenv("RTPU_DATA_FT", "1")
    on = ds._blocks()
    monkeypatch.setenv("RTPU_DATA_FT", "0")
    off = ds._blocks()
    assert all(isinstance(b, dict) for b in on)
    _same_blocks(_port_blocks(td.from_blocks(on)),
                 _port_blocks(td.from_blocks(off)))


def test_metric_families_match_jax_names_tags_and_counts(monkeypatch):
    """The rtpu_data_* families on a process-local sink: the JAX
    package's names, descriptions and tags, each stage's blocks and
    rows, and the iterator's rows."""
    from ray_tpu.data import executor as jx

    from ray_tpu_torch.core import sink as psink
    from ray_tpu_torch.util import metrics

    # What earlier tests of this process recorded goes to a sink of its
    # own first.
    monkeypatch.setattr(psink, "_local_sink", psink.MetricsSink())
    metrics.flush_metrics()
    sink = psink.MetricsSink()
    monkeypatch.setattr(psink, "_local_sink", sink)
    ds = td.range(40, parallelism=4).map_batches(lambda b: b) \
        .random_shuffle(seed=0)
    rows = sum(len(b["id"]) for b in ds.iter_batches(batch_size=16))
    assert rows == 40
    assert metrics.flush_metrics()
    fams = sink.families()
    names = {"rtpu_data_operator_blocks_total", "rtpu_data_operator_rows_total",
             "rtpu_data_operator_bytes_total",
             "rtpu_data_operator_seconds_total"}
    assert names <= set(fams)
    jax_inst = {i.name: i for i in (jx._op_blocks_total, jx._op_rows_total,
                                    jx._op_bytes_total, jx._op_seconds_total,
                                    jx._retries_total, jx._inflight_gauge)}
    for inst in (tx._op_blocks_total, tx._op_rows_total, tx._op_bytes_total,
                 tx._op_seconds_total, tx._retries_total, tx._inflight_gauge):
        ref = jax_inst[inst.name]
        assert inst.tag_keys == ref.tag_keys
        assert inst.description == ref.description
        assert inst.mtype == type(ref).__name__.lower()

    def value(name, **tags):
        return fams[name]["data"].get(tuple(sorted(tags.items())))

    assert value("rtpu_data_operator_blocks_total", operator="read") == 4
    assert value("rtpu_data_operator_blocks_total",
                 operator="MapBatches") == 4
    assert value("rtpu_data_operator_blocks_total",
                 operator="RandomShuffle") == 4
    assert value("rtpu_data_operator_rows_total", operator="MapBatches",
                 dir="in") == 40
    assert value("rtpu_data_operator_rows_total", operator="MapBatches",
                 dir="out") == 40
    assert value("rtpu_data_operator_bytes_total", operator="MapBatches",
                 dir="out") == 40 * 8
    assert value("rtpu_data_operator_rows_total", operator="iter",
                 dir="out") == 40
    for op in ("read", "MapBatches", "RandomShuffle", "iter"):
        assert value("rtpu_data_operator_seconds_total", operator=op,
                     phase="wall") > 0


def test_progress_narration_and_operator_records(monkeypatch, capsys):
    """RTPU_DATA_PROGRESS narrates each stage and the iterator on stderr
    in the JAX package's words, and nothing with it off; an executor run
    three times keeps one aggregate an operator with three records."""
    monkeypatch.setenv("RTPU_DATA_PROGRESS", "1")
    monkeypatch.setenv("RTPU_DATA_PROGRESS_S", "1e-9")
    ds = td.range(40, parallelism=4).map_batches(lambda b: b)
    assert sum(len(b["id"]) for b in ds.iter_batches(batch_size=8)) == 40
    err = capsys.readouterr().err
    assert "[data] read: " in err and " blocks out, " in err
    assert "[data] MapBatches: " in err
    assert "[data] iter: " in err and " rows/s)" in err
    ex = tx.StreamingExecutor()
    for _ in range(3):
        list(ex.execute(ds._ops))
    assert sorted(ex.op_stats) == ["MapBatches", "read"]
    assert ex.op_stats["MapBatches"]["records"] == 3
    assert ex.op_stats["MapBatches"]["rows_out"] == 3 * 40
    capsys.readouterr()
    monkeypatch.setenv("RTPU_DATA_PROGRESS", "0")
    list(td.range(8).iter_batches(batch_size=4))
    assert "[data]" not in capsys.readouterr().err
