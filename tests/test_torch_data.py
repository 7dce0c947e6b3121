"""The port's data layer (``ray_tpu_torch.data``) in process, against the
JAX package's ``ray_tpu.data`` on the same seeded pipelines.

Each case mirrors one of ``tests/test_data.py`` (or of
``tests/test_vit_inference.py`` for the preprocessors) and runs the same
pipeline through both packages, the JAX package's on its cluster
(``ray_start_regular``). Integer and f32 numpy columns must agree
exactly, block for block where the case reads blocks, and the reference
test's own assertions hold on the port. Functions UDFs run in task stages
(threads of this process in the port), so lambdas stay lambdas.
"""
import numpy as np
import pytest

import ray_tpu_torch.data as td
from ray_tpu_torch.data import logical as TL
from ray_tpu_torch.data import preprocessors as TP


@pytest.fixture(scope="module")
def rd(ray_start_regular):
    from ray_tpu import data

    return data


def _same_rows(got, want):
    """Row lists equal: the same keys, and each value equal with its
    dtype."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            gv, wv = np.asarray(g[k]), np.asarray(w[k])
            assert gv.dtype == wv.dtype, (k, gv.dtype, wv.dtype)
            np.testing.assert_array_equal(gv, wv)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def test_range_count_take(rd):
    ds, ref = td.range(100, parallelism=4), rd.range(100, parallelism=4)
    assert ds.count() == ref.count() == 100
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    _same_rows(rows, ref.take(5))


def test_map_batches_tasks(rd):
    ds = td.range(64, parallelism=4).map_batches(lambda b: {"x": b["id"] * 2})
    ref = rd.range(64, parallelism=4).map_batches(lambda b: {"x": b["id"] * 2})
    out = ds.take_all()
    assert sorted(r["x"] for r in out) == [2 * i for i in range(64)]
    _same_rows(out, ref.take_all())


def test_fused_map_chain(rd):
    def chain(m):
        return (m.range(32, parallelism=2)
                .map(lambda r: {"v": int(r["id"]) + 1})
                .filter(lambda r: r["v"] % 2 == 0)
                .map_batches(lambda b: {"v": b["v"] * 10}))

    out = chain(td).take_all()
    assert sorted(r["v"] for r in out) == [v * 10 for v in range(2, 33, 2)]
    _same_rows(out, chain(rd).take_all())


def test_flat_map(rd):
    def fm(m):
        return m.range(4, parallelism=1).flat_map(
            lambda r: [{"id": int(r["id"])}, {"id": int(r["id"]) + 100}])

    assert fm(td).count() == 8
    _same_rows(fm(td).take_all(), fm(rd).take_all())


def test_repartition_and_num_blocks(rd):
    ds = td.range(30, parallelism=3).repartition(5)
    assert ds.num_blocks() == 5
    assert ds.count() == 30
    ref = rd.range(30, parallelism=3).repartition(5)
    _same_batches(list(ds.iter_batches(batch_size=None)),
                  list(ref.iter_batches(batch_size=None)))


def test_limit_streams_only_needed(rd):
    seen = []

    def note(b):
        seen.append(int(b["id"][0]))
        return b

    ds = td.range(1000, parallelism=10).map_batches(note).limit(25)
    assert ds.count() == 25
    # Reads and maps ran on the blocks the limit needed and on those
    # in flight beside them (max_tasks_in_flight), not on all ten.
    assert len(seen) <= 2 + td.DataContext.get_current().max_tasks_in_flight
    _same_rows(td.range(1000, parallelism=10).limit(25).take_all(),
               rd.range(1000, parallelism=10).limit(25).take_all())


def test_union(rd):
    a, ra = td.range(10, parallelism=2), rd.range(10, parallelism=2)
    b = td.range(10, parallelism=2).map_batches(
        lambda x: {"id": x["id"] + 100})
    rb = rd.range(10, parallelism=2).map_batches(
        lambda x: {"id": x["id"] + 100})
    assert a.union(a).count() == 20
    _same_rows(a.union(b).take_all(), ra.union(rb).take_all())


def test_iter_batches_sizes(rd):
    ds = td.range(100, parallelism=4)
    batches = list(ds.iter_batches(batch_size=32))
    sizes = [len(b["id"]) for b in batches]
    assert sum(sizes) == 100
    assert all(s == 32 for s in sizes[:-1])
    _same_batches(batches, list(rd.range(100, parallelism=4).iter_batches(
        batch_size=32)))
    _same_batches(list(ds.iter_batches(batch_size=32, drop_last=True)),
                  list(rd.range(100, parallelism=4).iter_batches(
                      batch_size=32, drop_last=True)))


def test_local_shuffle_buffer(rd):
    def vals(m, buf):
        out = []
        for b in m.range(64, parallelism=2).iter_batches(
                batch_size=16, local_shuffle_buffer_size=buf,
                local_shuffle_seed=3):
            out.extend(b["id"].tolist())
        return out

    got = vals(td, 64)
    assert sorted(got) == list(range(64))
    assert got != list(range(64))
    # The same seed permutes the same buffers the same way, also with a
    # buffer smaller than the data.
    assert got == vals(rd, 64)
    assert vals(td, 20) == vals(rd, 20)


def test_tensor_data(rd):
    batch = td.range_tensor(16, shape=(2, 2), parallelism=2).take_batch(4)
    assert batch["data"].shape == (4, 2, 2)
    _same_batches([batch], [rd.range_tensor(16, shape=(2, 2),
                                            parallelism=2).take_batch(4)])


def test_materialize_and_schema(rd):
    ds = td.range(10, parallelism=2).materialize()
    assert ds.count() == 10  # re-countable without re-executing reads
    assert ds.num_blocks() == 2
    assert "id" in str(ds.schema()) or "id" in ds.columns()
    ref = rd.range(10, parallelism=2).materialize()
    assert str(ds.schema()) == str(ref.schema())
    assert ds.columns() == ref.columns()


def test_split_shard(rd):
    ds, ref = td.range(40, parallelism=4), rd.range(40, parallelism=4)
    shards = [ds.split_shard(r, 2) for r in range(2)]
    ids = sorted([r["id"] for r in shards[0].take_all()]
                 + [r["id"] for r in shards[1].take_all()])
    assert ids == list(range(40))
    for r, shard in enumerate(shards):
        _same_batches(list(shard.iter_batches(batch_size=None)),
                      list(ref.split_shard(r, 2).iter_batches(
                          batch_size=None)))
    # split deals the same blocks round-robin.
    for part, shard in zip(ds.split(2), shards):
        _same_batches(list(part.iter_batches(batch_size=None)),
                      list(shard.iter_batches(batch_size=None)))


def test_add_drop_select_columns(rd):
    ds = td.range(8, parallelism=1).add_column("sq", lambda b: b["id"] ** 2)
    ref = rd.range(8, parallelism=1).add_column("sq", lambda b: b["id"] ** 2)
    assert ds.take(1)[0]["sq"] == 0
    assert ds.select_columns(["sq"]).columns() == ["sq"]
    assert ds.drop_columns(["sq"]).columns() == ["id"]
    _same_rows(ds.take_all(), ref.take_all())
    _same_rows(ds.rename_columns({"sq": "square"}).take_all(),
               ref.rename_columns({"sq": "square"}).take_all())


def test_from_numpy_items_and_read_numpy(rd, tmp_path):
    """The other constructors the port has, on the same data."""
    x = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    _same_rows(td.from_numpy(x).take_all(), rd.from_numpy(x).take_all())
    items = [{"a": i, "b": float(i) * 0.5} for i in range(20)]
    _same_rows(td.from_items(items, parallelism=3).take_all(),
               rd.from_items(items, parallelism=3).take_all())
    for i in range(3):
        np.save(tmp_path / f"part{i}.npy", x[i * 20:(i + 1) * 20])
    _same_batches(
        list(td.read_numpy(str(tmp_path), parallelism=2).iter_batches(
            batch_size=None)),
        list(rd.read_numpy(str(tmp_path), parallelism=2).iter_batches(
            batch_size=None)))


def test_optimizer_rewrite_rules():
    """Rule-based plan rewrites (reference: logical/optimizers.py):
    limits merge and push below one-to-one maps; dead redistributions
    drop before sort/shuffle."""
    import ray_tpu.data.logical as JL

    def inc(r):
        return r

    for L in (TL, JL):
        plan = [L.InputData(refs=[]), L.MapRows(fn=inc), L.Limit(n=10),
                L.Limit(n=4)]
        out = L.optimize(plan)
        kinds = [type(o).__name__ for o in out]
        assert kinds == ["InputData", "Limit", "MapRows"], kinds
        assert [o.n for o in out if isinstance(o, L.Limit)] == [4]

        plan = [L.InputData(refs=[]), L.Repartition(num_blocks=8),
                L.Sort(key="x")]
        assert [type(o).__name__ for o in L.optimize(plan)] == [
            "InputData", "Sort"]

        plan = [L.InputData(refs=[]), L.RandomShuffle(),
                L.Repartition(num_blocks=4)]
        assert [type(o).__name__ for o in L.optimize(plan)] == [
            "InputData", "RandomShuffle", "Repartition"]
        plan = [L.InputData(refs=[]), L.Repartition(num_blocks=8),
                L.Repartition(num_blocks=2)]
        out = L.optimize(plan)
        assert [type(o).__name__ for o in out] == ["InputData",
                                                   "Repartition"]
        assert out[-1].num_blocks == 2

        # The fusion rule: task maps fuse; a class UDF stands alone.
        class Cls:
            pass

        plan = [L.InputData(refs=[]), L.MapRows(fn=inc),
                L.MapBatches(fn=inc), L.MapBatches(fn=Cls),
                L.Filter(fn=inc)]
        assert [[type(o).__name__ for o in st]
                for st in L.fuse_plan(plan)] == [
            ["InputData"], ["MapRows", "MapBatches"], ["MapBatches"],
            ["Filter"]]


def test_image_normalizer_and_chain(rd):
    """ImageNormalizer and Chain on seeded uint8 images: f32 out, centred
    on the channel means, equal to the JAX package's bit for bit."""
    from ray_tpu.data import preprocessors as JP

    imgs = np.random.default_rng(5).integers(0, 256, (12, 32, 32, 3),
                                             dtype=np.uint8)

    def run(m, P):
        pre = P.Chain(P.ImageNormalizer(),
                      P.BatchMapper(lambda b: {**b, "image":
                                               b["image"].astype(np.float32)}))
        ds = m.from_numpy(imgs, column="image").repartition(3)
        return pre.transform(ds).take_all()

    out = run(td, TP)
    img = out[0]["image"]
    assert img.dtype == np.float32
    assert img.min() < 0 < img.max()
    _same_rows(out, run(rd, JP))
    batch = {"image": imgs[:4]}
    np.testing.assert_array_equal(
        TP.ImageNormalizer().transform_batch(batch)["image"],
        JP.ImageNormalizer().transform_batch(batch)["image"])


def test_standard_scaler_and_label_encoder(rd):
    from ray_tpu.data import preprocessors as JP

    items = [{"x": float(i), "label": f"c{i % 3}"} for i in range(30)]
    ds, ref = td.from_items(items), rd.from_items(items)
    sc = TP.StandardScaler(["x"]).fit(ds)
    mean, std = sc.stats["x"]
    assert abs(mean - 14.5) < 1e-6
    assert sc.stats == JP.StandardScaler(["x"]).fit(ref).stats
    out = sc.transform(ds).take_all()
    vals = np.array([r["x"] for r in out])
    assert abs(vals.mean()) < 1e-6 and abs(vals.std() - 1.0) < 1e-2
    _same_rows(out, JP.StandardScaler(["x"]).fit(ref).transform(ref)
               .take_all())
    le = TP.LabelEncoder("label").fit(ds)
    enc = le.transform(ds).take_all()
    assert {r["label"] for r in enc} == {0, 1, 2}
    _same_rows(enc, JP.LabelEncoder("label").fit(ref).transform(ref)
               .take_all())


def test_stats_report_the_last_run():
    """stats() reports the Dataset's last run without running it again,
    and runs it where it has not run."""
    calls = []

    def note(b):
        calls.append(1)
        return b

    ds = td.range(40, parallelism=4).map_batches(note)
    assert ds.count() == 40
    assert len(calls) == 4
    report = ds.stats().to_dict()
    assert len(calls) == 4
    ops = {o["operator"]: o for o in report["operators"]}
    assert ops["MapBatches"]["rows_out"] == 40
    assert ops["MapBatches"]["blocks"] == 4
    assert "MapBatches: " in td.range(8, parallelism=1).map_batches(
        note).stats()
    assert len(calls) == 5


def test_unported_operators_raise():
    ds = td.Dataset([TL.InputData(refs=[{"id": np.arange(4)}]),
                     TL.Sort(key="id")])
    with pytest.raises(NotImplementedError, match="not ported"):
        ds.take_all()
