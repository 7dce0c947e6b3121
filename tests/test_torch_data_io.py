"""The port's file formats, writes and ``from_*`` constructors against the
JAX package's ``ray_tpu.data`` on the same files.

Mirrors ``tests/test_data.py:129, :137, :144, :341, :412, :421, :455,
:466, :496, :520, :545, :566``. Beyond them: every format with a writer
(Parquet, CSV, JSON, TFRecord, WebDataset, SQL) written by the port and
read by the JAX package, and the reverse, row for row; the formats
without one (text, binary, images) read by both from the same files; the
writes' files byte for byte the JAX package's where both write the same
bytes; a format without its package raising an ImportError that names
it; and the TFRecord reader's numpy blocks (a divergence: the JAX package
returns a ``pyarrow.Table``). The JAX side runs on its cluster
(``ray_start_regular``).
"""
import functools
import io
import os
import sqlite3
import sys
import tarfile

import numpy as np
import pytest

import ray_tpu_torch.data as td


@pytest.fixture(scope="module")
def rd(ray_start_regular):
    from ray_tpu import data

    return data


def _value(v):
    """A row value as a comparable Python object."""
    if isinstance(v, np.ndarray):
        return [_value(x) for x in v] if v.dtype == object else v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_value(x) for x in v]
    return v


def _same_rows(got, want, key=None):
    """The same rows (in order, or sorted by ``key``), column for column,
    values compared as Python objects (floats exactly)."""
    if key is not None:
        got = sorted(got, key=lambda r: _value(r[key]))
        want = sorted(want, key=lambda r: _value(r[key]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), (sorted(g), sorted(w))
        for k in w:
            assert _value(g[k]) == _value(w[k]), (k, g[k], w[k])


ROWS = [{"a": i, "b": float(i) * 0.5, "s": f"row {i}"} for i in range(12)]


# ------------------------------------------------------------ the mirrors

def test_parquet_roundtrip(rd, tmp_path):
    ds = td.from_items([{"a": i, "b": float(i) * 0.5} for i in range(20)],
                       parallelism=2)
    ds.write_parquet(str(tmp_path / "out"))
    back = td.read_parquet(str(tmp_path / "out"))
    assert back.count() == 20
    assert sorted(r["a"] for r in back.take_all()) == list(range(20))
    _same_rows(back.take_all(),
               rd.read_parquet(str(tmp_path / "out")).take_all())


def test_csv_roundtrip(rd, tmp_path):
    ds = td.from_items([{"a": i} for i in range(10)], parallelism=1)
    ds.write_csv(str(tmp_path / "csv"))
    back = td.read_csv(str(tmp_path / "csv"))
    assert back.count() == 10
    _same_rows(back.take_all(), rd.read_csv(str(tmp_path / "csv")).take_all())


def test_from_pandas_to_pandas(rd):
    import pandas as pd

    df = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"]})
    ds = td.from_pandas(df)
    out = ds.to_pandas()
    assert list(out["x"]) == [1, 2, 3]
    assert list(out["y"]) == ["a", "b", "c"]
    pd.testing.assert_frame_equal(out, rd.from_pandas(df).to_pandas())


def test_from_huggingface(rd):
    import datasets as hf

    src = hf.Dataset.from_dict(
        {"text": [f"row {i}" for i in range(40)], "label": list(range(40))})
    ds = td.from_huggingface(src)
    rows = ds.take_all()
    assert len(rows) == 40
    assert rows[7]["text"] == "row 7" and rows[7]["label"] == 7
    assert ds.num_blocks() > 1  # actually sliced into parallel blocks
    assert ds.num_blocks() == rd.from_huggingface(src).num_blocks()
    _same_rows(rows, rd.from_huggingface(src).take_all())
    with pytest.raises(ValueError, match="split"):
        td.from_huggingface(hf.DatasetDict({"train": src}))


def test_read_text(rd, tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("alpha\n\nbeta\ngamma\n")
    rows = td.read_text(str(p)).take_all()
    assert [r["text"] for r in rows] == ["alpha", "beta", "gamma"]
    _same_rows(rows, rd.read_text(str(p)).take_all())


def test_read_tfrecords_roundtrip(rd, tmp_path):
    from ray_tpu_torch.data.tfrecord_lite import write_tfrecord_examples

    p = tmp_path / "shard.tfrecord"
    write_tfrecord_examples(str(p), {
        "name": [b"ada", b"grace"],
        "age": [36, 85],
        "scores": [[1.5, 2.5], [3.5, 4.5]],
    })
    rows = td.read_tfrecords(str(p)).take_all()
    assert len(rows) == 2
    assert rows[0]["name"] == b"ada" and rows[1]["age"] == 85
    assert [round(float(x), 1) for x in rows[1]["scores"]] == [3.5, 4.5]
    _same_rows(rows, rd.read_tfrecords(str(p)).take_all())


def test_write_read_tfrecords_roundtrip(rd, tmp_path):
    out = tmp_path / "shards"
    td.from_items([{"a": i, "b": float(i) / 2} for i in range(8)]) \
        .write_tfrecords(str(out))
    rows = td.read_tfrecords(str(out)).take_all()
    assert len(rows) == 8
    assert sorted(int(r["a"]) for r in rows) == list(range(8))
    _same_rows(rows, rd.read_tfrecords(str(out)).take_all())


def _movie_db(tmp_path, name="t.db"):
    db = str(tmp_path / name)
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE movie(title TEXT, year INT, score REAL)")
    conn.commit()
    conn.close()
    return functools.partial(sqlite3.connect, db)


def test_read_write_sql_roundtrip(rd, tmp_path):
    factory = _movie_db(tmp_path)
    td.from_items(
        [{"title": f"m{i}", "year": 2000 + i, "score": i / 2}
         for i in range(6)]
    ).write_sql("INSERT INTO movie VALUES(?, ?, ?)", factory)
    ds = td.read_sql("SELECT title, year, score FROM movie", factory)
    rows = ds.take_all()
    assert len(rows) == 6
    assert sorted(int(r["year"]) for r in rows) == list(range(2000, 2006))
    _same_rows(rows, rd.read_sql("SELECT title, year, score FROM movie",
                                 factory).take_all())
    sharded = td.read_sql(
        "SELECT title, year FROM movie", factory,
        shard_predicates=["year % 2 = 0", "year % 2 = 1"])
    assert sorted(int(r["year"]) for r in sharded.take_all()) \
        == list(range(2000, 2006))


def test_webdataset_roundtrip(rd, tmp_path):
    out = tmp_path / "wds"
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    rows = [
        {"__key__": f"sample{i:03d}", "txt": f"caption {i}", "cls": i,
         "meta": {"idx": i}, "npy": arr * i, "raw": bytes([i, i + 1])}
        for i in range(4)
    ]
    td.from_items(rows).write_webdataset(str(out))
    back = td.read_webdataset(str(out)).take_all()
    assert len(back) == 4
    back.sort(key=lambda r: r["__key__"])
    for i, r in enumerate(back):
        assert r["__key__"] == f"sample{i:03d}"
        assert r["txt"] == f"caption {i}"
        assert int(r["cls"]) == i
        assert r["meta"] == {"idx": i}
        assert np.allclose(r["npy"], arr * i)
        assert bytes(r["raw"]) == bytes([i, i + 1])
    _same_rows(back, rd.read_webdataset(str(out)).take_all(), "__key__")


def _png_shard(path, n=2):
    from PIL import Image

    with tarfile.open(path, "w") as tf:
        for i in range(n):
            im = Image.new("RGB", (4, 3), color=(i * 40, 0, 0))
            buf = io.BytesIO()
            im.save(buf, format="PNG")
            data = buf.getvalue()
            info = tarfile.TarInfo(f"img{i}.png")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_webdataset_decode_images(rd, tmp_path):
    shard = tmp_path / "imgs.tar"
    _png_shard(shard)
    rows = td.read_webdataset(str(shard), decode_images=True).take_all()
    assert len(rows) == 2
    rows.sort(key=lambda r: r["__key__"])
    assert rows[0]["png"].shape == (3, 4, 3)
    assert rows[1]["png"][0, 0, 0] == 40
    _same_rows(rows, rd.read_webdataset(str(shard), decode_images=True)
               .take_all(), "__key__")


def test_webdataset_ragged_and_scalar_types(rd, tmp_path):
    out = tmp_path / "wds2"
    rows = [
        {"__key__": "a", "txt": "hello", "flag": np.bool_(True),
         "score": np.float32(1.5), "entropy": np.arange(2, dtype=np.float64)},
        {"__key__": "b", "txt": "world"},  # missing fields: ragged sample
    ]
    td.from_items(rows).write_webdataset(str(out))
    back = td.read_webdataset(str(out)).take_all()
    back.sort(key=lambda r: r["__key__"])
    assert back[0]["txt"] == "hello" and back[1]["txt"] == "world"
    # 'entropy' must not be mistaken for an .npy suffix: an array back
    assert np.allclose(back[0]["entropy"], [0.0, 1.0])
    assert int(back[0]["flag"]) == 1
    assert abs(float(back[0]["score"]) - 1.5) < 1e-6
    assert back[1].get("flag") is None or back[1]["flag"] is None
    _same_rows(back, rd.read_webdataset(str(out)).take_all(), "__key__")


def test_read_sql_blob_exact(rd, tmp_path):
    db = str(tmp_path / "b.db")
    c = sqlite3.connect(db)
    c.execute("CREATE TABLE t(id INT, payload BLOB)")
    blobs = [b"\x01\x00", b"\x00\x00\x07", b"xyz"]
    c.executemany("INSERT INTO t VALUES(?,?)", list(enumerate(blobs)))
    c.commit()
    c.close()
    rows = td.read_sql("SELECT id, payload FROM t",
                       functools.partial(sqlite3.connect, db)).take_all()
    rows.sort(key=lambda r: int(r["id"]))
    assert [bytes(r["payload"]) for r in rows] == blobs


# --------------------------------------------------- both directions

def _write(m, fmt, rows, path, factory=None):
    ds = m.from_items(rows, parallelism=3)
    if fmt == "sql":
        ds.write_sql("INSERT INTO movie VALUES(?, ?, ?)", factory)
    else:
        getattr(ds, f"write_{fmt}")(path)


def _read(m, fmt, path, factory=None):
    if fmt == "sql":
        return m.read_sql("SELECT title, year, score FROM movie", factory)
    return getattr(m, f"read_{fmt}")(path)


FORMAT_ROWS = {
    "parquet": ROWS, "csv": ROWS, "json": ROWS, "tfrecords": ROWS,
    "webdataset": [{"__key__": f"k{i:02d}", "txt": r["s"], "cls": r["a"]}
                   for i, r in enumerate(ROWS)],
    "sql": [{"title": r["s"], "year": 2000 + r["a"], "score": r["b"]}
            for r in ROWS],
}
SORT_KEY = {"webdataset": "__key__", "sql": "year"}


@pytest.mark.parametrize("fmt", sorted(FORMAT_ROWS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_every_format_both_directions(rd, tmp_path, fmt, writer):
    """Written by one package, read by both: the same rows."""
    rows = FORMAT_ROWS[fmt]
    factory = _movie_db(tmp_path) if fmt == "sql" else None
    path = str(tmp_path / fmt)
    _write(td if writer == "port" else rd, fmt, rows, path, factory)
    key = SORT_KEY.get(fmt, "a")
    got = _read(td, fmt, path, factory).take_all()
    _same_rows(got, _read(rd, fmt, path, factory).take_all(), key)
    # (The JAX package's TFRecord writer stores ints as floats, equal as
    # values.)
    assert sorted(_value(r[key]) for r in got) == \
        sorted(_value(r[key]) for r in rows)


@pytest.mark.parametrize("fmt,ext", [("parquet", "parquet"), ("csv", "csv"),
                                     ("json", "json"),
                                     ("webdataset", "tar")])
def test_written_files_are_the_jax_packages(rd, tmp_path, fmt, ext):
    blocks = [{"a": np.arange(5) + 5 * i, "b": np.arange(5) * 0.25 + i}
              for i in range(3)]
    getattr(td.from_blocks(blocks), f"write_{fmt}")(str(tmp_path / "p"))
    getattr(rd.from_blocks(blocks), f"write_{fmt}")(str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == \
        [f"part-{i:05d}.{ext}" for i in range(3)]
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


def test_text_binary_and_images_read_as_jax(rd, tmp_path):
    from PIL import Image

    for i in range(3):
        (tmp_path / f"t{i}.txt").write_text(f"line {i}\n\nmore {i}\n")
        (tmp_path / f"b{i}.bin").write_bytes(bytes([i, 0, 255, i]))
        Image.new("RGB", (5 + i, 4), color=(10 * i, 20, 30)).save(
            tmp_path / f"i{i}.png")
    txt = [str(tmp_path / f"t{i}.txt") for i in range(3)]
    binf = [str(tmp_path / f"b{i}.bin") for i in range(3)]
    _same_rows(td.read_text(txt).take_all(), rd.read_text(txt).take_all())
    _same_rows(td.read_binary_files(binf).take_all(),
               rd.read_binary_files(binf).take_all())
    for kw in ({}, {"size": (3, 3)}, {"size": (2, 4), "mode": "L"}):
        got = td.read_images(str(tmp_path), **kw).take_all()
        _same_rows(got, rd.read_images(str(tmp_path), **kw).take_all())
        assert len(got) == 3
    blocks = td.read_text(txt)._blocks()
    assert all(b["text"].dtype == object for b in blocks)


def test_tfrecord_blocks_are_numpy(rd, tmp_path):
    """A divergence: the port's TFRecord blocks are numpy dicts — a
    feature with one length in every row stacked with its dtype (int64,
    f32), a ragged one an object array of lists, bytes an object array —
    where the JAX package returns a pyarrow.Table. The rows are the
    same."""
    import pyarrow as pa

    from ray_tpu.data.datasource import TFRecordDatasource as JaxTF

    from ray_tpu_torch.data.datasource import TFRecordDatasource
    from ray_tpu_torch.data.tfrecord_lite import write_tfrecord_examples

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 50257, (6, 16))
    p = str(tmp_path / "x.tfrecord")
    write_tfrecord_examples(p, {
        "id": list(range(6)), "tokens": tokens.tolist(),
        "ragged": [[1, 2], [3, 4, 5], [6, 7], [8, 9, 10, 11], [1, 2],
                   [3, 4, 5]],
        "w": [0.5 * i for i in range(6)], "name": [b"x%d" % i for i in range(6)]})
    block = TFRecordDatasource(p).read_file(p)
    assert isinstance(block, dict)
    assert block["id"].dtype == np.int64 and block["id"].shape == (6,)
    assert block["tokens"].dtype == np.int64
    np.testing.assert_array_equal(block["tokens"], tokens)
    assert block["w"].dtype == np.float32
    assert block["ragged"].dtype == object and block["name"].dtype == object
    assert isinstance(JaxTF(p).read_file(p), pa.Table)
    _same_rows(td.read_tfrecords(p).take_all(),
               rd.read_tfrecords(p).take_all())


def test_tensor_column_tfrecord_write_read_by_jax(rd, tmp_path):
    """The port writes a 2-D int64 column (a token matrix) as int64 list
    features, which the JAX package reads; the JAX package's own writer
    cannot write such a column (it takes a row's array for a float)."""
    tokens = np.arange(40, dtype=np.int64).reshape(8, 5)
    blocks = [{"id": np.arange(4) + 4 * i, "tokens": tokens[4 * i:4 * i + 4]}
              for i in range(2)]
    td.from_blocks(blocks).write_tfrecords(str(tmp_path / "p"))
    back = td.read_tfrecords(str(tmp_path / "p")).take_all()
    _same_rows(back, rd.read_tfrecords(str(tmp_path / "p")).take_all())
    np.testing.assert_array_equal(np.stack([r["tokens"] for r in back]),
                                  tokens)
    with pytest.raises(Exception, match="length-1 arrays"):
        rd.from_blocks(blocks).write_tfrecords(str(tmp_path / "j"))


@pytest.mark.parametrize("call,module,package", [
    (lambda f, d: td.read_parquet(f).take_all(), "pyarrow.parquet",
     "pyarrow"),
    (lambda f, d: td.read_csv(f).take_all(), "pyarrow.csv", "pyarrow"),
    (lambda f, d: td.read_json(f).take_all(), "pyarrow.json", "pyarrow"),
    (lambda f, d: td.range(3).write_parquet(d), "pyarrow.parquet",
     "pyarrow"),
    (lambda f, d: td.range(3).write_csv(d), "pyarrow.csv", "pyarrow"),
    (lambda f, d: td.range(3).write_json(d), "pandas", "pandas"),
    (lambda f, d: td.read_images(f).take_all(), "PIL.Image", "PIL"),
    (lambda f, d: td.range(3).to_pandas(), "pandas", "pandas"),
    (lambda f, d: td.from_pandas(None), "pandas", "pandas"),
    (lambda f, d: td.from_arrow(None), "pyarrow", "pyarrow"),
    (lambda f, d: td.from_huggingface(None), "datasets", "datasets"),
])
def test_a_format_without_its_package_names_it(tmp_path, monkeypatch, call,
                                                module, package):
    f = tmp_path / "f.png"
    f.write_bytes(b"")
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=package):
        call(str(f), str(tmp_path / "out"))


def test_tfrecord_text_binary_sql_and_webdataset_need_no_arrow(
        tmp_path, monkeypatch):
    """What runs on the card's machine (no pyarrow, no pandas)."""
    for name in ("pyarrow", "pandas", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)
    td.from_items(ROWS).write_tfrecords(str(tmp_path / "tf"))
    assert td.read_tfrecords(str(tmp_path / "tf")).count() == len(ROWS)
    td.from_items(FORMAT_ROWS["webdataset"]).write_webdataset(
        str(tmp_path / "w"))
    assert td.read_webdataset(str(tmp_path / "w")).count() == len(ROWS)
    (tmp_path / "t.txt").write_text("a\nb\n")
    assert td.read_text(str(tmp_path / "t.txt")).count() == 2
    assert td.read_binary_files(str(tmp_path / "t.txt")).count() == 1
    factory = _movie_db(tmp_path)
    td.from_items(FORMAT_ROWS["sql"]).write_sql(
        "INSERT INTO movie VALUES(?, ?, ?)", factory)
    assert td.read_sql("SELECT * FROM movie", factory).count() == len(ROWS)


def test_to_numpy_refs_and_back(rd):
    ds = td.range(10, parallelism=3)
    blocks = ds.to_numpy_refs()
    assert all(isinstance(b, dict) for b in blocks)
    _same_rows(td.from_numpy_refs(blocks).take_all(),
               rd.from_numpy_refs(rd.range(10, parallelism=3)
                                  .to_numpy_refs()).take_all())
