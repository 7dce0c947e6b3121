"""Datasources: read tasks producing blocks, and the block writers.

The port's copy of the JAX package's ``data/datasource.py`` (reference:
python/ray/data/datasource/ + read_api.py): ``range``, ``from_items``,
and the file formats — Parquet, CSV, JSON, NumPy, Text, Binary,
TFRecord, images, SQL and WebDataset — with ``write_block`` for the
writes. A Datasource yields ReadTask thunks; the executor runs each on
its thread pool in the calling process, and each returns one block, or
yields one block a file. A datasource pickles by value (paths and
options; no lambda), so a pipeline can travel to a worker process.

Parquet, CSV and JSON read as the JAX package reads them, into
``pyarrow.Table`` blocks; the JSON writer goes through pandas, images
through PIL. Those packages are imported where a file is read or
written, and a format whose package is missing raises an ``ImportError``
naming it. Text, Binary, TFRecord, SQL and WebDataset (without image
decoding) need nothing beyond numpy and return numpy blocks. Where the
JAX package returns a ``pyarrow.Table`` for Text, Binary and TFRecord,
the port's blocks are numpy dicts: strings and bytes as object arrays
(what arrow's ``to_numpy`` gives); a TFRecord feature whose rows all have
one length stacked as an int64 or f32 array (2-D for lists), a ragged one
as an object array of lists.
"""
from __future__ import annotations

import glob as globlib
import importlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .block import Block, BlockAccessor, rows_to_block


def need(module: str, what: str) -> Any:
    """Import ``module`` for ``what``; without its package, an
    ImportError that names the package."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        package = module.split(".")[0]
        if package == "PIL":
            package = "PIL (pillow)"
        raise ImportError(f"{what} needs {package}, which is not "
                          "installed") from e


def _objects(values: List[Any]) -> np.ndarray:
    """An object array holding ``values`` as they are (np.asarray would
    turn equal-length lists into a 2-D array, and bytes into a
    fixed-width "S" column that strips trailing NULs)."""
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


@dataclass
class ReadTask:
    """A zero-arg callable returning one block, plus size metadata."""

    fn: Callable[[], Block]
    num_rows: Optional[int] = None

    def __call__(self) -> Block:
        return self.fn()


class Datasource:
    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError


class RangeDatasource(Datasource):
    def __init__(self, n: int, tensor_shape: Optional[tuple] = None):
        self.n = n
        self.tensor_shape = tensor_shape

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self.n or 1))
        splits = np.array_split(np.arange(self.n, dtype=np.int64), parallelism)
        shape = self.tensor_shape

        def make(ids: np.ndarray) -> ReadTask:
            def read() -> Block:
                if shape is None:
                    return {"id": ids}
                data = np.broadcast_to(
                    ids.reshape((-1,) + (1,) * len(shape)), (len(ids),) + shape
                ).copy()
                return {"data": data}

            return ReadTask(read, num_rows=len(ids))

        return [make(s) for s in splits if len(s) or parallelism == 1]


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, len(self.items) or 1))
        chunks = np.array_split(np.arange(len(self.items)), parallelism)

        def make(idx: np.ndarray) -> ReadTask:
            part = [self.items[i] for i in idx]

            def read() -> Block:
                rows = [x if isinstance(x, dict) else {"item": x} for x in part]
                return rows_to_block(rows)

            return ReadTask(read, num_rows=len(part))

        return [make(c) for c in chunks if len(c) or parallelism == 1]


def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            pat = os.path.join(p, "**", f"*{suffix}" if suffix else "*")
            out.extend(sorted(f for f in globlib.glob(pat, recursive=True)
                              if os.path.isfile(f)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


class FileDatasource(Datasource):
    """One read task per file group."""

    suffix: Optional[str] = None

    def __init__(self, paths, **kwargs):
        self.paths = _expand_paths(paths, self.suffix)
        self.kwargs = kwargs

    def read_file(self, path: str) -> Block:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        groups = np.array_split(np.arange(len(self.paths)), max(1, min(parallelism, len(self.paths))))
        tasks = []
        for g in groups:
            if not len(g):
                continue
            files = [self.paths[i] for i in g]

            def read(files=files):
                # Generator: one block per file, so the streaming read task
                # reports each block as it is parsed and downstream stages
                # start before the whole group is read (reference: streaming
                # generator read tasks, data/_internal/planner/plan_read_op.py).
                for f in files:
                    yield self.read_file(f)

            tasks.append(ReadTask(read))
        return tasks


class ParquetDatasource(FileDatasource):
    suffix = ".parquet"

    def read_file(self, path: str) -> Block:
        pq = need("pyarrow.parquet", "read_parquet")
        return pq.read_table(path, **self.kwargs)


class CSVDatasource(FileDatasource):
    suffix = ".csv"

    def read_file(self, path: str) -> Block:
        pacsv = need("pyarrow.csv", "read_csv")
        return pacsv.read_csv(path, **self.kwargs)


class JSONDatasource(FileDatasource):
    suffix = ".json"

    def read_file(self, path: str) -> Block:
        pajson = need("pyarrow.json", "read_json")
        return pajson.read_json(path, **self.kwargs)


class NumpyDatasource(FileDatasource):
    suffix = ".npy"

    def read_file(self, path: str) -> Block:
        return {"data": np.load(path, **self.kwargs)}


class BinaryDatasource(FileDatasource):
    def read_file(self, path: str) -> Block:
        with open(path, "rb") as f:
            data = f.read()
        return {"bytes": _objects([data]), "path": _objects([path])}


class TextDatasource(FileDatasource):
    """One row per line (reference read_api.py read_text): {"text": line},
    trailing newlines stripped, encoding errors replaced."""

    def __init__(self, paths, encoding: str = "utf-8",
                 drop_empty_lines: bool = True, **kwargs):
        super().__init__(paths, **kwargs)
        self.encoding = encoding
        self.drop_empty_lines = drop_empty_lines

    def read_file(self, path: str) -> Block:
        with open(path, "rb") as f:
            text = f.read().decode(self.encoding, "replace")
        lines = text.splitlines()
        if self.drop_empty_lines:
            lines = [ln for ln in lines if ln.strip()]
        return {"text": _objects(lines)}


def _feature_column(values: List[Any]) -> np.ndarray:
    """One TFRecord feature's values as a column: int64 or f32 where every
    row has one, or lists of one length (2-D); else an object array."""
    scalars = all(isinstance(v, (int, float)) for v in values)
    lists = not scalars and all(isinstance(v, list) for v in values) \
        and len({len(v) for v in values}) == 1 \
        and all(isinstance(x, (int, float)) for v in values for x in v)
    if values and (scalars or lists):
        flat = values if scalars else [x for v in values for x in v]
        if all(isinstance(x, int) for x in flat):
            return np.array(values, dtype=np.int64)
        if all(isinstance(x, float) for x in flat):
            return np.array(values, dtype=np.float32)
    return _objects(values)


class TFRecordDatasource(FileDatasource):
    """TFRecord shards of tf.train.Example protos -> numpy blocks
    (reference read_api.py read_tfrecords). The record framing
    (len/maskedcrc/payload/maskedcrc) and the Example wire format are
    parsed directly (``tfrecord_lite.py``, no tensorflow); CRCs are
    skipped like the reference's fast path."""

    suffix = ".tfrecord"

    def read_file(self, path: str) -> Block:
        from .tfrecord_lite import parse_tfrecord_examples

        cols = parse_tfrecord_examples(path)
        return {k: _feature_column(v) for k, v in cols.items()}


class ImageDatasource(FileDatasource):
    """Decode images into {"image": ndarray} blocks (reference
    python/ray/data/read_api.py:776 read_images). ``size=(h, w)`` resizes
    at decode time — with a fixed size rows stack into one dense
    [N, H, W, C] array; without one, rows are ragged and ship as an
    object-dtype column. ``mode`` is a PIL conversion mode;
    single-channel modes keep a trailing channel axis so the [H, W, C]
    contract holds."""

    _EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp",
             ".tif", ".tiff")

    def __init__(self, paths, size=None, mode: str = "RGB", **kwargs):
        super().__init__(paths, **kwargs)
        # Directories commonly hold labels.csv/README next to the images:
        # only files with image extensions are decoded.
        explicit = [paths] if isinstance(paths, str) else list(paths)
        keep = [p for p in self.paths
                if p.lower().endswith(self._EXTS) or p in explicit]
        if not keep:
            raise FileNotFoundError(f"no image files matched {paths}")
        self.paths = keep
        self.size = tuple(size) if size else None
        self.mode = mode

    def read_file(self, path: str) -> Block:
        Image = need("PIL.Image", "read_images")
        with Image.open(path) as im:
            im = im.convert(self.mode)
            if self.size is not None:
                # PIL takes (width, height); size is (height, width) to
                # match the ndarray [H, W, C] the caller sees.
                im = im.resize((self.size[1], self.size[0]),
                               Image.Resampling.BILINEAR)
            arr = np.asarray(im)
        if arr.ndim == 2:  # "L"/"1" modes: keep the channel axis
            arr = arr[..., None]
        col = _objects([arr]) if self.size is None else arr[None]
        return {"image": col, "path": np.array([path])}


class SQLDatasource(Datasource):
    """Rows from a DB-API query (reference read_api.py read_sql: runs
    ``sql`` through a zero-arg ``connection_factory``).

    The factory, not a connection, is what the read task holds, so it
    pickles (e.g. ``functools.partial(sqlite3.connect, path)``). One read
    task by default, like the reference; ``shard_predicates`` makes one
    task a predicate, each reading ``SELECT * FROM (sql) WHERE
    <predicate>``."""

    def __init__(self, sql: str, connection_factory: Callable[[], Any],
                 shard_predicates: Optional[List[str]] = None):
        self.sql = sql
        self.factory = connection_factory
        self.shard_predicates = shard_predicates

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        queries = [self.sql]
        if self.shard_predicates:
            queries = [
                f"SELECT * FROM ({self.sql}) WHERE {pred}"  # noqa: S608
                for pred in self.shard_predicates
            ]
        factory = self.factory

        def make(q: str) -> ReadTask:
            def read() -> Block:
                conn = factory()
                try:
                    cur = conn.cursor()
                    cur.execute(q)
                    names = [d[0] for d in cur.description]
                    rows = cur.fetchall()
                finally:
                    conn.close()
                cols: Dict[str, Any] = {}
                for i, n in enumerate(names):
                    vals = [r[i] for r in rows]
                    # Blobs as objects: a fixed-width "S" column strips
                    # their trailing NULs.
                    cols[n] = _objects(vals) if any(
                        isinstance(v, bytes) for v in vals) \
                        else np.asarray(vals)
                return cols

            return ReadTask(read)

        return [make(q) for q in queries]


class WebDatasetDatasource(FileDatasource):
    """Tar shards in WebDataset layout: members sharing a basename up to
    the first dot form one sample; the remainder is the field name
    (reference python/ray/data/datasource/webdataset_datasource.py).

    Rows come out as {"__key__": key, "<ext>": value} with stdlib-only
    decoding by extension: txt/text -> str, json -> parsed, cls/index ->
    int, npy -> ndarray, everything else (images too) -> raw bytes.
    ``decode_images=True`` decodes jpg/png/... members to [H, W, C]
    uint8 arrays through PIL."""

    suffix = ".tar"
    _IMG_EXTS = ("jpg", "jpeg", "png", "bmp", "webp", "ppm")

    def __init__(self, paths, decode_images: bool = False, **kwargs):
        super().__init__(paths, **kwargs)
        self.decode_images = decode_images

    def _decode(self, ext: str, data: bytes) -> Any:
        e = ext.lower()
        if e in ("txt", "text"):
            return data.decode("utf-8", "replace")
        if e == "json":
            import json

            return json.loads(data)
        if e in ("cls", "index"):
            return int(data.decode("ascii").strip())
        if e == "npy":
            import io

            return np.load(io.BytesIO(data), allow_pickle=False)
        if self.decode_images and e in self._IMG_EXTS:
            import io

            Image = need("PIL.Image", "read_webdataset(decode_images=True)")
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"))
        return data

    def read_file(self, path: str) -> Block:
        import tarfile

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if not m.isfile():
                    continue
                base = os.path.basename(m.name)
                if "." not in base:
                    key, ext = m.name, "bin"
                else:
                    stem, ext = base.split(".", 1)
                    key = os.path.join(os.path.dirname(m.name), stem)
                data = tf.extractfile(m).read()
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                # Compound extensions carry a codec suffix the writer added
                # ("meta.json", "x.npy"): decode by the last component and
                # strip it from the field name so write->read round-trips.
                field, last = ext, ext.rsplit(".", 1)[-1]
                if "." in ext and last in ("json", "npy"):
                    field = ext[: -(len(last) + 1)]
                samples[key][field] = self._decode(last, data)
        return rows_to_block([samples[k] for k in order])


# ------------------------------------------------------------------- writers


def write_block(block: Block, path: str, file_format: str, index: int,
                **kwargs) -> str:
    """Write one block as ``part-<index>.<format>`` under ``path``: the
    JAX package's files, byte for byte where the format is
    deterministic. The TFRecord writer takes numpy scalars and rows as
    the Python values they hold (int64 as int64 features; the JAX
    package's writes them as floats)."""
    os.makedirs(path, exist_ok=True)
    fp = os.path.join(path, f"part-{index:05d}.{file_format}")
    if file_format == "parquet":
        pq = need("pyarrow.parquet", "write_parquet")
        pq.write_table(BlockAccessor(block).to_arrow(), fp, **kwargs)
    elif file_format == "csv":
        pacsv = need("pyarrow.csv", "write_csv")
        pacsv.write_csv(BlockAccessor(block).to_arrow(), fp, **kwargs)
    elif file_format == "json":
        need("pandas", "write_json")
        BlockAccessor(block).to_pandas().to_json(fp, orient="records",
                                                 lines=True)
    elif file_format == "tfrecord":
        from .tfrecord_lite import write_tfrecord_examples

        cols = BlockAccessor(block).to_numpy()
        write_tfrecord_examples(fp, {k: np.asarray(v).tolist()
                                     for k, v in cols.items()})
    elif file_format == "tar":  # WebDataset shard
        _write_wds_shard(block, fp)
    else:
        raise ValueError(f"unknown format {file_format}")
    return fp


def _write_wds_shard(block: Block, fp: str) -> None:
    """One tar shard in WebDataset layout (reference dataset
    write_webdataset): each row becomes members ``<key>.<field>``; bytes
    pass through, str -> utf-8, int -> ascii (cls convention), dict/list
    -> json, ndarray -> .npy bytes."""
    import io
    import json as jsonlib
    import tarfile

    def encode(field: str, v: Any) -> tuple:
        if isinstance(v, np.generic):  # numpy scalars: json can't take them
            v = v.item()
        if isinstance(v, bytes):
            return field, v
        if isinstance(v, str):
            return field, v.encode("utf-8")
        if isinstance(v, (bool, int)):
            return field, str(int(v)).encode("ascii")
        if isinstance(v, np.ndarray):
            buf = io.BytesIO()
            np.save(buf, v, allow_pickle=False)
            name = field if field == "npy" or field.endswith(".npy") \
                else field + ".npy"
            return name, buf.getvalue()
        name = field if field == "json" or field.endswith(".json") \
            else field + ".json"
        return name, jsonlib.dumps(v).encode("utf-8")

    with tarfile.open(fp, "w") as tf:
        for i, row in enumerate(BlockAccessor(block).iter_rows()):
            key = row.get("__key__") or f"{i:08d}"
            for field, v in row.items():
                if field == "__key__" or v is None:
                    continue
                name, data = encode(field, v)
                info = tarfile.TarInfo(f"{key}.{name}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
