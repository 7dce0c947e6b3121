"""Dataset creation API.

The port's counterpart of the JAX package's ``data/read_api.py``
(reference: python/ray/data/read_api.py — read_parquet :605, range,
from_items, from_pandas, from_numpy, ...). Blocks given in are held by
the Dataset as they are (the JAX package puts them in its object store).
pandas, pyarrow, PIL and Hugging Face ``datasets`` are imported where a
function needs them; without one, the call raises an ImportError naming
it.
"""
from __future__ import annotations

import builtins
from typing import Any, Dict, List

import numpy as np

from . import logical as L
from .dataset import Dataset
from .datasource import (BinaryDatasource, CSVDatasource, Datasource,
                         ImageDatasource, ItemsDatasource, JSONDatasource,
                         NumpyDatasource, ParquetDatasource, RangeDatasource,
                         SQLDatasource, TextDatasource, TFRecordDatasource,
                         WebDatasetDatasource, need)


def _mk(ds: Datasource, parallelism: int = -1) -> Dataset:
    return Dataset([L.Read(ds, parallelism)])


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return _mk(RangeDatasource(n), parallelism)


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    return _mk(RangeDatasource(n, tensor_shape=tuple(shape)), parallelism)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    return _mk(ItemsDatasource(items), parallelism)


def from_numpy(arr: np.ndarray, *, column: str = "data") -> Dataset:
    return Dataset([L.InputData(refs=[{column: np.asarray(arr)}])])


def from_numpy_refs(refs: List[Any]) -> Dataset:
    """Blocks (``to_numpy_refs``' output: the JAX package's object refs,
    here the calling process's blocks) as a Dataset."""
    return Dataset([L.InputData(refs=list(refs))])


def from_blocks(blocks: List[Dict[str, np.ndarray]]) -> Dataset:
    return Dataset([L.InputData(refs=list(blocks))])


def from_pandas(dfs) -> Dataset:
    """One ``pyarrow.Table`` block a DataFrame, as the JAX package."""
    pd = need("pandas", "from_pandas")
    pa = need("pyarrow", "from_pandas")
    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    return Dataset([L.InputData(refs=[
        pa.Table.from_pandas(df, preserve_index=False) for df in dfs])])


def from_arrow(tables) -> Dataset:
    pa = need("pyarrow", "from_arrow")
    if isinstance(tables, pa.Table):
        tables = [tables]
    return Dataset([L.InputData(refs=list(tables))])


def from_huggingface(hf_dataset, *, blocks_per_shard: int = 4) -> Dataset:
    """Hugging Face ``datasets.Dataset`` -> Dataset (reference:
    python/ray/data/read_api.py:2664 from_huggingface). The arrow backing
    is sliced into blocks without copying rows; a ``DatasetDict`` must be
    indexed to a split first; an ``IterableDataset`` is read whole."""
    hf = need("datasets", "from_huggingface")
    if isinstance(hf_dataset, hf.DatasetDict):
        raise ValueError(
            "from_huggingface expects a single split: index the "
            f"DatasetDict first (splits: {list(hf_dataset.keys())})")
    if isinstance(hf_dataset, hf.IterableDataset):
        return from_items([dict(row) for row in hf_dataset])
    table = hf_dataset.data.table if hasattr(hf_dataset.data, "table") \
        else hf_dataset.data
    n = table.num_rows
    shards = max(1, min(blocks_per_shard, n))
    step = (n + shards - 1) // shards
    tables = [table.slice(i, min(step, n - i))
              for i in builtins.range(0, n, step)]
    return from_arrow([t.combine_chunks() for t in tables])


def read_parquet(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _mk(ParquetDatasource(paths, **kwargs), parallelism)


def read_csv(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _mk(CSVDatasource(paths, **kwargs), parallelism)


def read_json(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _mk(JSONDatasource(paths, **kwargs), parallelism)


def read_numpy(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _mk(NumpyDatasource(paths, **kwargs), parallelism)


def read_text(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """One row per line: {"text": line} (reference read_api read_text)."""
    return _mk(TextDatasource(paths, **kwargs), parallelism)


def read_tfrecords(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """tf.train.Example TFRecord shards -> numpy blocks (reference
    read_api read_tfrecords; dependency-free parsing in
    data/tfrecord_lite.py)."""
    return _mk(TFRecordDatasource(paths, **kwargs), parallelism)


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return _mk(BinaryDatasource(paths), parallelism)


def read_sql(sql: str, connection_factory, *, shard_predicates=None,
             parallelism: int = -1) -> Dataset:
    """Rows from a DB-API query (reference read_api.py read_sql). The
    zero-arg ``connection_factory`` runs in the read task;
    ``shard_predicates=["id % 2 = 0", "id % 2 = 1"]`` makes one read task
    a predicate."""
    return _mk(SQLDatasource(sql, connection_factory,
                             shard_predicates=shard_predicates), parallelism)


def read_webdataset(paths, *, decode_images: bool = False,
                    parallelism: int = -1, **kwargs) -> Dataset:
    """WebDataset tar shards -> {"__key__", "<field>": value} rows
    (reference datasource/webdataset_datasource.py; stdlib tarfile)."""
    return _mk(WebDatasetDatasource(paths, decode_images=decode_images,
                                    **kwargs), parallelism)


def read_images(paths, *, size=None, mode: str = "RGB",
                parallelism: int = -1) -> Dataset:
    """Decode image files into {"image": [H,W,C] uint8, "path"} rows
    (reference python/ray/data/read_api.py:776). ``size=(h, w)`` resizes
    at decode time so the inference batches are uniform."""
    return _mk(ImageDatasource(paths, size=size, mode=mode), parallelism)


def read_datasource(datasource: Datasource, *, parallelism: int = -1) -> Dataset:
    return _mk(datasource, parallelism)
