"""ray_tpu_torch.data: the data layer of the port.

The port of the JAX package's ``ray_tpu.data``: a lazy ``Dataset`` over
numpy blocks, run by a streaming executor on threads of the calling
process and, for a class UDF, on a pool of spawned worker processes (one
card each with ``num_gpus=1``); the all-to-all exchanges (shuffle, sort,
zip, groupby); the file formats and writes; batch iteration onto a card,
resumable iterators and coordinated streaming splits; and the numpy
preprocessors.
"""
from .block import Block, BlockAccessor
from .context import DataContext
from .dataset import Dataset
from .grouped import GroupedData
from .read_api import (
    from_arrow,
    from_huggingface,
    from_blocks,
    from_items,
    from_numpy,
    from_numpy_refs,
    from_pandas,
    range,  # noqa: A004
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)

__all__ = [
    "Block",
    "BlockAccessor",
    "DataContext",
    "Dataset",
    "GroupedData",
    "from_arrow",
    "from_huggingface",
    "from_blocks",
    "from_items",
    "from_numpy",
    "from_numpy_refs",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_images",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
]
