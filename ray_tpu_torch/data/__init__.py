"""ray_tpu_torch.data: the data layer of the port.

The ported subset of the JAX package's ``ray_tpu.data``: a lazy
``Dataset`` over numpy blocks, run by a streaming executor on threads of
the calling process and, for a class UDF, on a pool of spawned worker
processes (one card each with ``num_gpus=1``); batch iteration onto a
card; and the numpy preprocessors.
"""
from .block import Block, BlockAccessor
from .context import DataContext
from .dataset import Dataset
from .read_api import (
    from_blocks,
    from_items,
    from_numpy,
    range,  # noqa: A004
    range_tensor,
    read_datasource,
    read_numpy,
)

__all__ = [
    "Block",
    "BlockAccessor",
    "DataContext",
    "Dataset",
    "from_blocks",
    "from_items",
    "from_numpy",
    "range",
    "range_tensor",
    "read_datasource",
    "read_numpy",
]
