"""Dataset creation API.

The port's counterpart of the JAX package's ``data/read_api.py``
(reference: python/ray/data/read_api.py): ``range``, ``range_tensor``,
``from_items``, ``from_numpy``, ``from_blocks``, ``read_numpy`` and
``read_datasource``. Blocks given in are held by the Dataset as they are
(the JAX package puts them in its object store).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from . import logical as L
from .dataset import Dataset
from .datasource import (Datasource, ItemsDatasource, NumpyDatasource,
                         RangeDatasource)


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


def from_blocks(blocks: List[Dict[str, np.ndarray]]) -> Dataset:
    return Dataset([L.InputData(refs=list(blocks))])


def read_numpy(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _mk(NumpyDatasource(paths, **kwargs), parallelism)


def read_datasource(datasource: Datasource, *, parallelism: int = -1) -> Dataset:
    return _mk(datasource, parallelism)
