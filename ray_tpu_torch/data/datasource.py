"""Datasources: read tasks producing blocks.

The port's copy of the JAX package's ``data/datasource.py``, the part the
port reads through: ``range``, ``from_items`` and ``.npy`` files
(reference: python/ray/data/datasource/ + read_api.py). A Datasource
yields ReadTask thunks; the executor runs each on its thread pool in the
calling process, and each returns one block, or yields one block a file.
The other file formats and the writes are not ported yet.
"""
from __future__ import annotations

import glob as globlib
import os
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np

from .block import Block, rows_to_block


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


class NumpyDatasource(FileDatasource):
    suffix = ".npy"

    def read_file(self, path: str) -> Block:
        return {"data": np.load(path, **self.kwargs)}
