"""Block: the unit of data.

The port's copy of the JAX package's ``data/block.py`` (reference:
python/ray/data/block.py + _internal/arrow_block.py / pandas_block.py).
The block types are **dict-of-numpy** (tensor batches, the port's own
form: a pool worker turns one into a tensor with ``torch.from_numpy``) and
**pyarrow.Table**, which arrives only from a caller that has pyarrow:
pyarrow and pandas are optional, imported where a block or batch of
theirs is made or asked for.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Union

import numpy as np

try:
    import pyarrow as pa
except Exception:  # pragma: no cover
    pa = None

Block = Union["pa.Table", Dict[str, np.ndarray]]
BatchFormat = str  # "numpy" | "pandas" | "pyarrow" | "default"


def is_arrow(block: Block) -> bool:
    return pa is not None and isinstance(block, pa.Table)


class BlockAccessor:
    """Uniform view over a block (reference: BlockAccessor, data/block.py)."""

    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # ------------------------------------------------------------------ basics

    def num_rows(self) -> int:
        if is_arrow(self.block):
            return self.block.num_rows
        if not self.block:
            return 0
        return len(next(iter(self.block.values())))

    def size_bytes(self) -> int:
        if is_arrow(self.block):
            return self.block.nbytes
        return int(sum(np.asarray(v).nbytes for v in self.block.values()))

    def schema(self) -> Any:
        if is_arrow(self.block):
            return self.block.schema
        return {k: np.asarray(v).dtype for k, v in self.block.items()}

    def column_names(self) -> List[str]:
        if is_arrow(self.block):
            return list(self.block.column_names)
        return list(self.block.keys())

    # ------------------------------------------------------------ conversions

    def to_numpy(self) -> Dict[str, np.ndarray]:
        if is_arrow(self.block):
            out = {}
            for name in self.block.column_names:
                col = self.block.column(name)
                out[name] = col.to_numpy(zero_copy_only=False)
            return out
        return {k: np.asarray(v) for k, v in self.block.items()}

    def to_arrow(self) -> "pa.Table":
        if is_arrow(self.block):
            return self.block
        cols, names = [], []
        for k, v in self.block.items():
            v = np.asarray(v)
            if v.ndim > 1:
                # Tensor column: store as fixed-size-list (reference uses its
                # ArrowTensorArray extension for the same purpose).
                flat = v.reshape(len(v), -1)
                arr = pa.FixedSizeListArray.from_arrays(
                    pa.array(flat.ravel()), flat.shape[1]
                )
                cols.append(arr)
            else:
                cols.append(pa.array(v))
            names.append(k)
        return pa.Table.from_arrays(cols, names=names)

    def to_pandas(self):
        import pandas as pd

        if is_arrow(self.block):
            return self.block.to_pandas()
        return pd.DataFrame({k: list(v) if np.asarray(v).ndim > 1 else v
                             for k, v in self.block.items()})

    def to_batch(self, batch_format: BatchFormat = "numpy") -> Any:
        if batch_format in ("numpy", "default", None):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    # ---------------------------------------------------------------- slicing

    def slice(self, start: int, end: int) -> Block:
        if is_arrow(self.block):
            return self.block.slice(start, end - start)
        return {k: np.asarray(v)[start:end] for k, v in self.block.items()}

    def take_rows(self, indices: np.ndarray) -> Block:
        if is_arrow(self.block):
            return self.block.take(pa.array(indices))
        return {k: np.asarray(v)[indices] for k, v in self.block.items()}

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        n = self.num_rows()
        cols = self.to_numpy()
        for i in range(n):
            yield {k: v[i] for k, v in cols.items()}


def block_from_batch(batch: Any) -> Block:
    """Normalize a UDF's returned batch into a block."""
    if pa is not None and isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return pa.Table.from_pandas(batch, preserve_index=False)
    except Exception:
        pass
    raise TypeError(
        f"map_batches UDF must return dict[str, np.ndarray], pyarrow.Table or "
        f"pandas.DataFrame, got {type(batch)}"
    )


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0] or blocks[:1]
    if not blocks:
        return {}
    if all(is_arrow(b) for b in blocks):
        return pa.concat_tables(blocks, promote_options="default")
    parts = [BlockAccessor(b).to_numpy() for b in blocks]
    keys = parts[0].keys()
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in keys}


def rows_to_block(rows: List[Dict[str, Any]]) -> Block:
    """Build a block from a list of row dicts (used by from_items/map)."""
    if not rows:
        return {}
    # Union of keys over ALL rows, first-seen order: ragged row sets (e.g.
    # WebDataset samples with differing members) must neither KeyError nor
    # silently drop fields absent from row 0.
    keys: Dict[str, None] = {}
    for r in rows:
        for k in r:
            keys[k] = None
    ragged = any(len(r) != len(keys) for r in rows)
    cols: Dict[str, Any] = {}
    numpyable = not ragged
    for k in keys:
        vals = [r.get(k) for r in rows]
        first = np.asarray(vals[0])
        if first.dtype == object:
            numpyable = False
            cols[k] = vals
        else:
            try:
                cols[k] = np.stack([np.asarray(v) for v in vals])
            except Exception:
                numpyable = False
                cols[k] = vals
    if numpyable:
        return cols
    if pa is not None:
        try:
            return pa.Table.from_pylist(rows)
        except (pa.lib.ArrowInvalid, pa.lib.ArrowTypeError):
            pass  # multi-dim ndarrays / mixed-type columns: no arrow layout
    # Object-dtype numpy columns carry anything (per-row ndarrays, dicts);
    # same representation ImageDatasource uses for ragged images.
    out: Dict[str, Any] = {}
    for k in keys:
        vals = [r.get(k) for r in rows]
        col = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            col[i] = v
        out[k] = col
    return out
