"""GroupedData: groupby aggregations.

The port's copy of the JAX package's ``data/grouped.py`` (reference:
data/grouped_data.py). Each aggregation appends an ``Aggregate`` op,
which the executor runs in numpy with pandas' answers
(``executor._group_agg``); ``map_groups`` sorts by the key into one
block and applies the function to each run of equal keys.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from . import logical as L


class GroupedData:
    def __init__(self, dataset, key: Optional[str]):
        self._ds = dataset
        self._key = key

    def _agg(self, aggs: List[Tuple[str, str, str]]):
        return self._ds._append(L.Aggregate(self._key, aggs))

    def count(self):
        return self._agg([("count", "", "count()")])

    def sum(self, col: str):
        return self._agg([("sum", col, f"sum({col})")])

    def mean(self, col: str):
        return self._agg([("mean", col, f"mean({col})")])

    def min(self, col: str):
        return self._agg([("min", col, f"min({col})")])

    def max(self, col: str):
        return self._agg([("max", col, f"max({col})")])

    def std(self, col: str):
        return self._agg([("std", col, f"std({col})")])

    def aggregate(self, *aggs: Tuple[str, str]):
        """aggs: (kind, col) pairs, kind in {count,sum,mean,min,max,std}."""
        return self._agg([(k, c, f"{k}({c})") for k, c in aggs])

    def map_groups(self, fn, *, batch_format: str = "numpy"):
        """Run fn(batch)->batch per group (reference: map_groups). Implemented
        as sort-by-key then per-block group apply."""
        key = self._key
        sorted_ds = self._ds.sort(key).repartition(1)

        def apply_groups(batch):
            import numpy as np

            from .block import BlockAccessor, block_from_batch, concat_blocks

            v = batch[key]
            # contiguous runs after sort
            change = np.nonzero(np.concatenate([[True], v[1:] != v[:-1]]))[0]
            bounds = list(change) + [len(v)]
            outs = []
            for s, e in zip(bounds[:-1], bounds[1:]):
                sub = {k: val[s:e] for k, val in batch.items()}
                outs.append(block_from_batch(fn(sub)))
            merged = concat_blocks(outs) if outs else {}
            return BlockAccessor(merged).to_numpy()

        return sorted_ds.map_batches(apply_groups, batch_format="numpy")
