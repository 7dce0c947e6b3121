"""Dataset: a lazy data pipeline.

The port's counterpart of the JAX package's ``data/dataset.py``
(reference: python/ray/data/dataset.py — map_batches :379, iter_batches
:3725, materialize :4605). A Dataset is a logical-op chain that the
StreamingExecutor runs on demand; its blocks are numpy dicts of the
calling process. A class UDF given to ``map_batches`` runs on a pool of
spawned worker processes, one card each with ``num_gpus=1`` (the
reference's ``num_tpus``), and ``iter_device_batches`` feeds a card in
this process through pinned buffers and a side stream.

Not ported yet (ROADMAP queue A): ``random_shuffle``, ``sort``,
``groupby``, ``zip``, ``streaming_split`` and the writes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from . import logical as L
from .block import Block, BlockAccessor, concat_blocks
from .context import DataContext
from .executor import StreamingExecutor, _pool_bounds, _pool_cards, pool_payload


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"  # pragma: no cover


class DatasetStats(str):
    """Formatted per-operator execution report (reference: DatasetStats,
    data/_internal/stats.py): a str, carrying the structured report on
    ``.to_dict()`` and the per-operator rows on ``.operators``."""

    _report: Dict[str, Any]

    def __new__(cls, text: str, report: Dict[str, Any]) -> "DatasetStats":
        s = super().__new__(cls, text)
        s._report = report
        return s

    def to_dict(self) -> Dict[str, Any]:
        return self._report

    @property
    def operators(self) -> List[Dict[str, Any]]:
        return self._report["operators"]


def _format_stats(report: Dict[str, Any]) -> str:
    lines = []
    for op in report["operators"]:
        wall = op["wall_s"]
        rate = op["blocks"] / wall if wall > 0 else 0.0
        line = (f"{op['operator']}: {wall:.3f}s over "
                f"{op['blocks']} blocks ({rate:.1f} blocks/s)")
        if op.get("retries"):
            line += f", {op['retries']} retries"
        lines.append(line)
        detail = []
        if op["udf_s"]:
            detail.append(f"udf {op['udf_s']:.3f}s")
        if op["self_s"] and op["upstream_s"]:
            detail.append(f"self {op['self_s']:.3f}s "
                          f"(+{op['upstream_s']:.3f}s upstream)")
        if op["backpressure_s"] >= 0.0005:
            detail.append(f"backpressure wait {op['backpressure_s']:.3f}s")
        if detail:
            lines.append("    " + ", ".join(detail))
        if op["rows_in"] or op["rows_out"]:
            lines.append(
                f"    rows: {op['rows_in']} in / {op['rows_out']} out, "
                f"bytes: {_fmt_bytes(op['bytes_in'])} in / "
                f"{_fmt_bytes(op['bytes_out'])} out")
        bb = op["block_bytes"]
        if bb["count"]:
            dist = f"    block size: mean {_fmt_bytes(bb['mean'])}"
            if bb["min"] is not None and bb["max"]:
                dist += (f", min {_fmt_bytes(bb['min'])}, "
                         f"max {_fmt_bytes(bb['max'])}")
            dist += f" over {bb['count']} blocks"
            lines.append(dist)
        pool = op.get("actor_pool")
        if pool:
            lines.append(
                f"    actor pool: {pool['actors']} actors, "
                f"{pool['utilization'] * 100:.0f}% busy")
    if not lines:
        return "(no stages executed)"
    if "total_wall_s" in report:
        lines.append(
            f"Total: {report['total_wall_s']:.3f}s wall, "
            f"{report['total_rows_out']} rows out, "
            f"{_fmt_bytes(report['total_bytes_out'])} out "
            f"(per-op self time sums to {report['sum_self_s']:.3f}s)")
    return "\n".join(lines)


class Dataset:
    def __init__(self, ops: List[L.LogicalOp], ctx: Optional[DataContext] = None):
        self._ops = ops
        self._ctx = ctx or DataContext.get_current()
        self._last_run: Optional[StreamingExecutor] = None

    # ------------------------------------------------------------- transforms

    def _append(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(self._ops + [op], self._ctx)

    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = None,
        batch_format: Optional[str] = None,
        fn_args: Tuple = (),
        fn_kwargs: Optional[Dict[str, Any]] = None,
        fn_constructor_args: Tuple = (),
        fn_constructor_kwargs: Optional[Dict[str, Any]] = None,
        num_gpus: Optional[float] = None,
        concurrency: Optional[Any] = None,
    ) -> "Dataset":
        """reference: dataset.py:379. A class ``fn`` runs on a pool of
        ``concurrency`` worker processes (an int, or (min, max)), each
        taking one card with ``num_gpus=1``; a plain callable runs on this
        process's threads. The class is checked for plain pickle, and the
        cards for being there, here, before anything runs."""
        op = L.MapBatches(
            fn=fn,
            batch_size=batch_size,
            batch_format=batch_format or self._ctx.default_batch_format,
            fn_args=fn_args,
            fn_kwargs=fn_kwargs or {},
            fn_constructor_args=fn_constructor_args,
            fn_constructor_kwargs=fn_constructor_kwargs or {},
            num_gpus=num_gpus,
            concurrency=concurrency,
        )
        if op.is_actor_compute:
            _pool_cards(_pool_bounds(concurrency)[1], num_gpus)
            pool_payload(op)
        elif num_gpus:
            raise ValueError(
                "num_gpus asks for pool workers, which run a class UDF; a "
                "function runs on this process's threads")
        return self._append(op)

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> "Dataset":
        return self._append(L.MapRows(fn))

    def flat_map(self, fn: Callable[[Dict[str, Any]], List[Dict[str, Any]]]) -> "Dataset":
        return self._append(L.FlatMap(fn))

    def filter(self, fn: Callable[[Dict[str, Any]], bool]) -> "Dataset":
        return self._append(L.Filter(fn))

    def add_column(self, name: str, fn: Callable[[Any], np.ndarray]) -> "Dataset":
        def add(batch):
            batch[name] = fn(batch)
            return batch

        return self._append(L.MapBatches(fn=add, batch_format="numpy"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}

        return self._append(L.MapBatches(fn=drop, batch_format="numpy"))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(batch):
            return {k: batch[k] for k in cols}

        return self._append(L.MapBatches(fn=select, batch_format="numpy"))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def ren(batch):
            return {mapping.get(k, k): v for k, v in batch.items()}

        return self._append(L.MapBatches(fn=ren, batch_format="numpy"))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._append(L.Repartition(num_blocks))

    def limit(self, n: int) -> "Dataset":
        return self._append(L.Limit(n))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._append(L.Union([o._ops for o in others]))

    # ------------------------------------------------------------ consumption

    def _execute(self) -> Iterator[Block]:
        self._last_run = StreamingExecutor(self._ctx)
        return self._last_run.execute(self._ops)

    def _blocks(self) -> List[Block]:
        return list(self._execute())

    def materialize(self) -> "Dataset":
        """Execute fully; the result holds the blocks (reference:
        dataset.py:4605 → MaterializedDataset)."""
        return Dataset([L.InputData(refs=self._blocks())], self._ctx)

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self._execute())

    def schema(self) -> Any:
        for block in self._execute():
            return BlockAccessor(block).schema()
        return None

    def columns(self) -> List[str]:
        for block in self._execute():
            return BlockAccessor(block).column_names()
        return []

    def num_blocks(self) -> int:
        return len(self._blocks())

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for block in self._execute():
            for row in BlockAccessor(block).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return self.take(n=1 << 62)

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy") -> Any:
        blocks = []
        have = 0
        for b in self._execute():
            blocks.append(b)
            have += BlockAccessor(b).num_rows()
            if have >= batch_size:
                break
        merged = BlockAccessor(concat_blocks(blocks))
        return BlockAccessor(merged.slice(0, min(batch_size, merged.num_rows()))).to_batch(batch_format)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._execute():
            yield from BlockAccessor(block).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        """reference: dataset.py:3725 — re-chunk the block stream into batches."""
        from .iterator import batch_stream

        return batch_stream(
            self._execute(), batch_size, batch_format, drop_last,
            local_shuffle_buffer_size, local_shuffle_seed,
        )

    def iter_device_batches(self, *, batch_size: int = 256, device=None,
                            prefetch: int = 2,
                            drop_last: bool = False) -> Iterator[Any]:
        """Batches as dicts of tensors on a CUDA card (the current one when
        ``device`` is None; raises without CUDA), copied from pinned host
        buffers on a side stream up to ``prefetch`` batches ahead of the
        consumer (see ``iterator.device_batch_stream``): the reference's
        ``iter_torch_batches`` with ``prefetch_batches``."""
        import torch

        from ..device import resolve_device
        from .iterator import device_batch_stream

        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; iter_torch_batches "
                               "gives CPU tensors")
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"device {dev}: iter_device_batches feeds a "
                             "CUDA card; iter_torch_batches gives CPU "
                             "tensors")
        return device_batch_stream(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last),
            dev, prefetch)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes=None, device: str = "cpu",
                           drop_last: bool = False) -> "Iterator[Any]":
        """Numpy batches -> dicts of torch tensors (reference
        dataset.iter_torch_batches)."""
        import torch

        def gen():
            for batch in self.iter_batches(batch_size=batch_size,
                                           batch_format="numpy",
                                           drop_last=drop_last):
                out = {}
                for k, v in batch.items():
                    if v.dtype == np.object_:
                        out[k] = list(v)  # ragged/object columns pass through
                        continue
                    t = torch.from_numpy(np.ascontiguousarray(v))
                    if dtypes is not None:
                        want = dtypes.get(k) if isinstance(dtypes, dict) \
                            else dtypes
                        if want is not None:
                            t = t.to(want)
                    if device != "cpu":
                        t = t.to(device)
                    out[k] = t
                yield out

        return gen()

    # ------------------------------------------------------------------ split

    def split(self, n: int) -> List["Dataset"]:
        """``n`` datasets over this one's blocks, dealt round-robin."""
        blocks = self._blocks()
        groups: List[List[Block]] = [[] for _ in range(n)]
        for i, b in enumerate(blocks):
            groups[i % n].append(b)
        return [Dataset([L.InputData(refs=g)], self._ctx) for g in groups]

    def split_shard(self, rank: int, world_size: int) -> "Dataset":
        """Deterministic round-robin block shard for data-parallel ingest
        (the path behind get_dataset_shard)."""
        return self.split(world_size)[rank]

    # ------------------------------------------------------------------ stats

    def stats(self) -> DatasetStats:
        """The per-operator report of this Dataset's last run (executing
        it first if it has not run): wall / UDF / backpressure seconds,
        rows and bytes in and out, the block-size envelope and, for a
        pool, each worker's meter (spawn and constructor seconds, UDF and
        pipe seconds, UDF calls, kernel launches, peak card memory). A
        str (the formatted report) carrying the structured dict on
        ``.to_dict()``. The JAX package runs the pipeline again in a
        metered mode; the port meters every run, at the cost of one
        message a pool worker when the stage ends."""
        if self._last_run is None:
            for _ in self._execute():
                pass
        report = self._last_run.stats_report()
        return DatasetStats(_format_stats(report), report)

    def __repr__(self) -> str:
        names = [type(op).__name__ for op in self._ops]
        return f"Dataset({' -> '.join(names)})"
