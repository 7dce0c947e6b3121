"""Dataset: a lazy data pipeline.

The port's counterpart of the JAX package's ``data/dataset.py``
(reference: python/ray/data/dataset.py — map_batches :379, iter_batches
:3725, streaming_split :1222, materialize :4605). A Dataset is a
logical-op chain that the StreamingExecutor runs on demand; its blocks
are numpy dicts of the calling process. A class UDF given to
``map_batches`` runs on a pool of spawned worker processes, one card each
with ``num_gpus=1`` (the reference's ``num_tpus``), and
``iter_device_batches`` feeds a card in this process through pinned
buffers and a side stream. ``streaming_split`` hands the blocks to
consumers in this or other processes through a coordinator thread
(``iterator.SplitCoordinator``); the writes run a block a task on this
process's threads.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from . import logical as L
from .block import Block, BlockAccessor, concat_blocks
from .context import DataContext
from .datasource import need, write_block
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
        # The coordinators of this Dataset's streaming splits: each goes
        # away with the last of this Dataset and its split iterators here.
        self._coordinators: List[Any] = []

    def __getstate__(self) -> Dict[str, Any]:
        # A Dataset sent to a worker process carries its plan, not this
        # process's run or coordinators.
        return {"_ops": self._ops, "_ctx": self._ctx}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state, _last_run=None, _coordinators=[])

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

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._append(L.RandomShuffle(seed))

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        """Shuffle at block granularity only: a cheap epoch-level
        reshuffle (reference: dataset.randomize_block_order)."""
        blocks = self._blocks()
        order = np.random.default_rng(seed).permutation(len(blocks))
        return Dataset([L.InputData(refs=[blocks[i] for i in order])],
                       self._ctx)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._append(L.Sort(key, descending))

    def limit(self, n: int) -> "Dataset":
        return self._append(L.Limit(n))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._append(L.Union([o._ops for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._append(L.Zip(other._ops))

    def groupby(self, key: Optional[str]) -> "Any":
        from .grouped import GroupedData

        return GroupedData(self, key)

    # ------------------------------------------------------------ consumption

    def _execute(self) -> Iterator[Block]:
        self._last_run = StreamingExecutor(self._ctx)
        return self._last_run.execute(self._ops)

    def _blocks(self) -> List[Block]:
        return list(self._execute())

    def to_block_refs(self) -> List[Block]:
        """The blocks (the JAX package's object refs; here the calling
        process's arrays)."""
        return self._blocks()

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

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

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
        from .iterator import _device_batches

        return _device_batches(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last),
            device, prefetch)

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

    def to_pandas(self):
        pd = need("pandas", "to_pandas")
        dfs = [BlockAccessor(b).to_pandas() for b in self._execute()]
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def to_numpy_refs(self) -> List[Block]:
        return self.to_block_refs()

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
        (the path behind get_dataset_shard; streaming_split is the
        coordinated variant)."""
        return self.split(world_size)[rank]

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints: Optional[List[str]] = None,
                        resume_key: Optional[str] = None) -> List[Any]:
        """reference: dataset.py:1222 — ``n`` coordinated iterators fed on
        demand from one run of this pipeline by a coordinator thread of
        this process (``iterator.SplitCoordinator``): the first epoch
        first come, first served, later epochs its blocks again
        round-robin. A ``SplitIterator`` pickles, so a Train worker or
        another process can consume it (its blocks then arrive as files).

        With ``resume_key`` the handout goes to a journal and each split's
        position to a cursor (``core/checkpoint.py``): a coordinator made
        again with the same key (a restarted driver) replays the journal,
        and an iterator that lost its coordinator finds the new one and
        resumes where its split stood. The handout is the reference's
        ``equal=False``: ``equal=True`` and ``locality_hints`` raise
        NotImplementedError (ROADMAP A3), since a rank given fewer
        batches than its peers would leave them waiting in a
        collective."""
        from .iterator import split_iterators

        if equal or locality_hints is not None:
            raise NotImplementedError(
                "streaming_split(equal=True) and locality_hints are not "
                "ported (ROADMAP A3): the splits are handed out first "
                "come, first served, in unequal counts")
        coord, its = split_iterators(self._ops, self._ctx, n, resume_key)
        self._coordinators.append(coord)
        return its

    def iterator(self, *, resume_key: Optional[str] = None) -> Any:
        """A DataIterator over this dataset; with ``resume_key`` its batch
        iteration journals a cursor for mid-epoch resume (reference:
        Dataset.iterator -> DataIterator)."""
        from .iterator import DataIterator

        return DataIterator(self, resume_key=resume_key)

    # ------------------------------------------------------------------ write

    def write_parquet(self, path: str, **kwargs) -> None:
        self._write(path, "parquet", **kwargs)

    def write_csv(self, path: str, **kwargs) -> None:
        self._write(path, "csv", **kwargs)

    def write_json(self, path: str, **kwargs) -> None:
        self._write(path, "json", **kwargs)

    def write_tfrecords(self, path: str, **kwargs) -> None:
        """tf.train.Example shards, one a block (dependency-free writer,
        data/tfrecord_lite.py; reference dataset.write_tfrecords)."""
        self._write(path, "tfrecord", **kwargs)

    def write_webdataset(self, path: str, **kwargs) -> None:
        """WebDataset tar shards, one a block (reference
        dataset.write_webdataset); rows keyed by "__key__" when present."""
        self._write(path, "tar", **kwargs)

    def write_sql(self, sql: str, connection_factory) -> None:
        """INSERT every row through a DB-API connection a block (reference
        dataset.write_sql): ``sql`` is a parameterized statement, e.g.
        ``INSERT INTO t VALUES(?, ?)``; the zero-arg
        ``connection_factory`` opens each block's connection. The blocks
        are written one after another (sqlite takes one writer)."""

        def native(v):
            # DB-API drivers store numpy scalars as blobs; unwrap them.
            return v.item() if hasattr(v, "item") else v

        for block in self._execute():
            conn = connection_factory()
            try:
                cur = conn.cursor()
                cur.executemany(sql, [tuple(native(v) for v in r.values())
                                      for r in BlockAccessor(block).iter_rows()])
                conn.commit()
            finally:
                conn.close()

    def _write(self, path: str, fmt: str, **kwargs) -> None:
        """One file a block, written on this process's threads as the
        blocks stream in."""
        workers = max(1, self._ctx.max_tasks_in_flight)
        with cf.ThreadPoolExecutor(workers,
                                   thread_name_prefix="rtpu-data") as pool:
            futs = [pool.submit(write_block, b, path, fmt, i, **kwargs)
                    for i, b in enumerate(self._execute())]
            for f in futs:
                f.result()

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
