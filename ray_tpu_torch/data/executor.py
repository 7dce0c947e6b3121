"""Streaming execution of a logical plan: threads of the calling process
and a pool of spawned worker processes.

The port's counterpart of the JAX package's ``data/executor.py``
(reference: data/_internal/execution/streaming_executor.py, operators/
TaskPoolMapOperator and ActorPoolMapOperator). The plan is compiled into
a chain of Python generators over blocks: pulling the tail drives the
whole pipeline, and each stage keeps a bounded number of blocks in
flight (backpressure).

Where the JAX package runs every stage as tasks or actors of its control
plane over object refs, the port has no control plane (divergences by
design):

- Blocks are numpy dicts of the calling process, not object refs.
- Read and task-map stages run on a thread pool of the calling process,
  at most ``DataContext.max_tasks_in_flight`` blocks at once a stage
  (``_bounded``). numpy releases the interpreter lock in its array loops;
  a UDF in pure Python runs one thread at a time.
- A class UDF (``map_batches(cls, concurrency=...)``) runs on spawned
  worker processes (``_WorkerPool``, on the process core the Train
  layer's workers use, ``util/procs.py``), one card each with
  ``num_gpus=1``:
  the class goes by plain pickle, by reference, so it is defined at
  module level; a nested class or a lambda raises before any spawn. Each
  worker reads its pipe on one thread and runs the UDF on another, so it
  receives its next block while it computes one (the reference's
  ``max_concurrency=2``), and takes at most two blocks at once. A block
  travels as a file of the pool's temporary directory, written and read
  back in one call each (``procs.Spilled``), and the pipe carries its name:
  through the pipe itself a 154 MB block arrived in 200 KB reads, each
  waiting for the interpreter lock, at 15 MB/s on an H100's host.
- A pool worker that dies is seen by its sentinel. Under ``RTPU_DATA_FT``
  it is replaced on the same card and its in-flight blocks are sent to
  the replacement, at most ``RTPU_DATA_FT_RETRIES`` times a block;
  without the flag the stage raises :class:`PoolWorkerDiedError`.
  Drain and preemption migration, and the re-derivation of lost
  all-to-all shards, need a control plane and are not ported.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import inspect
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import flags
from ..util import procs
from . import logical as L
from .block import (Block, BlockAccessor, block_from_batch, concat_blocks,
                    rows_to_block)
from .context import DataContext

# The process's running count of blocks resent after their pool worker
# died (the JAX package's ft_counters()).
_FT_COUNTERS: Dict[str, int] = {}
_FT_LOCK = threading.Lock()


def _count(key: str, delta: int = 1) -> None:
    with _FT_LOCK:
        _FT_COUNTERS[key] = _FT_COUNTERS.get(key, 0) + delta


def ft_counters() -> Dict[str, int]:
    """Snapshot of this process's data-plane fault-tolerance counters:
    ``retries``, the blocks resubmitted after the pool worker running
    them died."""
    with _FT_LOCK:
        return {"retries": 0, **_FT_COUNTERS}


def reset_ft_counters() -> None:
    with _FT_LOCK:
        _FT_COUNTERS.clear()


class PoolWorkerDiedError(RuntimeError):
    """A pool worker process exited with blocks in flight, and the stage
    could not, or was not allowed to, resubmit them."""

    def __init__(self, label: str, slot: int, pid: Optional[int],
                 exitcode: Optional[int], why: str = ""):
        super().__init__(f"{label}: data pool worker {slot} (pid {pid}) "
                         f"died (exit code {exitcode}){why}")
        self.slot = slot
        self.pid = pid
        self.exitcode = exitcode


class PoolWorkerError(RuntimeError):
    """The UDF's constructor or call raised on a pool worker; carries the
    worker's traceback text (the exception itself may not pickle)."""

    def __init__(self, label: str, slot: int, what: str, tb: str):
        super().__init__(f"{label}: data pool worker {slot}: {what} "
                         f"failed:\n{tb}")
        self.slot = slot


# ------------------------------------------------------------- fused map fns


def _compile_map_stage(ops: List[L.LogicalOp],
                       batch_format_default: str) -> Callable[[Block], Block]:
    """Build one block→block function applying all fused ops in order
    (reference: MapTransformer chaining, _internal/execution/map_transformer.py)."""

    def apply(block: Block) -> Block:
        for op in ops:
            acc = BlockAccessor(block)
            if isinstance(op, L.MapBatches):
                fmt = op.batch_format or batch_format_default
                bs = op.batch_size
                n = acc.num_rows()
                if bs is None or bs >= n:
                    out = op.fn(acc.to_batch(fmt), *op.fn_args, **op.fn_kwargs)
                    block = block_from_batch(out)
                else:
                    parts = []
                    for s in range(0, n, bs):
                        sub = BlockAccessor(acc.slice(s, min(s + bs, n)))
                        out = op.fn(sub.to_batch(fmt), *op.fn_args, **op.fn_kwargs)
                        parts.append(block_from_batch(out))
                    block = concat_blocks(parts)
            elif isinstance(op, L.MapRows):
                block = rows_to_block([op.fn(r) for r in acc.iter_rows()])
            elif isinstance(op, L.FlatMap):
                rows: List[Dict[str, Any]] = []
                for r in acc.iter_rows():
                    rows.extend(op.fn(r))
                block = rows_to_block(rows)
            elif isinstance(op, L.Filter):
                keep = np.array([bool(op.fn(r)) for r in acc.iter_rows()], dtype=bool)
                block = acc.take_rows(np.nonzero(keep)[0])
            else:  # pragma: no cover
                raise TypeError(f"not a fusable map op: {op}")
        return block

    return apply


def _new_meter() -> Dict[str, Any]:
    return {"udf_s": 0.0, "rows_in": 0, "rows_out": 0, "bytes_in": 0,
            "bytes_out": 0, "blocks": 0}


def _kernel_launches() -> Dict[str, int]:
    """The port's kernel wrappers' launch counts in this process, where
    the module that holds them was loaded."""
    fa = sys.modules.get("ray_tpu_torch.ops.flash_attention")
    if fa is None:
        return {}
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _peak_card_bytes() -> Optional[int]:
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.max_memory_allocated())


class _PoolWorker:
    """Hosts a callable-class UDF in a pool worker process (reference:
    _MapWorker inside ActorPoolMapOperator). Every apply feeds a running
    meter (rows/bytes in and out, UDF seconds, UDF calls) that the stage
    fetches once when it ends, with the process's seconds of block
    transfer (``io``, kept by ``procs.serve``)."""

    def __init__(self, io: Dict[str, float], cls, ctor_args, ctor_kwargs):
        self.io = io
        self.fn = cls(*ctor_args, **ctor_kwargs)
        self._meter = {**_new_meter(), "batches": 0}

    def _call(self, batch, fn_args, fn_kwargs) -> Block:
        self._meter["batches"] += 1
        return block_from_batch(self.fn(batch, *fn_args, **fn_kwargs))

    def apply(self, block: Block, batch_format: str,
              batch_size: Optional[int], fn_args, fn_kwargs) -> Block:
        acc = BlockAccessor(block)
        n = acc.num_rows()
        bytes_in = acc.size_bytes()
        t0 = time.perf_counter()
        if batch_size is None or batch_size >= n:
            out = self._call(acc.to_batch(batch_format), fn_args, fn_kwargs)
        else:
            parts = []
            for s in range(0, n, batch_size):
                sub = BlockAccessor(acc.slice(s, min(s + batch_size, n)))
                parts.append(self._call(sub.to_batch(batch_format), fn_args,
                                        fn_kwargs))
            out = concat_blocks(parts)
        udf_s = time.perf_counter() - t0
        oacc = BlockAccessor(out)
        m = self._meter
        if not m["blocks"]:
            # A fresh process's first calls pay its warm-up (CUDA's
            # module loading, library handles): kept apart.
            m["first_block_udf_s"] = udf_s
        m["udf_s"] += udf_s
        m["rows_in"] += n
        m["rows_out"] += oacc.num_rows()
        m["bytes_in"] += bytes_in
        m["bytes_out"] += oacc.size_bytes()
        m["blocks"] += 1
        return out

    def meter(self) -> Dict[str, Any]:
        return {**self._meter, **self.io,
                "kernel_launches": _kernel_launches(),
                "peak_card_bytes": _peak_card_bytes()}


def _pool_worker_main(conn, slot: int, card: Optional[int], spill_dir: str,
                      payload: bytes) -> None:
    """A pool worker process: take the card, then serve the UDF's calls
    (``util/procs.py``): the reader thread takes the next block, and
    reads it back from its file, while the UDF runs on this one; each
    result goes back as a file too."""
    t_main = time.time()
    if card is not None:
        procs.take_card(card)
    t_card = time.time()
    io = {"recv_s": 0.0, "send_s": 0.0}

    def spill(seq: int, method: str, value: Any) -> Any:
        if method != "apply":
            return value
        return procs.Spilled(os.path.join(spill_dir, f"{seq}.out"), value)

    procs.serve(conn, lambda: _PoolWorker(io, *pickle.loads(payload)),
                ready={"t_main": t_main, "t_card": t_card},
                load=procs.unspill, wrap=spill, io=io)


class _Slot(procs.Worker):
    """The driver's handle on one pool worker process (one incarnation)."""

    def __init__(self, ctx, index: int, card: Optional[int], spill_dir: str,
                 payload: bytes, incarnation: int):
        super().__init__(ctx, _pool_worker_main,
                         (index, card, spill_dir, payload),
                         f"rtpu-data-worker-{index}")
        self.index = index
        self.card = card
        self.incarnation = incarnation
        self.load = 0
        self.meter: Optional[Dict[str, Any]] = None


class _WorkerPool:
    """The driver's side of one actor-pool stage: spawn, address and stop
    its worker processes, and collect their replies."""

    def __init__(self, label: str, payload: bytes,
                 cards: Optional[List[int]]):
        self.label = label
        self.payload = payload
        self.cards = cards
        self.ctx = multiprocessing.get_context("spawn")
        self.slots: List[_Slot] = []
        self.retired: List[_Slot] = []
        self.replies: Dict[int, Tuple[str, Any]] = {}
        self.n_in = 0
        self.send_s = 0.0
        self.load_s = 0.0
        # The blocks in transit, as files (in TMPDIR): removed with the
        # pool, with whatever a dead worker left there.
        self.spill_dir = tempfile.mkdtemp(prefix="rtpu-data-pool-")

    def add(self) -> _Slot:
        i = len(self.slots)
        self.slots.append(_Slot(self.ctx, i, self._card(i), self.spill_dir,
                                self.payload, 0))
        return self.slots[i]

    def replace(self, i: int) -> _Slot:
        old = self.slots[i]
        self.retired.append(old)
        self.slots[i] = _Slot(self.ctx, i, old.card, self.spill_dir,
                              self.payload, old.incarnation + 1)
        return self.slots[i]

    def _card(self, i: int) -> Optional[int]:
        return None if self.cards is None else self.cards[i]

    def send(self, slot: _Slot, method: str, args: Tuple) -> int:
        """Number and send a call, an ``apply``'s block as a file."""
        t = time.perf_counter()
        if method == "apply":
            self.n_in += 1
            path = os.path.join(self.spill_dir, f"{self.n_in}.in")
            args = (procs.Spilled(path, args[0]),) + tuple(args[1:])
        seq = slot.send(method, args)
        self.send_s += time.perf_counter() - t
        return seq

    def recv_s(self) -> float:
        return self.load_s + sum(s.recv_s for s in self.slots + self.retired)

    def wait(self, timeout: Optional[float] = None) -> List[_Slot]:
        """Wait for replies or deaths; keep every reply that arrived, and
        return the slots whose process died (their pipes read out
        first). Raises where a worker's UDF constructor raised."""
        replies, dead = procs.wait(self.slots, timeout)
        for slot, seq, status, value in replies:
            if isinstance(value, procs.Spilled):
                t = time.perf_counter()
                value = value.load()
                self.load_s += time.perf_counter() - t
            self.replies[seq] = (status, value)
        for slot in self.slots:
            if slot.ready_error is not None:
                raise PoolWorkerError(self.label, slot.index,
                                      "the UDF's constructor",
                                      slot.ready_error)
        return dead

    def meters(self, timeout: float = 10.0) -> None:
        """Fetch every live worker's meter into ``slot.meter``."""
        seqs = {}
        for slot in self.slots:
            if slot.proc.is_alive():
                seqs[self.send(slot, "meter", ())] = slot
        deadline = time.monotonic() + timeout
        while any(q not in self.replies for q in seqs):
            left = deadline - time.monotonic()
            if left <= 0 or self.wait(left):
                break
        for q, slot in seqs.items():
            status, value = self.replies.pop(q, ("err", None))
            if status == "ok":
                slot.meter = value

    def stop(self) -> None:
        procs.stop(self.slots + self.retired)
        self.slots, self.retired = [], []
        shutil.rmtree(self.spill_dir, ignore_errors=True)


def _pool_cards(max_workers: int, num_gpus: Optional[float]
                ) -> Optional[List[int]]:
    """The card of each pool worker slot (None: the CPU); raises, before
    any spawn, where the cards cannot give one to each worker."""
    if not num_gpus:
        return None
    if num_gpus != 1:
        raise ValueError(
            f"a pool worker asks for {num_gpus} cards: the port runs one "
            "process a card, so num_gpus is 0 or 1")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass num_gpus=0 to run "
                           "the pool workers on the CPU")
    cards = torch.cuda.device_count()
    if max_workers > cards:
        raise ValueError(f"{max_workers} pool workers need {max_workers} "
                         f"cards, {cards} visible: each worker takes one "
                         "card")
    return list(range(max_workers))


def _pool_bounds(concurrency: Any) -> Tuple[int, int]:
    conc = concurrency or 1
    if isinstance(conc, (tuple, list)):
        return int(conc[0]), int(conc[1])
    return int(conc), int(conc)


def pool_payload(op: L.MapBatches) -> bytes:
    """A class UDF and its constructor arguments pickled for the pool
    workers; raises here, before any spawn, where plain pickle cannot
    send them."""
    name = getattr(op.fn, "__qualname__", repr(op.fn))
    return procs.dumps((op.fn, op.fn_constructor_args,
                        op.fn_constructor_kwargs),
                       f"map_batches class {name} or its constructor "
                       "arguments", "data pool worker processes",
                       "define the class at module level, not inside a "
                       "function, and pass no lambda (a function UDF runs "
                       "in this process and may be one)")


# ----------------------------------------------------------------- executor


class StreamingExecutor:
    def __init__(self, ctx: Optional[DataContext] = None):
        self.ctx = ctx or DataContext.get_current()
        # Per-operator running aggregates (reference: _StatsActor /
        # DatasetStats): wall/udf/backpressure seconds, rows and bytes in
        # and out, block count and size envelope; O(#operators).
        self.op_stats: Dict[str, Dict[str, Any]] = {}
        self.wall_s: Optional[float] = None

    @staticmethod
    def _timed(inputs: Iterator[Any], cell: List[float]) -> Iterator[Any]:
        """Pass-through iterator accumulating time spent blocked on the
        upstream stage into cell[0], so a stage can report self-time
        (wall minus upstream)."""
        it = iter(inputs)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                cell[0] += time.perf_counter() - t0
                return
            cell[0] += time.perf_counter() - t0
            yield item

    # -- public ---------------------------------------------------------------

    def execute(self, ops: List[L.LogicalOp]) -> Iterator[Block]:
        """Yield output blocks; pulling drives the pipeline."""
        stages = L.fuse_plan(L.optimize(ops))
        stream: Iterator[Block] = iter(())
        for stage in stages:
            op = stage[0]
            if isinstance(op, L.Read):
                stream = self._read_stage(op)
            elif isinstance(op, L.InputData):
                stream = iter(list(op.refs))
            elif isinstance(op, L.MapBatches) and op.is_actor_compute:
                stream = self._actor_pool_stage(stream, op)
            elif L.is_fusable_map(op):
                stream = self._task_map_stage(stream, stage)
            elif isinstance(op, L.Repartition):
                cell = [0.0]
                stream = self._observe(
                    "Repartition",
                    self._repartition(self._timed(stream, cell),
                                      op.num_blocks), cell)
            elif isinstance(op, L.Limit):
                stream = self._limit(stream, op.n)
            elif isinstance(op, L.Union):
                stream = self._union(stream, op.others)
            else:
                raise NotImplementedError(
                    f"{type(op).__name__} is not ported to the port's data "
                    "layer yet (ROADMAP queue A)")
        return self._walled(stream)

    def _walled(self, stream: Iterator[Block]) -> Iterator[Block]:
        t0 = time.perf_counter()
        try:
            yield from stream
        finally:
            self.wall_s = time.perf_counter() - t0

    def _observe(self, label: str, inner: Iterator[Any],
                 upstream_cell: Optional[List[float]] = None) -> Iterator[Any]:
        """Record wall / block-count / self-time for stages that manage
        their own submission (the all-to-all exchanges)."""
        t0 = time.perf_counter()
        n = 0
        try:
            for block in inner:
                n += 1
                yield block
        finally:
            self._record_stat(
                label, time.perf_counter() - t0, n,
                upstream_s=upstream_cell[0] if upstream_cell else 0.0)

    # -- stages ---------------------------------------------------------------

    def _read_stage(self, op: L.Read) -> Iterator[Block]:
        parallelism = op.parallelism if op.parallelism > 0 else self.ctx.read_parallelism
        tasks = op.datasource.get_read_tasks(parallelism)

        def run(task) -> List[Block]:
            out = task()
            # A multi-block read task (one block a file) is a generator.
            return list(out) if inspect.isgenerator(out) else [out]

        def stream() -> Iterator[Block]:
            for blocks in self._bounded(((lambda t=t: run(t)) for t in tasks),
                                        "read", None, None):
                yield from blocks

        return stream()

    def _task_map_stage(self, inputs: Iterator[Block],
                        stage: List[L.LogicalOp]) -> Iterator[Block]:
        apply = _compile_map_stage(stage, self.ctx.default_batch_format)
        label = "+".join(type(o).__name__ for o in stage)
        cell = [0.0]
        meter = _new_meter()
        lock = threading.Lock()

        def metered(block: Block) -> Block:
            acc = BlockAccessor(block)
            t0 = time.perf_counter()
            out = apply(block)
            udf_s = time.perf_counter() - t0
            oacc = BlockAccessor(out)
            with lock:
                meter["udf_s"] += udf_s
                meter["rows_in"] += acc.num_rows()
                meter["rows_out"] += oacc.num_rows()
                meter["bytes_in"] += acc.size_bytes()
                meter["bytes_out"] += oacc.size_bytes()
                meter["blocks"] += 1
            return out

        thunks = ((lambda b=b: metered(b)) for b in self._timed(inputs, cell))
        return self._bounded(thunks, label, cell, meter)

    def _bounded(self, thunks: Iterator[Callable[[], Any]], label: str,
                 upstream_cell: Optional[List[float]],
                 meter: Optional[Dict[str, Any]]) -> Iterator[Any]:
        """Run the thunks on a thread pool of this process, at most
        ``max_tasks_in_flight`` at once; yield their results in submission
        (FIFO) order when ``preserve_order``, else in completion order.
        The at-cap waits in the submission loop are the stage's
        backpressure; the tail drain is completion latency."""
        cap = max(1, self.ctx.max_tasks_in_flight)
        preserve = self.ctx.preserve_order
        t0 = time.perf_counter()
        n = 0
        backpressure_s = 0.0
        pending: "collections.deque[cf.Future]" = collections.deque()
        pool = cf.ThreadPoolExecutor(cap, thread_name_prefix="rtpu-data")

        def take() -> Any:
            if preserve:
                fut = pending.popleft()
            else:
                done, _ = cf.wait(pending, return_when=cf.FIRST_COMPLETED)
                fut = next(f for f in pending if f in done)
                pending.remove(fut)
            return fut.result()

        try:
            for thunk in thunks:
                pending.append(pool.submit(thunk))
                while len(pending) >= cap:
                    tw = time.perf_counter()
                    out = take()
                    backpressure_s += time.perf_counter() - tw
                    n += 1
                    yield out
            while pending:
                out = take()
                n += 1
                yield out
        finally:
            # A downstream stage that stops pulling early (Limit) closes
            # this generator: the stage still ran and must still report.
            pool.shutdown(wait=True, cancel_futures=True)
            extra: Dict[str, Any] = {
                "backpressure_s": backpressure_s,
                "upstream_s": upstream_cell[0] if upstream_cell else 0.0,
            }
            if meter is not None:
                extra.update(meter)
                extra.pop("blocks")
                extra["block_bytes"] = {"count": meter["blocks"],
                                        "sum": meter["bytes_out"],
                                        "min": None, "max": 0}
            self._record_stat(label, time.perf_counter() - t0, n, **extra)

    # Aggregate fields summed across records; everything else in an
    # extra dict overwrites (gauges like utilization / actor counts).
    _SUM_FIELDS = ("wall_s", "blocks", "upstream_s", "backpressure_s",
                   "udf_s", "rows_in", "rows_out", "bytes_in", "bytes_out",
                   "retries")

    def _record_stat(self, label: str, wall_s: float, blocks: int,
                     **extra: Any) -> None:
        agg = self.op_stats.setdefault(label, {
            "operator": label, "wall_s": 0.0, "self_s": 0.0,
            "upstream_s": 0.0, "udf_s": 0.0, "backpressure_s": 0.0,
            "blocks": 0, "rows_in": 0, "rows_out": 0,
            "bytes_in": 0, "bytes_out": 0, "retries": 0, "records": 0,
            "block_bytes": {"count": 0, "sum": 0, "min": None, "max": 0},
        })
        agg["records"] += 1
        agg["wall_s"] += wall_s
        agg["blocks"] += blocks
        for k in self._SUM_FIELDS[2:]:
            v = extra.get(k)
            if v:
                agg[k] += v
        agg["self_s"] = max(0.0, agg["wall_s"] - agg["upstream_s"])
        for k, v in extra.items():
            if k not in self._SUM_FIELDS and k != "block_bytes":
                agg[k] = v
        bb = extra.get("block_bytes")
        if bb and bb.get("count"):
            dist = agg["block_bytes"]
            dist["count"] += bb["count"]
            dist["sum"] += bb["sum"]
            dist["max"] = max(dist["max"], bb["max"])
            dist["min"] = bb["min"] if dist["min"] is None \
                else min(dist["min"], bb["min"])

    def stats_report(self) -> Dict[str, Any]:
        """Structured per-operator report from the running aggregates
        (reference: DatasetStats.to_summary()). Ordered by first
        execution; block_bytes carries the mean alongside min/max."""
        ops = []
        for agg in self.op_stats.values():
            row = dict(agg)
            dist = dict(row["block_bytes"])
            dist["mean"] = (dist["sum"] / dist["count"]) if dist["count"] \
                else 0
            row["block_bytes"] = dist
            ops.append(row)
        # Rows/bytes out of the pipeline = the LAST operator that metered
        # them (all-to-all exchanges record wall/blocks but not rows).
        metered = [o for o in ops if o["rows_out"] or o["bytes_out"]]
        tail = metered[-1] if metered else None
        report: Dict[str, Any] = {
            "operators": ops,
            "total_rows_out": tail["rows_out"] if tail else 0,
            "total_bytes_out": tail["bytes_out"] if tail else 0,
            "sum_self_s": round(sum(o["self_s"] for o in ops), 6),
        }
        if self.wall_s is not None:
            report["total_wall_s"] = self.wall_s
        return report

    def _actor_pool_stage(self, inputs: Iterator[Block],
                          op: L.MapBatches) -> Iterator[Block]:
        """A fixed or growing pool of worker processes (reference:
        ActorPoolMapOperator + _ActorPool autoscaling): ``concurrency``
        workers, or from its min up to its max while every worker holds
        two blocks. Cards and the class are checked, and the class
        pickled, before any spawn."""
        min_w, max_w = _pool_bounds(op.concurrency)
        cards = _pool_cards(max_w, op.num_gpus)
        label = f"ActorPool[{getattr(op.fn, '__name__', type(op.fn).__name__)}]"
        payload = pool_payload(op)
        return self._run_pool(inputs, op, label, payload, cards, min_w,
                              max_w)

    def _run_pool(self, inputs: Iterator[Block], op: L.MapBatches,
                  label: str, payload: bytes, cards: Optional[List[int]],
                  min_w: int, max_w: int) -> Iterator[Block]:
        # Flags are read once a stage: the per-block path pays a bool test.
        ft = bool(flags.get("RTPU_DATA_FT"))
        retry_budget = int(flags.get("RTPU_DATA_FT_RETRIES")) if ft else 0
        fmt = op.batch_format or self.ctx.default_batch_format
        preserve = self.ctx.preserve_order
        upstream_cell = [0.0]
        inputs = self._timed(inputs, upstream_cell)
        per_worker_cap = 2
        pool = _WorkerPool(label, payload, cards)
        t0 = time.perf_counter()
        n = 0
        retries = 0
        backpressure_s = 0.0
        # Seconds from the stage's start at which each block left.
        out_s: List[float] = []
        # Entries: {"block", "seq", "slot", "inc", "attempts"}, in
        # submission order.
        inflight: List[Dict[str, Any]] = []

        def send(entry: Dict[str, Any], slot: _Slot) -> None:
            slot.load += 1
            entry.update(slot=slot.index, inc=slot.incarnation,
                         seq=pool.send(slot, "apply",
                                       (entry["block"], fmt, op.batch_size,
                                        op.fn_args, op.fn_kwargs)))

        def await_ready(slots: List[_Slot]) -> None:
            """Wait until ``slots`` have built their UDF: a block sent
            before would only wait in the pipe, and hold this thread in
            the write while the worker starts."""
            while any(s.ready is None for s in slots):
                for slot in pool.wait():
                    if slot is pool.slots[slot.index]:
                        heal(slot)

        def submit(block: Block) -> None:
            # Least-loaded dispatch; grow the pool while saturated.
            slot = min(pool.slots, key=lambda s: s.load)
            if slot.load >= per_worker_cap and len(pool.slots) < max_w:
                slot = pool.add()
                await_ready([slot])
            entry = {"block": block, "attempts": 0}
            inflight.append(entry)
            send(entry, slot)

        def heal(slot: _Slot) -> None:
            """A worker died: replace it on the same card and resend its
            blocks, or raise."""
            nonlocal retries
            lost = [e for e in inflight
                    if e["slot"] == slot.index and e["inc"] == slot.incarnation
                    and e["seq"] not in pool.replies]
            exitcode = slot.proc.exitcode
            if not ft:
                raise PoolWorkerDiedError(label, slot.index, slot.pid,
                                          exitcode)
            if slot.ready is None:
                raise PoolWorkerDiedError(label, slot.index, slot.pid,
                                          exitcode, " before it was ready")
            spent = [e for e in lost if e["attempts"] >= retry_budget]
            if spent:
                raise PoolWorkerDiedError(
                    label, slot.index, slot.pid, exitcode,
                    f"; a block already resent {retry_budget} times "
                    "(RTPU_DATA_FT_RETRIES)")
            new = pool.replace(slot.index)
            for e in lost:
                e["attempts"] += 1
                retries += 1
                _count("retries")
                send(e, new)

        def drain_one() -> Block:
            nonlocal n
            while True:
                if preserve:
                    done = inflight[0] if inflight[0]["seq"] in pool.replies \
                        else None
                else:
                    done = next((e for e in inflight
                                 if e["seq"] in pool.replies), None)
                if done is not None:
                    break
                for slot in pool.wait():
                    if slot is pool.slots[slot.index]:
                        heal(slot)
            del inflight[next(i for i, e in enumerate(inflight)
                              if e is done)]
            slot = pool.slots[done["slot"]]
            if done["inc"] == slot.incarnation:
                slot.load -= 1
            status, value = pool.replies.pop(done["seq"])
            if status == "err":
                raise PoolWorkerError(label, done["slot"], "the UDF", value)
            n += 1
            out_s.append(time.perf_counter() - t0)
            return value

        finished = False
        ready_s: Optional[float] = None
        try:
            await_ready([pool.add() for _ in range(min_w)])
            ready_s = time.perf_counter() - t0
            for block in inputs:
                while len(inflight) >= per_worker_cap * len(pool.slots):
                    tw = time.perf_counter()
                    out = drain_one()
                    backpressure_s += time.perf_counter() - tw
                    yield out
                submit(block)
            while inflight:
                yield drain_one()
            finished = True
        finally:
            wall = max(1e-9, time.perf_counter() - t0)
            extra: Dict[str, Any] = {
                "retries": retries,
                "backpressure_s": backpressure_s,
                "upstream_s": upstream_cell[0],
                # Stage start to the first workers' UDFs built, and to
                # the first block out.
                "ready_s": ready_s,
                "first_out_s": out_s[0] if out_s else None,
                "block_out_s": out_s,
                "driver_send_s": pool.send_s,
            }
            if finished:
                # Left early or failed: the workers are stopped at once,
                # unmetered, rather than waited on.
                pool.meters()
            extra["driver_recv_s"] = pool.recv_s()
            meter = _new_meter()
            workers = []
            for slot in pool.slots:
                m = slot.meter or {}
                for k in meter:
                    meter[k] += m.get(k, 0)
                ready = slot.ready or {}
                workers.append({
                    "slot": slot.index, "card": slot.card, "pid": slot.pid,
                    "incarnation": slot.incarnation,
                    # Process start to the card taken: interpreter,
                    # imports, CUDA's context; then the UDF's constructor.
                    "spawn_s": (ready["t_card"] - slot.t_start
                                if ready else None),
                    "init_s": ready.get("init_s"), **m})
            pool.stop()
            blocks_done = meter.pop("blocks")
            extra.update(meter)
            extra["block_bytes"] = {"count": blocks_done,
                                    "sum": meter["bytes_out"],
                                    "min": None, "max": 0}
            extra["actor_pool"] = {
                "actors": len(workers),
                # busy fraction: summed UDF seconds over the pool's
                # aggregate wall-clock capacity.
                "utilization": round(
                    meter["udf_s"] / (wall * max(1, len(workers))), 4),
                "workers": workers,
            }
            self._record_stat(label, wall, n, **extra)

    # -- all-to-all -----------------------------------------------------------

    def _repartition(self, inputs: Iterator[Block],
                     num_blocks: int) -> Iterator[Block]:
        blocks = list(inputs)
        counts = [BlockAccessor(b).num_rows() for b in blocks]
        total = sum(counts)
        bounds = [total * i // num_blocks for i in range(num_blocks + 1)]
        for i in range(num_blocks):
            start, end = bounds[i], bounds[i + 1]
            parts = []
            off = 0
            for b, c in zip(blocks, counts):
                lo, hi = max(start - off, 0), min(end - off, c)
                if lo < hi:
                    parts.append(BlockAccessor(b).slice(lo, hi))
                off += c
            yield concat_blocks(parts) if parts else rows_to_block([])

    def _limit(self, inputs: Iterator[Block], n: int) -> Iterator[Block]:
        taken = 0
        for block in inputs:
            if taken >= n:
                break
            c = BlockAccessor(block).num_rows()
            if taken + c <= n:
                taken += c
                yield block
            else:
                yield BlockAccessor(block).slice(0, n - taken)
                taken = n

    def _union(self, inputs: Iterator[Block],
               other_plans: List[List[L.LogicalOp]]) -> Iterator[Block]:
        yield from inputs
        for plan in other_plans:
            yield from StreamingExecutor(self.ctx).execute(plan)
