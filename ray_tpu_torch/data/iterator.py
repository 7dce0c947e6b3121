"""Batch iteration, device prefetch, resumable ingest and coordinated
streaming splits.

The port's counterpart of the JAX package's ``data/iterator.py``
(reference: data/iterator.py DataIterator, block_batching/ — the batcher
and the local shuffle buffer — and the OutputSplitter behind
``Dataset.streaming_split``, _internal/execution/operators/
output_splitter.py).

- ``batch_stream`` re-chunks the block stream into batches, metered into
  the ``rtpu_data_operator_*`` families under operator ``iter`` and
  narrated under ``RTPU_DATA_PROGRESS``.
- ``device_batch_stream`` moves them to a CUDA card ahead of use, the
  reference's ``prefetch_batches`` with pinned memory: a producer thread
  fills a ring of pinned host buffers and copies each to the card with
  ``non_blocking=True`` on a side stream, then records an event; the
  consumer's stream waits on that event, and each yielded tensor is
  ``record_stream``-ed on it; a pinned buffer is refilled only after the
  copy that read it has completed; dropping the generator stops the
  producer and frees the ring.
- ``IngestCursor`` journals (epoch, block offset, carry rows) through
  ``core/checkpoint.py``; ``DataIterator(resume_key=...)`` rides it, so a
  restarted consumer resumes mid-epoch on the uninterrupted run's batch
  boundaries.
- ``SplitCoordinator`` feeds ``n`` split iterators from one run of the
  pipeline. The JAX package makes it a named actor; here it is an object
  of the calling process with a listener thread on an AF_UNIX address
  (``util/procs.py`` ``listen``, the processes' shared authkey) and a
  thread a connected consumer. A ``SplitIterator`` pickles: in the
  coordinator's process it calls the coordinator directly, elsewhere (a
  spawned Train or pool worker) it connects, and each block comes back
  as a ``procs.Spilled`` file. The first epoch is handed out first come,
  first served (the lock is held across the pull from the stream), later
  epochs replay its blocks round-robin.
- Failover: with a ``resume_key`` the handout journal and each split's
  cursor go through ``core/checkpoint.py``, and the coordinator listens
  on an address derived from the key. The JAX package restarts a dead
  coordinator actor (``max_restarts``); here a coordinator made again
  with the same key (a restarted driver calling ``streaming_split``)
  replays the journal, and an iterator whose coordinator went away finds
  the new one (under ``RTPU_DATA_FT``, for up to 5 s) and receives the
  same blocks for the same positions.
- Shutdown: the coordinator stops listening (its threads leave, its
  socket and directory go) once every split has reached the end of its
  stream and no consumer process is connected, or when the last of its
  Dataset and its split iterators in this process is collected; a later
  epoch is still served to the iterators of this process.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import pickle
import queue
import shutil
import socket
import tempfile
import threading
import time
import traceback
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import flags
from ..core import checkpoint
from ..util import procs
from .block import BlockAccessor, concat_blocks


class IngestCursor:
    """Journaled ingest position: (epoch, block_offset, carry_rows).

    Each ``advance`` writes one small record under id
    ``data_cursor_<key>`` (``core/checkpoint.py``: host-local, atomic
    rename, survives a killed process) and prunes the older ones. A state
    means: blocks ``[0, block_offset)`` of epoch ``epoch`` were pulled and
    delivered as batches, except the last ``carry_rows`` rows of block
    ``block_offset - 1``, which had not left the batcher yet. So a resume
    re-fetches only one block's tail, and the delivered sample stream is
    the uninterrupted run's. Plain pickle, so a cursor can travel with
    its iterator to another process.
    """

    def __init__(self, key: str):
        self._id = f"data_cursor_{key}"
        self._seq = 0
        self.state: Dict[str, int] = {"epoch": 0, "block_offset": 0,
                                      "carry_rows": 0}
        latest = checkpoint.newest_local(self._id)
        if latest is not None:
            self._seq, blob = latest
            try:
                self.state.update(pickle.loads(blob))
            except Exception:  # noqa: BLE001 — an unreadable journal is a fresh start
                pass

    def _write(self) -> None:
        self._seq += 1
        checkpoint.write_local(self._id, self._seq, pickle.dumps(self.state))

    def advance(self, epoch: int, block_offset: int,
                carry_rows: int = 0) -> None:
        self.state = {"epoch": epoch, "block_offset": block_offset,
                      "carry_rows": carry_rows}
        self._write()

    def clear(self) -> None:
        self.state = {"epoch": self.state["epoch"] + 1, "block_offset": 0,
                      "carry_rows": 0}
        self._write()


def _batch_rows(batch: Any) -> int:
    try:
        if isinstance(batch, dict):
            return len(next(iter(batch.values()))) if batch else 0
        if hasattr(batch, "num_rows"):       # arrow table
            nr = batch.num_rows
            return nr() if callable(nr) else nr
        return len(batch)                    # pandas frame
    except Exception:  # noqa: BLE001 — metering never fails a batch
        return 0


def batch_stream(blocks: Iterator[Any], batch_size: Optional[int],
                 batch_format: str, drop_last: bool,
                 shuffle_buffer: Optional[int],
                 shuffle_seed: Optional[int],
                 cursor: Optional[IngestCursor] = None) -> Iterator[Any]:
    """Re-chunk a stream of blocks into batches of ``batch_size`` rows
    (the whole block each with None); with a local shuffle buffer, rows
    are permuted within each ``shuffle_buffer`` rows gathered. Metered
    into the operator families under operator ``iter`` and, under
    ``RTPU_DATA_PROGRESS``, narrated on stderr."""
    from .executor import Progress, _op_rows_total, _op_seconds_total

    inner = _batch_stream_impl(blocks, batch_size, batch_format, drop_last,
                               shuffle_buffer, shuffle_seed, cursor)
    t0 = time.perf_counter()
    narrate = Progress("iter")
    batches = 0
    rows = 0
    try:
        for batch in inner:
            batches += 1
            rows += _batch_rows(batch)
            yield batch
            narrate.tick(lambda elapsed: (
                f"{batches} batches, {rows} rows "
                f"({rows / elapsed:.0f} rows/s)"))
    finally:
        try:
            _op_seconds_total.inc(time.perf_counter() - t0,
                                  tags={"operator": "iter", "phase": "wall"})
            if rows:
                _op_rows_total.inc(float(rows),
                                   tags={"operator": "iter", "dir": "out"})
        except Exception:  # noqa: BLE001 — export never fails the stream
            pass


def _batch_stream_impl(blocks: Iterator[Any], batch_size: Optional[int],
                       batch_format: str, drop_last: bool,
                       shuffle_buffer: Optional[int],
                       shuffle_seed: Optional[int],
                       cursor: Optional[IngestCursor] = None
                       ) -> Iterator[Any]:
    """The batcher. With a ``cursor``, journal progress at each batch and
    resume from the journaled (block_offset, carry_rows): the blocks
    before it are skipped, and only block_offset-1's tail re-seeds the
    carry. A local shuffle buffer cannot be combined with a cursor: what
    was buffered at the crash cannot be replayed exactly."""
    if cursor is not None and shuffle_buffer:
        raise ValueError(
            "resumable ingest (cursor) cannot be combined with a local "
            "shuffle buffer: buffered rows make exactly-once block "
            "delivery unreplayable; shuffle upstream (random_shuffle / "
            "randomize_block_order) instead")
    rng = np.random.default_rng(shuffle_seed)
    carry = None  # leftover block
    buffer: List[Dict[str, np.ndarray]] = []
    buffered_rows = 0
    skip = cursor.state["block_offset"] if cursor is not None else 0
    resume_carry_rows = cursor.state["carry_rows"] if cursor is not None \
        else 0
    epoch = cursor.state["epoch"] if cursor is not None else 0

    def emit(block) -> Iterator[Any]:
        nonlocal carry
        acc = BlockAccessor(block)
        n = acc.num_rows()
        if batch_size is None:
            if n:
                yield acc.to_batch(batch_format)
            return
        start = 0
        while n - start >= batch_size:
            yield BlockAccessor(acc.slice(start, start + batch_size)).to_batch(batch_format)
            start += batch_size
        carry = acc.slice(start, n) if start < n else None

    def emit_journaled(block, idx) -> Iterator[Any]:
        # Each batch is journaled as it is handed out, before the yield:
        # a batch the consumer received is never delivered again after a
        # restart. The carry is shorter than one batch, so every batch
        # boundary maps to one (block, undelivered tail) pair and a
        # resume realigns exactly.
        nonlocal carry
        carry_len = BlockAccessor(carry).num_rows() if carry is not None \
            else 0
        if carry is not None:
            block = concat_blocks([carry, block])
            carry = None
        acc = BlockAccessor(block)
        n = acc.num_rows()
        fresh = n - carry_len  # rows that belong to block `idx` itself
        if batch_size is None:
            cursor.advance(epoch, idx + 1, 0)
            if n:
                yield acc.to_batch(batch_format)
            return
        start = 0
        while n - start >= batch_size:
            nxt = start + batch_size
            cursor.advance(epoch, idx + 1, fresh - max(0, nxt - carry_len))
            yield BlockAccessor(acc.slice(start, nxt)).to_batch(batch_format)
            start = nxt
        carry = acc.slice(start, n) if start < n else None

    for idx, block in enumerate(blocks):
        if idx < skip:
            if idx == skip - 1 and resume_carry_rows:
                # The one re-fetch on resume: the tail of the last
                # journaled block re-seeds the carry.
                acc = BlockAccessor(block)
                n = acc.num_rows()
                carry = acc.slice(n - resume_carry_rows, n)
            continue
        if shuffle_buffer:
            acc = BlockAccessor(block)
            buffer.append(acc.to_numpy())
            buffered_rows += acc.num_rows()
            if buffered_rows >= shuffle_buffer:
                merged = BlockAccessor(concat_blocks(buffer))
                perm = rng.permutation(merged.num_rows())
                buffer, buffered_rows = [], 0
                block = merged.take_rows(perm)
            else:
                continue
        if cursor is not None:
            yield from emit_journaled(block, idx)
            continue
        if carry is not None:
            block = concat_blocks([carry, block])
            carry = None
        yield from emit(block)
    if shuffle_buffer and buffer:
        merged = BlockAccessor(concat_blocks(buffer))
        block = merged.take_rows(rng.permutation(merged.num_rows()))
        if carry is not None:
            block = concat_blocks([carry, block])
            carry = None
        yield from emit(block)
    if carry is not None and not drop_last:
        acc = BlockAccessor(carry)
        if acc.num_rows():
            yield acc.to_batch(batch_format)
    if cursor is not None:
        cursor.clear()  # epoch complete: roll to (epoch + 1, 0)


def _device_batches(batches: Iterator[Dict[str, np.ndarray]], device,
                    prefetch: int) -> Iterator[Any]:
    """``device_batch_stream`` onto ``device`` (the current card when
    None), refusing without CUDA: the entry of iter_device_batches."""
    import torch

    from ..device import resolve_device

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; iter_torch_batches "
                           "gives CPU tensors")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device {dev}: iter_device_batches feeds a "
                         "CUDA card; iter_torch_batches gives CPU tensors")
    return device_batch_stream(batches, dev, prefetch)


class _PinnedSlot:
    """One buffer of the ring: a pinned host tensor a column, and the
    event of the last copy that read them."""

    def __init__(self):
        self.host: Dict[str, Any] = {}
        self.copied = None  # torch.cuda.Event, None before the first use

    def fill(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        import torch

        if self.copied is not None:
            # The copy that read these buffers must be done first.
            self.copied.synchronize()
        for k, v in batch.items():
            v = np.ascontiguousarray(v)
            t = self.host.get(k)
            if (t is None or tuple(t.shape) != v.shape
                    or t.dtype != _torch_dtype(v.dtype)):
                t = torch.empty(v.shape, dtype=_torch_dtype(v.dtype),
                                pin_memory=True)
                self.host[k] = t
            t.numpy()[...] = v
        return self.host


def _torch_dtype(dtype: np.dtype):
    import torch

    return torch.from_numpy(np.empty(0, dtype)).dtype


_DONE = object()


def device_batch_stream(batches: Iterator[Dict[str, np.ndarray]], device,
                        prefetch: int) -> Iterator[Dict[str, Any]]:
    """Move numpy batches onto the CUDA ``device`` ahead of consumption:
    up to ``prefetch`` batches on their way or waiting while the consumer
    works on one (see the module's docstring)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device {device}: device_batch_stream feeds a "
                         "CUDA card")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    prefetch = max(1, prefetch)
    side = torch.cuda.Stream(device)
    ring = [_PinnedSlot() for _ in range(prefetch + 1)]
    q: "queue.Queue[Any]" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item: Any) -> bool:
        # A bounded put that notices the consumer leaving: without the
        # stop check a dropped generator would block this thread forever,
        # holding `prefetch` batches on the card.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            torch.cuda.set_device(device)
            for i, batch in enumerate(batches):
                if stop.is_set():
                    return
                slot = ring[i % len(ring)]
                host = slot.fill(batch)
                with torch.cuda.stream(side):
                    dev = {k: t.to(device, non_blocking=True)
                           for k, t in host.items()}
                    copied = torch.cuda.Event()
                    copied.record(side)
                slot.copied = copied
                if not put((dev, copied)):
                    return
        except BaseException as e:  # noqa: BLE001 — raised on the consumer side
            put(e)
        finally:
            put(_DONE)

    t = threading.Thread(target=produce, name="device-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            dev, copied = item
            stream = torch.cuda.current_stream(device)
            stream.wait_event(copied)
            for v in dev.values():
                v.record_stream(stream)
            yield dev
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)  # unblock a waiting put
            except queue.Empty:
                pass
        t.join()
        ring.clear()
        close = getattr(batches, "close", None)
        if close is not None:
            close()  # stops the pipeline upstream (a pool's workers)


# ------------------------------------------------------- streaming splits

class SplitCoordinatorGone(RuntimeError):
    """A split iterator's coordinator has gone (closed, or its process
    left) and no coordinator made again with its resume key took over."""


# The coordinators of this process by address: an iterator here calls
# its coordinator directly, and a coordinator made again with the same
# resume key takes the address over.
_COORDINATORS: "weakref.WeakValueDictionary[str, SplitCoordinator]" = \
    weakref.WeakValueDictionary()
_COORDINATORS_LOCK = threading.RLock()

# An iterator whose coordinator went away asks again this often, this
# many times, for one made again with its resume key (the JAX package's
# retry across an actor restart).
_RETRY_S, _RETRIES = 0.25, 20


def _resume_address(key: str) -> str:
    """The coordinator address of a resume key: a name in Linux's abstract
    namespace (no file), the same for a coordinator made again with the
    key on this host and checkpoint directory."""
    ident = hashlib.sha1(
        f"{checkpoint.checkpoint_dir()}\0{key}".encode()).hexdigest()[:24]
    return f"\0rtpu-split-{ident}"


class _Listener:
    """A coordinator's listener: the accept thread, a thread a connected
    consumer, and the directory its blocks travel through as files. It
    holds its coordinator weakly, so the coordinator can be collected
    while it listens; ``close`` leaves no thread, socket or file."""

    def __init__(self, coordinator: "SplitCoordinator", address: str):
        self.dir = tempfile.mkdtemp(prefix="rtpu-split-")
        self.address = address or procs.socket_address(self.dir,
                                                       "coordinator")
        self._coord = weakref.ref(coordinator)
        self._listener = procs.listen(self.address)
        self._lock = threading.Lock()
        self._conns: Dict[Any, threading.Thread] = {}
        self._files = itertools.count(1)
        self.closed = False
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="rtpu-split-accept",
                                        daemon=True)
        self._accept.start()

    def attached(self) -> int:
        with self._lock:
            return len(self._conns)

    def _accept_loop(self) -> None:
        while not self.closed:
            try:
                conn = self._listener.accept()
            except OSError:
                if self.closed:
                    return
                time.sleep(0.001)  # no busy loop on a persistent error
                continue
            except Exception:  # noqa: BLE001 — a failed handshake
                continue
            with self._lock:
                if self.closed:
                    conn.close()
                    return
                t = threading.Thread(target=self._serve, args=(conn,),
                                     name="rtpu-split-conn", daemon=True)
                self._conns[conn] = t
            t.start()

    def _serve(self, conn) -> None:
        """Answer ``(split, epoch, pos)`` with ``("ok", None)``, ``("ok",
        Spilled block)`` or ``("err", traceback)`` until the consumer
        leaves."""
        try:
            while not self.closed:
                split, epoch, pos = pickle.loads(conn.recv_bytes())
                coord = self._coord()
                if coord is None or coord.closed:
                    return
                try:
                    block = coord.next_block(split, epoch, pos)
                    value = None if block is None else procs.Spilled(
                        os.path.join(self.dir, f"{next(self._files)}.block"),
                        block)
                    reply = ("ok", value)
                except Exception:  # noqa: BLE001 — the consumer's to see
                    reply = ("err", traceback.format_exc())
                del coord
                conn.send_bytes(pickle.dumps(reply))
        except (EOFError, OSError):
            pass  # the consumer went away
        finally:
            conn.close()
            with self._lock:
                self._conns.pop(conn, None)
            coord = self._coord()
            if coord is not None:
                coord._maybe_stop_listening()

    def close(self) -> None:
        """Stop accepting, drop every consumer, join the threads (but the
        calling one), remove the directory."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            conns = dict(self._conns)
        try:
            # Wake the accept thread; it then sees the flag.
            procs.connect(self.address, 1.0).close()
        except OSError:
            pass
        me = threading.current_thread()
        if self._accept is not me:
            self._accept.join(timeout=10)
        self._listener.close()
        for conn, t in conns.items():
            if t is me:
                continue
            try:
                # Wake its thread's read with an end of file; the thread
                # closes the connection itself.
                with socket.socket(fileno=os.dup(conn.fileno())) as sock:
                    sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by its thread
            t.join(timeout=10)
        shutil.rmtree(self.dir, ignore_errors=True)


class SplitCoordinator:
    """Feeds ``n`` consumers from one run of a pipeline (reference:
    OutputSplitter behind streaming_split, ``equal=False``: the first
    epoch first come, first served; later epochs replay its blocks
    round-robin).

    With a ``resume_key`` every first-epoch handout appends to an
    assignment journal (``core/checkpoint.py``, id
    ``data_split_<key>``). A coordinator made again with the key runs
    the deterministic pipeline again and replays the journal, so a
    consumer asking for position ``pos`` gets the block it would have
    got from the first one.
    """

    def __init__(self, ops, ctx, n: int, resume_key: Optional[str] = None):
        from .executor import StreamingExecutor

        self._stream = StreamingExecutor(ctx).execute(ops)
        self._lock = threading.Lock()
        self.n = n
        self.closed = False
        self._epoch_blocks: List[Any] = []  # replayed by later epochs
        self._consumed_all = False
        self._positions: Dict[Tuple[int, int], int] = {}
        # The first epoch's handout: each split's blocks in order, and the
        # stream-order assignments that rebuild it.
        self._handout: List[List[Any]] = [[] for _ in range(n)]
        self._assignments: List[int] = []
        self._ended = [False] * n  # a split reached its stream's end
        self._journal_id = f"data_split_{resume_key}" \
            if resume_key is not None else None
        self._journal_seq = 0
        if self._journal_id is not None:
            self._replay_journal()
        address = _resume_address(resume_key) if resume_key is not None \
            else ""
        with _COORDINATORS_LOCK:
            if address:
                old = _COORDINATORS.get(address)
                if old is not None:
                    old.close()  # a stale holder of the key's address
            self._listener = _Listener(self, address)
            self.address = self._listener.address
            _COORDINATORS[self.address] = self
        # Collected (the last of its Dataset and its iterators here gone):
        # the listener goes too.
        self._finalizer = weakref.finalize(self, self._listener.close)

    def _replay_journal(self) -> None:
        latest = checkpoint.newest_local(self._journal_id)
        if latest is None:
            return
        self._journal_seq, blob = latest
        try:
            assignments = pickle.loads(blob)
        except Exception:  # noqa: BLE001 — an unreadable journal: start over
            return
        # The re-run stream is deterministic (preserve_order), so position
        # k holds the block it held before.
        for split_idx in assignments:
            try:
                block = next(self._stream)
            except StopIteration:
                self._consumed_all = True
                break
            self._epoch_blocks.append(block)
            self._handout[split_idx].append(block)
            self._assignments.append(split_idx)

    def _journal(self) -> None:
        if self._journal_id is None:
            return
        self._journal_seq += 1
        try:
            checkpoint.write_local(self._journal_id, self._journal_seq,
                                   pickle.dumps(self._assignments))
        except OSError:
            pass  # journal loss degrades failover, never the stream

    def next_block(self, split_idx: int, epoch: int,
                   pos: Optional[int] = None) -> Optional[Any]:
        """Split ``split_idx``'s block at ``pos`` of ``epoch`` (its next
        one with ``pos`` None), or None at the end of its stream."""
        if self.closed:
            raise SplitCoordinatorGone("the split coordinator was closed")
        with self._lock:
            block = self._next_locked(split_idx, epoch, pos)
            if block is None:
                self._ended[split_idx] = True
        if block is None:
            self._maybe_stop_listening()
        return block

    def _next_locked(self, split_idx: int, epoch: int,
                     pos: Optional[int]) -> Optional[Any]:
        if epoch == 0:
            if pos is not None and pos < len(self._handout[split_idx]):
                # Re-delivery: a consumer resuming at its journaled
                # position gets the identical assignment.
                return self._handout[split_idx][pos]
            if self._consumed_all:
                return None
            # First come, first served, straight off the executor (the
            # lock held across the pull).
            try:
                block = next(self._stream)
            except StopIteration:
                self._consumed_all = True
                return None
            self._epoch_blocks.append(block)
            self._handout[split_idx].append(block)
            self._assignments.append(split_idx)
            self._journal()
            return block
        # Later epochs replay the first one's blocks round-robin.
        blocks = self._epoch_blocks[split_idx::self.n]
        if pos is None:
            key = (split_idx, epoch)
            pos = self._positions.get(key, 0)
            self._positions[key] = pos + 1
        return blocks[pos] if pos < len(blocks) else None

    def _maybe_stop_listening(self) -> None:
        """Every split at its end and no consumer process connected: the
        listener, its threads and its files go (this process's iterators
        still call the coordinator directly)."""
        with self._lock:
            done = all(self._ended)
        if done and not self._listener.closed \
                and self._listener.attached() == 0:
            self._listener.close()

    def listening(self) -> bool:
        return not self._listener.closed

    def close(self) -> None:
        """Stop: the listener goes, and every later call raises
        :class:`SplitCoordinatorGone` (as the JAX package's coordinator
        actor dying)."""
        self.closed = True
        with _COORDINATORS_LOCK:
            if _COORDINATORS.get(self.address) is self:
                del _COORDINATORS[self.address]
        self._listener.close()
        with self._lock:
            self._stream.close()


class SplitIterator:
    """One consumer's handle on a :class:`SplitCoordinator`.

    It pickles (the coordinator's address, the split, the position and
    the cursor), so another process of this host can consume it: there
    it connects to the coordinator and each block arrives as a file. In
    the coordinator's process it calls the coordinator directly. With a
    cursor it journals (epoch, block position) after each block is
    consumed and resumes from the journal; with the coordinator's
    handout journal that gives each split its blocks once across a
    consumer's and a coordinator's restart (block granularity: batch
    boundaries realign at the resumed block's edge). ``fetch_s`` holds
    the seconds of each block fetch of this process.
    """

    def __init__(self, coordinator: SplitCoordinator, split_idx: int,
                 cursor: Optional[IngestCursor] = None,
                 resumable: bool = False):
        # The driver's iterators keep their coordinator alive; a copy in
        # another process holds only its address.
        self._owner: Optional[SplitCoordinator] = coordinator
        self._address = coordinator.address
        self._resumable = resumable
        self._idx = split_idx
        self._cursor = cursor
        self._epoch = cursor.state["epoch"] if cursor is not None else 0
        self._pos = cursor.state["block_offset"] if cursor is not None \
            else 0
        self._conn = None
        self.fetch_s: List[float] = []

    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        state.update(_owner=None, _conn=None, fetch_s=[])
        return state

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self._epoch, "block_offset": self._pos}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._epoch = int(state["epoch"])
        self._pos = int(state["block_offset"])

    def close(self) -> None:
        """Drop the connection to the coordinator (another process's
        iterator; its process leaving does the same)."""
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _ask(self) -> Optional[Any]:
        coord = _COORDINATORS.get(self._address)
        if coord is not None and not coord.closed:
            return coord.next_block(self._idx, self._epoch, self._pos)
        if self._owner is not None and not self._resumable:
            raise SplitCoordinatorGone("the split coordinator was closed")
        try:
            if self._conn is None:
                self._conn = procs.connect(self._address, 5.0)
            self._conn.send_bytes(pickle.dumps(
                (self._idx, self._epoch, self._pos)))
            status, value = pickle.loads(self._conn.recv_bytes())
        except (EOFError, OSError) as e:
            self.close()
            raise SplitCoordinatorGone(
                f"split {self._idx}: the coordinator cannot be reached "
                f"({e!r})") from e
        if status != "ok":
            raise RuntimeError(f"split {self._idx}: the coordinator "
                               f"failed:\n{value}")
        return None if value is None else value.load()

    def _next_block(self) -> Optional[Any]:
        """One block from the coordinator, asked again across its
        restart under ``RTPU_DATA_FT`` with a resume key: the journal
        replay hands out the same block for (epoch, pos), so a retry is
        exact."""
        attempts = 0
        while True:
            t = time.perf_counter()
            try:
                block = self._ask()
            except SplitCoordinatorGone:
                if not (self._resumable and flags.get("RTPU_DATA_FT")) \
                        or attempts >= _RETRIES:
                    raise
                attempts += 1
                time.sleep(_RETRY_S)
                continue
            self.fetch_s.append(time.perf_counter() - t)
            return block

    def _block_stream(self) -> Iterator[Any]:
        while True:
            block = self._next_block()
            if block is None:
                self._epoch += 1
                self._pos = 0
                if self._cursor is not None:
                    self._cursor.advance(self._epoch, 0)
                return
            yield block
            self._pos += 1
            if self._cursor is not None:
                # Past the yield: the consumer asked for the next block,
                # so this one was delivered.
                self._cursor.advance(self._epoch, self._pos)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None
                     ) -> Iterator[Any]:
        return batch_stream(self._block_stream(), batch_size, batch_format,
                            drop_last, local_shuffle_buffer_size,
                            local_shuffle_seed)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._block_stream():
            yield from BlockAccessor(block).iter_rows()

    def iter_device_batches(self, *, batch_size: int = 256, device=None,
                            prefetch: int = 2,
                            drop_last: bool = False) -> Iterator[Any]:
        return _device_batches(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last), device, prefetch)


def split_iterators(ops, ctx, n: int, resume_key: Optional[str]
                    ) -> Tuple[SplitCoordinator, List[SplitIterator]]:
    """``Dataset.streaming_split``'s coordinator and iterators. With a
    resume key, a live coordinator of this process holding the key is
    re-attached (the JAX package's ``get_actor`` by name); else a new
    one replays the key's journal."""
    coord = None
    if resume_key is not None:
        coord = _COORDINATORS.get(_resume_address(resume_key))
        if coord is not None and (coord.closed or coord.n != n):
            coord = None
    if coord is None:
        coord = SplitCoordinator(ops, ctx, n, resume_key)
    its = [SplitIterator(
        coord, i,
        cursor=IngestCursor(f"{resume_key}_split{i}") if resume_key else None,
        resumable=resume_key is not None) for i in range(n)]
    return coord, its


class DataIterator:
    """Resumable iteration handle over a Dataset (reference: DataIterator,
    data/iterator.py). With a ``resume_key``, batch iteration journals an
    (epoch, block offset, carry rows) cursor (``IngestCursor``): a
    restarted consumer making the iterator with the same key resumes
    mid-epoch; the delivered blocks are skipped, and the one block tail
    still in the batcher is taken again, so batch boundaries match an
    uninterrupted run."""

    def __init__(self, dataset, resume_key: Optional[str] = None):
        self._ds = dataset
        self._cursor = IngestCursor(resume_key) if resume_key else None

    @property
    def cursor(self) -> Optional[IngestCursor]:
        return self._cursor

    def state_dict(self) -> Dict[str, int]:
        return dict(self._cursor.state) if self._cursor is not None else {}

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None
                     ) -> Iterator[Any]:
        return batch_stream(
            self._ds._execute(), batch_size, batch_format, drop_last,
            local_shuffle_buffer_size, local_shuffle_seed,
            cursor=self._cursor)

    def iter_device_batches(self, *, batch_size: int = 256, device=None,
                            prefetch: int = 2,
                            drop_last: bool = False) -> Iterator[Any]:
        return _device_batches(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last), device, prefetch)
