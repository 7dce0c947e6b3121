"""The channel segments of compiled DAGs: ``SlotRing`` and the accounting
of open segments (counterpart of the part of the JAX package's
``core/object_store.py`` at ``:690-974``).

Only this part of the JAX module is ported in this slice: its arena,
spilling and native store serve the cluster's object plane, which waits
for the control plane. The port's segments are named under
``CHANNEL_PREFIX`` (``rtpt_ch_``), apart from the JAX package's
``rtpu_ch_``: the two test suites share a machine, and each one's leak
checks glob its own prefix.

A slot ring is mutable shared memory: one writer and up to
``MAX_READERS`` readers on one host meet on a fixed ring of slots, reused
for every execution, so moving a value between two processes costs one
copy in and one out plus two 8-byte header stores. Layout (all u64):

  [write_seq][closed][depth][slot_size][n_readers][writer_waiting]
  [epoch] ... then [read_seq[i]][reader_waiting[i]] for each reader,
  one 64-byte writer counter line (items, bytes, blocked_ns),
  MAX_READERS 64-byte reader counter lines (items, bytes, starved_ns),
  then ``depth`` slots of (seq, kind, len) + slot_size payload bytes.

The writer fills slot seq % depth and then publishes with write_seq =
seq + 1; a reader copies a slot out and then stores read_seq = seq + 1.
Each field has one writing process and aligned 8-byte stores are atomic,
so the hot path takes no lock. A slot is free again once every reader's
cursor has passed it, which bounds the pipeline to ``depth`` items in
flight. The waiting flags let a peer skip the doorbell when nobody
waits (``dag/channels.py`` owns the doorbells).
"""
from __future__ import annotations

import mmap
import os
import secrets
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import _posixshmem

CHANNEL_PREFIX = "rtpt_ch_"


class Segment:
    """A POSIX shared-memory segment mapped into this process (``name``,
    ``size``, ``buf``), made or opened without multiprocessing's resource
    tracker: its lifetime belongs to its creator, which unlinks it
    (:func:`unlink_segment`), not to whichever process exits first after
    touching it. (``multiprocessing.shared_memory`` registers every
    attach with the tracker on this Python, and two processes' register
    and unregister of one name race in the tracker's set.)"""

    def __init__(self, name: str, create: bool = False, size: int = 0):
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = _posixshmem.shm_open("/" + name, flags, mode=0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            else:
                size = os.fstat(fd).st_size
            if size == 0:
                # An attach between the creator's open and its truncate.
                raise ValueError(f"segment {name} is empty")
            self._mmap: Optional[mmap.mmap] = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.name = name
        self.size = size
        self.buf: Optional[memoryview] = memoryview(self._mmap)

    def close(self) -> None:
        if self.buf is not None:
            self.buf.release()
            self.buf = None
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None


def unlink_segment(name: str) -> None:
    """Remove a segment's name (its mappings live on until closed)."""
    try:
        _posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass


_U64 = struct.Struct("<Q")
_SLOT_HDR = struct.Struct("<QQQ")  # seq, kind, len

# Per-process accounting of open channel segments (rings, sidecars and
# the meter blocks): the tests hold teardown to leaking nothing by
# diffing this.
_channel_lock = threading.Lock()
_channel_open: Dict[str, int] = {}  # name -> mapped bytes


def track_channel_segment(name: str, nbytes: int) -> None:
    with _channel_lock:
        _channel_open[name] = nbytes


def untrack_channel_segment(name: str) -> None:
    with _channel_lock:
        _channel_open.pop(name, None)


def channel_segment_stats() -> Dict[str, int]:
    """Open channel segments (slot rings, sidecars, meter blocks) mapped
    by this process: {"segments": count, "bytes": total mapped}."""
    with _channel_lock:
        return {"segments": len(_channel_open),
                "bytes": sum(_channel_open.values())}


def host_channel_stats() -> Dict[str, int]:
    """Host-wide channel footprint {segments, bytes}: a /dev/shm scan for
    live segments under the port's prefix. Ground truth for the host, not
    one process's mapped view: every process on the host creates rings in
    the same namespace, and a leaked ring of a dead writer shows here."""
    segs = 0
    total = 0
    try:
        for fn in os.listdir("/dev/shm"):
            if fn.startswith(CHANNEL_PREFIX):
                try:
                    total += os.stat(os.path.join("/dev/shm", fn)).st_size
                except OSError:
                    continue
                segs += 1
    except OSError:
        pass  # non-Linux: no /dev/shm to scan
    return {"segments": segs, "bytes": total}


class SlotRing:
    """One mutable shm channel: a depth-bounded ring of fixed-size slots.

    Created by the producing process, attached by every consumer on the
    same host. ``kind`` is an application tag carried with each item
    (``dag/channels.py``: inline pickle, sidecar or error)."""

    MAX_READERS = 8
    _RHDR = 64                       # fixed header bytes before reader table
    _CTR_OFF = _RHDR + 16 * MAX_READERS   # writer counter line
    _CTR_R_OFF = _CTR_OFF + 64            # per-reader counter lines
    _SLOTS_OFF = _CTR_R_OFF + 64 * MAX_READERS

    def __init__(self, seg: Segment, created: bool):
        self._seg = seg
        self._created = created
        buf = seg.buf
        self.depth = _U64.unpack_from(buf, 16)[0]
        self.slot_size = _U64.unpack_from(buf, 24)[0]
        self.n_readers = _U64.unpack_from(buf, 32)[0]
        self._stride = _SLOT_HDR.size + self.slot_size
        # A u64 view over the counter lines: ``q[i] += d`` is cheaper than
        # a struct pack/unpack round trip, and the counter bumps are the
        # only shm writes on the metered hot path. mmap rounds segments to
        # pages, so the cast does not fail on alignment.
        try:
            self._ctr_q = buf.cast("Q") if len(buf) % 8 == 0 else None
        except (TypeError, ValueError):
            self._ctr_q = None
        self._qw = self._CTR_OFF // 8       # writer counter line, q-index
        self._qr = self._CTR_R_OFF // 8     # reader counter lines, q-index
        track_channel_segment(seg.name, seg.size)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, depth: int, slot_size: int, n_readers: int,
               name: Optional[str] = None, epoch: int = 0, base: int = 0,
               reader_starts: Optional[List[int]] = None) -> "SlotRing":
        """``epoch``/``base``/``reader_starts`` are for DAG recovery: a
        rebuilt ring starts mid-stream (write_seq = base, each reader's
        cursor at the first seq it still needs) under a bumped epoch, so a
        stale cursor is never satisfied by the wrong incarnation."""
        if n_readers > cls.MAX_READERS:
            raise ValueError(
                f"slot ring supports at most {cls.MAX_READERS} same-host "
                f"readers (got {n_readers})")
        depth = max(1, int(depth))
        total = cls._SLOTS_OFF + depth * (_SLOT_HDR.size + slot_size)
        name = name or (CHANNEL_PREFIX + secrets.token_hex(8))
        seg = Segment(name, create=True, size=total)
        seg.buf[:cls._SLOTS_OFF] = bytes(cls._SLOTS_OFF)
        _U64.pack_into(seg.buf, 0, base)
        _U64.pack_into(seg.buf, 24, slot_size)
        _U64.pack_into(seg.buf, 32, n_readers)
        _U64.pack_into(seg.buf, 48, epoch)
        for i in range(n_readers):
            start = base if reader_starts is None else reader_starts[i]
            _U64.pack_into(seg.buf, cls._RHDR + 16 * i, start)
        # depth is the attachers' readiness gate — publish it last so a
        # racing attach never observes cursors/epoch mid-initialization.
        _U64.pack_into(seg.buf, 16, depth)
        return cls(seg, created=True)

    @classmethod
    def attach(cls, name: str) -> "SlotRing":
        seg = Segment(name)
        return cls(seg, created=False)

    @property
    def name(self) -> str:
        return self._seg.name

    def close(self) -> None:
        untrack_channel_segment(self._seg.name)
        if self._ctr_q is not None:
            # The cast view keeps an export on the map; release it or
            # the segment's close raises BufferError and leaks the map.
            try:
                self._ctr_q.release()
            except Exception:
                pass
            self._ctr_q = None
        try:
            self._seg.close()
        except Exception:
            pass

    def unlink(self) -> None:
        name = self._seg.name
        self.close()
        unlink_segment(name)

    # -- header fields (each has exactly one writing process) --------------
    def write_seq(self) -> int:
        return _U64.unpack_from(self._seg.buf, 0)[0]

    def closed(self) -> bool:
        return _U64.unpack_from(self._seg.buf, 8)[0] != 0

    def mark_closed(self) -> None:
        _U64.pack_into(self._seg.buf, 8, 1)

    def epoch(self) -> int:
        return _U64.unpack_from(self._seg.buf, 48)[0]

    def read_seq(self, idx: int) -> int:
        return _U64.unpack_from(self._seg.buf, self._RHDR + 16 * idx)[0]

    def set_read_seq(self, idx: int, seq: int) -> None:
        _U64.pack_into(self._seg.buf, self._RHDR + 16 * idx, seq)

    def min_read_seq(self) -> int:
        return min(self.read_seq(i) for i in range(self.n_readers))

    def writer_waiting(self) -> bool:
        return _U64.unpack_from(self._seg.buf, 40)[0] != 0

    def set_writer_waiting(self, v: bool) -> None:
        _U64.pack_into(self._seg.buf, 40, 1 if v else 0)

    def reader_waiting(self, idx: int) -> bool:
        off = self._RHDR + 16 * idx + 8
        return _U64.unpack_from(self._seg.buf, off)[0] != 0

    def set_reader_waiting(self, idx: int, v: bool) -> None:
        _U64.pack_into(self._seg.buf, self._RHDR + 16 * idx + 8,
                       1 if v else 0)

    # -- meter counter lines (RTPU_DAG_METER) -------------------------------
    # Unsynchronised u64 read-modify-writes: each field has one writing
    # process (the ring's writer, or reader idx), so a sampler reading
    # mid-update sees the old or the new value, never a torn one (aligned
    # 8-byte stores).

    def _bump(self, off: int, delta: int) -> None:
        buf = self._seg.buf
        _U64.pack_into(buf, off, _U64.unpack_from(buf, off)[0] + delta)

    def ctr_write(self, items: int, nbytes: int) -> None:
        q = self._ctr_q
        if q is not None:
            i = self._qw
            q[i] += items
            q[i + 1] += nbytes
            return
        self._bump(self._CTR_OFF, items)
        self._bump(self._CTR_OFF + 8, nbytes)

    def ctr_blocked(self, ns: int) -> None:
        q = self._ctr_q
        if q is not None:
            q[self._qw + 2] += ns
            return
        self._bump(self._CTR_OFF + 16, ns)

    def ctr_read(self, idx: int, items: int, nbytes: int) -> None:
        q = self._ctr_q
        if q is not None:
            i = self._qr + 8 * idx
            q[i] += items
            q[i + 1] += nbytes
            return
        off = self._CTR_R_OFF + 64 * idx
        self._bump(off, items)
        self._bump(off + 8, nbytes)

    def ctr_starved(self, idx: int, ns: int) -> None:
        q = self._ctr_q
        if q is not None:
            q[self._qr + 8 * idx + 2] += ns
            return
        self._bump(self._CTR_R_OFF + 64 * idx + 16, ns)

    def counters(self) -> Dict[str, Any]:
        """Sampler-side snapshot: cumulative writer/reader counters plus
        occupancy and per-reader lag derived from the live cursors."""
        buf = self._seg.buf
        w = self.write_seq()
        readers = []
        for i in range(self.n_readers):
            off = self._CTR_R_OFF + 64 * i
            readers.append({
                "items": _U64.unpack_from(buf, off)[0],
                "bytes": _U64.unpack_from(buf, off + 8)[0],
                "starved_ns": _U64.unpack_from(buf, off + 16)[0],
                "lag": w - self.read_seq(i),
            })
        return {
            "epoch": self.epoch(),
            "write_seq": w,
            "occupancy": w - self.min_read_seq(),
            "depth": self.depth,
            "items": _U64.unpack_from(buf, self._CTR_OFF)[0],
            "bytes": _U64.unpack_from(buf, self._CTR_OFF + 8)[0],
            "blocked_ns": _U64.unpack_from(buf, self._CTR_OFF + 16)[0],
            "readers": readers,
        }

    # -- writer side -------------------------------------------------------
    def has_space(self, seq: int) -> bool:
        return seq - self.min_read_seq() < self.depth

    def write(self, seq: int, kind: int, payload) -> None:
        """Fill slot seq%depth and publish it (write_seq := seq+1). The
        caller must hold has_space(seq); payload must fit slot_size."""
        n = memoryview(payload).nbytes
        if n > self.slot_size:
            raise ValueError(f"payload {n}B exceeds slot {self.slot_size}B")
        off = self._SLOTS_OFF + (seq % self.depth) * self._stride
        _SLOT_HDR.pack_into(self._seg.buf, off, seq, kind, n)
        self._seg.buf[off + _SLOT_HDR.size: off + _SLOT_HDR.size + n] = \
            payload
        _U64.pack_into(self._seg.buf, 0, seq + 1)  # publish

    # -- reader side -------------------------------------------------------
    def readable(self, idx: int) -> bool:
        return self.write_seq() > self.read_seq(idx)

    def read(self, idx: int) -> Tuple[int, int, bytes]:
        """Copy out the next item for reader idx WITHOUT advancing; the
        caller advances after it has finished with the bytes."""
        seq = self.read_seq(idx)
        off = self._SLOTS_OFF + (seq % self.depth) * self._stride
        sseq, kind, n = _SLOT_HDR.unpack_from(self._seg.buf, off)
        if sseq != seq:  # torn ring (writer died mid-slot / layout skew)
            raise RuntimeError(
                f"channel ring {self.name}: slot seq {sseq} != expected "
                f"{seq}")
        data = bytes(
            self._seg.buf[off + _SLOT_HDR.size: off + _SLOT_HDR.size + n])
        return seq, kind, data

    def advance(self, idx: int) -> None:
        _U64.pack_into(self._seg.buf, self._RHDR + 16 * idx,
                       self.read_seq(idx) + 1)
