"""Mutable channels of compiled DAGs on one host: shm slot rings with
doorbells (counterpart of the JAX package's ``dag/channels.py``,
``:114-436``).

A compiled DAG makes one reusable channel per edge when it compiles;
every ``execute()`` after that is a slot write and at most one wake.

- An edge is a ``core.object_store.SlotRing``: a depth-bounded ring of
  fixed-size shm slots with a seq and length header a slot. The producer
  publishes by bumping the ring's write seq; each consumer copies out and
  advances its own cursor. A value larger than a slot goes through a
  one-off sidecar segment named in the slot, unlinked once the slot is
  provably reused.
- Wakes are doorbells: unix datagram sockets named after the ring. A peer
  rings only where the waiter has said it blocks (the ring's waiting
  flags), so the steady state is a poll of shared memory with no system
  call.
- Values are pickled by the core's rules (``core/serialization.py``): a
  CUDA tensor travels as its host copy and the consumer puts it on its
  own device.

The JAX module's cross-host edges (``StreamInbox``, raw streams,
``:438-478``) are left out: the port's core runs on one host.
"""
from __future__ import annotations

import pickle
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from .. import flags
from ..core import object_store, serialization

# Value kinds carried in the slot header (SlotRing's ``kind``).
KIND_DATA = 0      # payload: the pickled stage result or input value
KIND_ERROR = 1     # payload: the pickled exception (flows downstream)
KIND_SIDECAR = 2   # payload: pickle of (inner kind, shm name, nbytes)


class DAGTeardownError(RuntimeError):
    """The compiled DAG was torn down while this result was outstanding:
    raised by ``CompiledDAGRef.get()`` for every execution in flight when
    a participant dies (and cannot be recovered) or the DAG is torn down.
    Carries the first cause, where one is known."""


class ChannelClosed(Exception):
    """The channel's DAG stopped (teardown, a peer's death, the writer's
    drain): resident loops leave on it, and the driver turns it into
    DAGTeardownError on the refs."""


# --------------------------------------------------------------------------
# doorbells


# Doorbells live in Linux's abstract socket namespace: no file to leak
# when a process is killed, and no limit of a socket path's length.


def writer_bell_path(ring_name: str) -> str:
    return "\0" + ring_name + "_w"


def reader_bell_path(ring_name: str, idx: int) -> str:
    return f"\0{ring_name}_r{idx}"


_ring_sock: Optional[socket.socket] = None
_ring_sock_lock = threading.Lock()


def ring_bell(path: str) -> None:
    """Fire-and-forget one-byte wake. Datagram sends are atomic, so one
    shared unbound socket serves every thread in the process; a missing or
    full peer socket is ignored — waits are timeout-bounded precisely so a
    lost wake costs latency, never correctness."""
    global _ring_sock
    s = _ring_sock
    if s is None:
        with _ring_sock_lock:
            s = _ring_sock
            if s is None:
                s = _ring_sock = socket.socket(socket.AF_UNIX,
                                               socket.SOCK_DGRAM)
    try:
        s.sendto(b"\0", path)
    except OSError:
        pass


class Doorbell:
    """The waiting side of a wake: a bound unix datagram socket.

    The waiter says it waits in the ring header's waiting flags, then
    blocks in ``wait()``; peers ``ring_bell()`` the name derived from the
    ring's."""

    def __init__(self, path: str):
        self.path = path
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._sock.bind(path)

    def wait(self, timeout: float) -> bool:
        self._sock.settimeout(timeout if timeout > 0 else 0.001)
        try:
            self._sock.recv(16)
        except (socket.timeout, OSError):
            return False
        # Drain queued rings so a burst of publishes costs one wake.
        self._sock.settimeout(0.0)
        try:
            while True:
                self._sock.recv(16)
        except (BlockingIOError, socket.timeout, OSError):
            pass
        return True

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _spin_until(cond: Callable[[], bool], spin_us: int) -> bool:
    """Busy-poll ``cond`` for up to ``spin_us`` microseconds. Zero (the
    right setting for 1-core hosts) skips straight to the doorbell."""
    if spin_us <= 0:
        return cond()
    deadline = time.monotonic_ns() + spin_us * 1_000
    while True:
        if cond():
            return True
        if time.monotonic_ns() >= deadline:
            return False


# --------------------------------------------------------------------------
# value encoding


def encode_value(value: Any) -> bytes:
    return serialization.dumps(value)


def encode_error(exc: BaseException) -> bytes:
    try:
        return serialization.dumps(exc)
    except Exception:  # noqa: BLE001 — an exception that cannot pickle
        return pickle.dumps(
            RuntimeError(f"{type(exc).__name__}: {exc!r}"))


def decode(payload: bytes) -> Any:
    return pickle.loads(payload)


def apply_selector(value: Any, key: Any) -> Any:
    """InputAttributeNode semantics, applied consumer-side: the full input
    value travels the channel once; each binding selects into it locally
    (same contract as InputAttributeNode._execute_impl)."""
    if isinstance(key, int) and isinstance(value, (list, tuple)):
        return value[key]
    if isinstance(value, dict):
        return value[key]
    return getattr(value, key)


# --------------------------------------------------------------------------
# shm transport


class ShmEdgeWriter:
    """The writer of one DAG edge: it owns the edge's SlotRing, which every
    consumer of the edge reads.

    Single writer (the producing stage's resident loop, or the driver's
    execute thread under its lock). Oversize values spill to a per-seq
    sidecar segment reaped when the slot is provably recycled — space for
    seq implies every reader advanced past seq-depth, so that sidecar can
    be unlinked before the new write. ``retain`` keeps the last N (seq,
    kind, payload) items (appended before the ring is touched), so a
    recovery can replay what a rebuilt or restarted consumer has not
    applied yet."""

    def __init__(self, ring: object_store.SlotRing, retain: int = 0):
        self.ring = ring
        self.retained: Optional[deque] = (
            deque(maxlen=retain) if retain > 0 else None)
        self._bell = Doorbell(writer_bell_path(ring.name))
        self._spin_us = int(flags.get("RTPU_DAG_SPIN_US"))
        self._meter = bool(flags.get("RTPU_DAG_METER"))
        self._sidecars: Dict[int, str] = {}
        self._closed = False

    def write(self, seq: int, kind: int, payload: bytes,
              stop: Optional[Callable[[], bool]] = None,
              record: bool = True) -> int:
        """Publish one item. Returns the ns spent blocked on ring space
        (0 on the fast path / unmetered), which the resident loop takes
        out of its send phase. ``record=False`` is the recovery replay
        path: re-delivered items must not re-count."""
        if record and self.retained is not None:
            # A retried write (a quiesce interrupted it, or the driver
            # writes an interrupted tail again) appends no seq twice.
            if not self.retained or self.retained[-1][0] < seq:
                self.retained.append((seq, kind, payload))
        ring = self.ring
        nbytes = len(payload)
        if nbytes > ring.slot_size:
            kind, payload = self._spill(seq, kind, payload)
        blocked = 0
        if not ring.has_space(seq):
            blocked = self._wait_space(seq, stop)
        old = self._sidecars.pop(seq - ring.depth, None)
        if old is not None:
            _unlink_segment(old)
        ring.write(seq, kind, payload)
        if record and self._meter:
            ring.ctr_write(1, nbytes)
        for i in range(ring.n_readers):
            if ring.reader_waiting(i):
                # Clear the flag ourselves: the queued datagram already
                # guarantees the reader wakes, so later writes in this
                # burst skip the (expensive) redundant sendto. The reader
                # re-arms the flag every blocking cycle, so no lost wake.
                ring.set_reader_waiting(i, False)
                ring_bell(reader_bell_path(ring.name, i))
        return blocked

    def _wait_space(self, seq: int, stop) -> int:
        """Wait for ring space; returns the ns spent (0 when unmetered).
        Wait time here is backpressure from slow consumers — it accrues
        into the ring's *blocked* counter line, never into the producing
        stage's send cost, so attribution blames the consumer."""
        ring = self.ring
        t0 = time.monotonic_ns() if self._meter else 0
        blocked = 0
        try:
            if not _spin_until(lambda: ring.has_space(seq), self._spin_us):
                while True:
                    if stop is not None and stop():
                        raise ChannelClosed(f"edge ring {ring.name} stopped")
                    ring.set_writer_waiting(True)
                    try:
                        if ring.has_space(seq):
                            break
                        self._bell.wait(0.05)
                    finally:
                        ring.set_writer_waiting(False)
        finally:
            if self._meter:
                blocked = time.monotonic_ns() - t0
                try:
                    ring.ctr_blocked(blocked)
                except Exception:
                    pass
        return blocked

    def _spill(self, seq: int, kind: int, payload: bytes
               ) -> Tuple[int, bytes]:
        name = f"{self.ring.name}s{seq}"
        seg = object_store.Segment(name, create=True, size=len(payload))
        seg.buf[: len(payload)] = payload
        object_store.track_channel_segment(name, len(payload))
        seg.close()
        self._sidecars[seq] = name
        return KIND_SIDECAR, pickle.dumps((kind, name, len(payload)))

    def replay(self, ring_base: Optional[int],
               stop: Optional[Callable[[], bool]] = None) -> None:
        """Recovery's re-delivery: the rebuilt ring (created with write seq
        ``ring_base``) takes every retained item from ``ring_base`` up, in
        order. record=False: the rebuilt ring's counters start at zero and
        the sampler re-baselines on the epoch bump, so counting replayed
        items would bill twice what the old incarnation reported."""
        for seq, kind, payload in list(self.retained or ()):
            if ring_base is not None and seq >= ring_base:
                self.write(seq, kind, payload, stop, record=False)

    def close(self) -> None:
        """Mark the ring drained and release everything this writer owns.
        Readers observe ``closed`` once the ring is empty and raise
        ChannelClosed; sidecars and the ring segment unlink here (creator
        owns the name)."""
        if self._closed:
            return
        self._closed = True
        try:
            self.ring.mark_closed()
            for i in range(self.ring.n_readers):
                if self.ring.reader_waiting(i):
                    ring_bell(reader_bell_path(self.ring.name, i))
        except Exception:  # noqa: BLE001 — the ring is already unmapped
            pass
        for name in self._sidecars.values():
            _unlink_segment(name)
        self._sidecars.clear()
        self._bell.close()
        self.ring.unlink()


def _unlink_segment(name: str) -> None:
    object_store.untrack_channel_segment(name)
    object_store.unlink_segment(name)


class ShmEdgeReader:
    """One consumer cursor on a same-host edge's SlotRing."""

    def __init__(self, ring_name: str, idx: int,
                 attach_timeout: float = 10.0,
                 expect_epoch: Optional[int] = None):
        self.idx = idx
        self.ring = _attach_retry(ring_name, attach_timeout,
                                  expect_epoch=expect_epoch)
        self._bell = Doorbell(reader_bell_path(ring_name, idx))
        self._spin_us = int(flags.get("RTPU_DAG_SPIN_US"))
        self._meter = bool(flags.get("RTPU_DAG_METER"))

    def recv(self, timeout: float,
             stop: Optional[Callable[[], bool]] = None
             ) -> Optional[Tuple[int, int, bytes]]:
        ring, idx = self.ring, self.idx
        if not ring.readable(idx):
            # Wait time (spin + doorbell) accrues into this reader's
            # *starved* counter line: nothing to consume means upstream is
            # the slow side of this edge.
            t0 = time.monotonic_ns() if self._meter else 0
            try:
                if not _spin_until(lambda: ring.readable(idx),
                                   self._spin_us):
                    deadline = time.monotonic() + timeout
                    while True:
                        if stop is not None and stop():
                            raise ChannelClosed(
                                f"edge ring {ring.name} stopped")
                        ring.set_reader_waiting(idx, True)
                        try:
                            if ring.readable(idx):
                                break
                            if ring.closed():
                                raise ChannelClosed(
                                    f"edge ring {ring.name} closed by writer")
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                return None
                            self._bell.wait(min(0.05, remaining))
                        finally:
                            ring.set_reader_waiting(idx, False)
            finally:
                if self._meter:
                    try:
                        ring.ctr_starved(idx, time.monotonic_ns() - t0)
                    except Exception:
                        pass
        seq, kind, payload = ring.read(idx)
        if kind == KIND_SIDECAR:
            kind, payload = _read_sidecar(payload)
        ring.advance(idx)
        if self._meter:
            ring.ctr_read(idx, 1, len(payload))
        if ring.writer_waiting():
            # Same elision as the writer side: one queued bell wakes the
            # writer, which re-arms its flag before blocking again.
            ring.set_writer_waiting(False)
            ring_bell(writer_bell_path(ring.name))
        return seq, kind, payload

    def close(self) -> None:
        self._bell.close()
        self.ring.close()


def _attach_retry(name: str, timeout: float,
                  expect_epoch: Optional[int] = None
                  ) -> object_store.SlotRing:
    """Attach to a ring a peer created. The producer creates it when it
    installs (or rebuilds) its part of the plan, in no order with its
    consumers, so a consumer waits out a start-up window. ``expect_epoch``
    rejects a stale incarnation of the ring: a rebuilt reader must never
    have its cursor satisfied by the previous epoch's segment."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            ring = object_store.SlotRing.attach(name)
            # The creator zero-fills then writes the header; an attach
            # landing inside that window sees depth=0 — not ready yet.
            if ring.depth > 0 and ring.n_readers > 0 and (
                    expect_epoch is None or ring.epoch() == expect_epoch):
                return ring
            ring.close()
        except FileNotFoundError:
            pass
        except ValueError:
            # Attach landed between the creator's shm_open and ftruncate:
            # the segment exists but is still zero-sized ("cannot mmap an
            # empty file"). Same not-ready window as depth==0.
            pass
        if time.monotonic() >= deadline:
            raise ChannelClosed(
                f"edge ring {name} never appeared (producer install "
                f"failed or tore down)")
        time.sleep(0.005)


def _read_sidecar(marker: bytes) -> Tuple[int, bytes]:
    kind, name, n = pickle.loads(marker)
    seg = object_store.Segment(name)  # the writer owns the unlink
    try:
        return kind, bytes(seg.buf[:n])
    finally:
        seg.close()
