"""Dependency-free TensorBoard event-file writer (the port's copy of the JAX
package's ``util/tensorboard.py``: the same bytes).

Parity: reference tune/logger/tensorboardx.py (TBXLoggerCallback) — but the
image has no tensorboardX, so the event files are written directly: a TB
event file is a TFRecord stream of `Event` protos with MASKED CRC32C
framing (the same framing data/tfrecord_lite.py reads/writes, except
TensorBoard verifies the CRCs, so they must be real).

Only scalar summaries are emitted — the `Event{wall_time, step,
Summary{Value{tag, simple_value}}}` subset every TB frontend plots.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ----------------------------------------------------------------- crc32c
# Castagnoli polynomial (reversed: 0x82F63B78), table-driven; TB's record
# reader rejects records whose masked CRC doesn't match.

_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- proto bits


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           scalars: Optional[dict] = None) -> bytes:
    ev = bytes([(1 << 3) | 1]) + struct.pack("<d", wall_time)
    if step is not None:
        ev += _varint((2 << 3) | 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _ld(3, file_version.encode())
    if scalars:
        summ = b""
        for tag, val in scalars.items():
            value = _ld(1, str(tag).encode()) \
                + bytes([(2 << 3) | 5]) + struct.pack("<f", float(val))
            summ += _ld(1, value)
        ev += _ld(5, summ)
    return ev


class EventFileWriter:
    """One `events.out.tfevents.*` file; add_scalars() appends a record."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + record + struct.pack("<I", _masked_crc(record)))
        self._f.flush()

    def add_scalars(self, scalars: dict, step: int,
                    wall_time: Optional[float] = None) -> None:
        """Numeric entries of `scalars` become Summary values at `step`;
        non-numeric entries are skipped (same filter the reference's TBX
        logger applies)."""
        numeric = {}
        for k, v in scalars.items():
            # Strict: real numbers only. Bools would chart as spurious 0/1
            # series (every result carries done/should_checkpoint flags)
            # and numeric strings are labels, not measurements. numpy/torch
            # zero-dim scalars unwrap via .item() (np.float32 is not a
            # float subclass).
            item = getattr(v, "item", None)
            if item is not None and not isinstance(v, (bool, int, float)):
                try:
                    v = item()
                except Exception:
                    continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            numeric[k] = float(v)
        if numeric:
            self._write(_event(wall_time or time.time(), step=step,
                               scalars=numeric))

    def close(self) -> None:
        self._f.close()
