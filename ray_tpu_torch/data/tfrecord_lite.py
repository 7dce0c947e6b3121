"""Dependency-free TFRecord + tf.train.Example parsing.

Role parity: the reference's read_tfrecords
(python/ray/data/read_api.py read_tfrecords) decodes Example protos into
columns; it leans on tensorflow/protobuf, neither of which this stack
wants at runtime. The two formats involved are small and stable:

TFRecord framing (tensorflow/core/lib/io/record_writer.h)::

    uint64 length | uint32 masked_crc(length) | bytes[length] data
    | uint32 masked_crc(data)

tf.train.Example is a protobuf ``Features { map<string, Feature> }`` where
Feature is a oneof of bytes_list / float_list / int64_list. Only the wire
types those use (varint, length-delimited, and packed/unpacked repeated
scalars) are implemented here. CRCs are not verified (the reference's fast
path skips them too).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int)."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_bytes_list(buf: bytes) -> List[bytes]:
    return [v for f, w, v in _fields(buf) if f == 1 and w == 2]


def _parse_float_list(buf: bytes) -> List[float]:
    out: List[float] = []
    for f, w, v in _fields(buf):
        if f != 1:
            continue
        if w == 2:  # packed
            out.extend(struct.unpack(f"<{len(v) // 4}f", v))
        elif w == 5:
            out.append(struct.unpack("<f", v)[0])
    return out


def _parse_int64_list(buf: bytes) -> List[int]:
    out: List[int] = []
    for f, w, v in _fields(buf):
        if f != 1:
            continue
        if w == 2:  # packed varints
            pos = 0
            while pos < len(v):
                val, pos = _read_varint(v, pos)
                out.append(val)
        elif w == 0:
            out.append(v)
    return out


def _parse_feature(buf: bytes) -> Any:
    """Feature oneof: 1=bytes_list, 2=float_list, 3=int64_list."""
    for f, w, v in _fields(buf):
        if w != 2:
            continue
        if f == 1:
            vals = _parse_bytes_list(v)
        elif f == 2:
            vals = _parse_float_list(v)
        elif f == 3:
            vals = _parse_int64_list(v)
        else:
            continue
        if len(vals) == 1:
            return vals[0]
        return vals
    return None


def _parse_example(buf: bytes) -> Dict[str, Any]:
    row: Dict[str, Any] = {}
    for f, w, v in _fields(buf):  # Example: field 1 = Features
        if f != 1 or w != 2:
            continue
        for ff, fw, fv in _fields(v):  # Features: field 1 = map entry
            if ff != 1 or fw != 2:
                continue
            key = None
            feat = None
            for mf, mw, mv in _fields(fv):  # map entry: 1=key, 2=value
                if mf == 1 and mw == 2:
                    key = mv.decode("utf-8", "replace")
                elif mf == 2 and mw == 2:
                    feat = _parse_feature(mv)
            if key is not None:
                row[key] = feat
    return row


def iter_tfrecords(path: str):
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)  # u64 length + u32 masked crc
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"truncated record in {path}")
            f.read(4)  # data crc, unverified
            yield data


def parse_tfrecord_examples(path: str) -> Dict[str, List[Any]]:
    """File -> columnar dict (union of keys; missing values are None)."""
    rows = [_parse_example(rec) for rec in iter_tfrecords(path)]
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    return {k: [r.get(k) for r in rows] for k in keys}


def write_tfrecord_examples(path: str, columns: Dict[str, List[Any]]) -> None:
    """Inverse of parse (tests + dataset export): encode rows as Example
    protos in TFRecord framing with zeroed CRCs."""
    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def ld(field: int, payload: bytes) -> bytes:
        return varint((field << 3) | 2) + varint(len(payload)) + payload

    keys = list(columns)
    n = len(next(iter(columns.values()))) if columns else 0
    with open(path, "wb") as f:
        for i in range(n):
            feats = b""
            for k in keys:
                v = columns[k][i]
                vals = v if isinstance(v, (list, tuple)) else [v]
                if all(isinstance(x, (bytes, str)) for x in vals):
                    bl = b"".join(
                        ld(1, x.encode() if isinstance(x, str) else x)
                        for x in vals)
                    feat = ld(1, bl)
                elif all(isinstance(x, int) for x in vals):
                    # unpacked int64s: field 1, wire 0 per value
                    il = b"".join(varint((1 << 3) | 0) + varint(x)
                                  for x in vals)
                    feat = ld(3, il)
                else:
                    fl = varint((1 << 3) | 2) + varint(4 * len(vals)) + \
                        struct.pack(f"<{len(vals)}f", *[float(x)
                                                        for x in vals])
                    feat = ld(2, fl)
                entry = ld(1, k.encode()) + ld(2, feat)
                feats += ld(1, entry)
            example = ld(1, feats)
            f.write(struct.pack("<Q", len(example)) + b"\x00" * 4
                    + example + b"\x00" * 4)
