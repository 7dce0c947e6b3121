"""The host-local durable record store (counterpart of the JAX package's
``core/checkpoint.py``, its file store: ``checkpoint_dir``,
``write_local``, ``newest_local``, ``prune_local``).

A record is one blob under an id and a monotonic sequence number, one
file ``<id>.<seq, zero-padded>.ckpt`` in ``checkpoint_dir()``, so the
lexicographic order of a listing is the order of the records. A write
goes to a temporary file that is renamed over the final name, so a
reader sees a whole record or none, also after the writer was killed;
each write prunes the older records of its id. The data layer's ingest
cursors and streaming-split journals ride on it, and so do the core's
actor checkpoints (``core/worker.py``).

An actor checkpoint (:func:`encode`/:func:`decode`, the JAX module's
``:43-64``) is one record of the live instance, its exactly-once call
journal and a monotonic epoch. The port pickles it by plain pickle, not
cloudpickle: the instance's class goes by reference, and an instance
that defines ``__getstate__`` decides what is kept (an MPMD stage keeps
what it was built from, not its weights: ``parallel/mpmd.py``).
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from .. import flags

RECORD_VERSION = 1
_SUFFIX = ".ckpt"


def encode(instance: Any, journal: Dict[str, Any], epoch: int) -> bytes:
    """One actor checkpoint record: instance, exactly-once journal and
    epoch."""
    from . import serialization

    return serialization.dumps({"v": RECORD_VERSION, "epoch": int(epoch),
                                "instance": instance, "journal": journal})


def decode(blob: bytes) -> Dict[str, Any]:
    """The record of a blob; a blob that holds a bare instance (no record)
    decodes to an epoch-0 record with an empty journal."""
    obj = pickle.loads(blob)
    if (isinstance(obj, dict) and obj.get("v") == RECORD_VERSION
            and "instance" in obj):
        obj.setdefault("journal", {})
        obj.setdefault("epoch", 0)
        return obj
    return {"v": 0, "epoch": 0, "instance": obj, "journal": {}}


def checkpoint_dir() -> str:
    """``RTPU_CHECKPOINT_DIR``, else ``rtpu_checkpoints`` under the system
    temp root; made if missing."""
    d = flags.get("RTPU_CHECKPOINT_DIR")
    if not d:
        d = os.path.join(tempfile.gettempdir(), "rtpu_checkpoints")
    os.makedirs(d, exist_ok=True)
    return d


def _path(record_id: str, seq: int) -> str:
    return os.path.join(checkpoint_dir(),
                        f"{record_id}.{int(seq):020d}{_SUFFIX}")


def write_local(record_id: str, seq: int, blob: bytes) -> str:
    """Atomically write record ``seq`` of ``record_id``; the older records
    of that id are pruned (the newest subsumes them)."""
    path = _path(record_id, seq)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    prune_local(record_id, keep_epoch=seq)
    return path


def _list_local(record_id: str) -> List[Tuple[int, str]]:
    d = checkpoint_dir()
    prefix = record_id + "."
    try:
        names = [n for n in os.listdir(d)
                 if n.startswith(prefix) and n.endswith(_SUFFIX)]
    except OSError:
        return []
    out = []
    for n in names:
        try:
            seq = int(n[len(prefix):-len(_SUFFIX)])
        except ValueError:
            continue
        out.append((seq, os.path.join(d, n)))
    return sorted(out)


def newest_local(record_id: str) -> Optional[Tuple[int, bytes]]:
    """(seq, blob) of the newest readable record of ``record_id``, or
    None."""
    for seq, path in reversed(_list_local(record_id)):
        try:
            with open(path, "rb") as f:
                return seq, f.read()
        except OSError:
            continue
    return None


def prune_local(record_id: str, keep_epoch: Optional[int] = None) -> None:
    """Delete the records of ``record_id`` older than ``keep_epoch`` (all
    of them when None)."""
    for seq, path in _list_local(record_id):
        if keep_epoch is not None and seq >= keep_epoch:
            continue
        try:
            os.unlink(path)
        except OSError:
            pass
