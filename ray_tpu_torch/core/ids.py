"""Identifiers of the port's core (counterpart of the JAX package's
``core/ids.py``): 16 random bytes as hex, a ``str`` subclass per kind, so
an id is a cheap, hashable, picklable dict key.

The bytes come from a Mersenne Twister per thread and per process, seeded
once from ``os.urandom``: ids are uniqueness tokens, not secrets, and a
child process reseeds rather than replay its parent's stream. The JAX
package's node, worker, placement-group and job ids name parts of its
cluster; the port's core runs on one host and keeps the ids it uses.
"""
from __future__ import annotations

import binascii
import os
import threading

_rand_local = threading.local()


def _rand16() -> bytes:
    rng = getattr(_rand_local, "rng", None)
    if rng is None or getattr(_rand_local, "pid", 0) != os.getpid():
        import random

        rng = _rand_local.rng = random.Random(os.urandom(32))
        _rand_local.pid = os.getpid()
    return rng.getrandbits(128).to_bytes(16, "little")


class BaseID(str):
    """An id: a hex string of 32 characters."""

    __slots__ = ()

    @classmethod
    def generate(cls) -> "BaseID":
        return cls(binascii.hexlify(_rand16()).decode())

    @classmethod
    def nil(cls) -> "BaseID":
        return cls("0" * 32)

    def is_nil(self) -> bool:
        return self == "0" * 32

    def hex(self) -> str:
        return str(self)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({str.__repr__(self)})"


class ObjectID(BaseID):
    __slots__ = ()


class TaskID(BaseID):
    __slots__ = ()


class ActorID(BaseID):
    __slots__ = ()


class DAGID(BaseID):
    __slots__ = ()
