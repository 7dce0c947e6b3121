"""Observation and action spaces: ``Box`` and ``Discrete``.

The JAX package's in-repo environments and default module catalog use
gymnasium's spaces. The port's use these two, which hold what those
readers need (``shape``, ``dtype``, ``low``/``high``, ``n``), so nothing
on the port's own paths needs gymnasium. ``core.catalog.module_for_space``
also takes gymnasium's spaces, by the same attributes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Box:
    """A box in R^shape (or the integers, for an integer dtype):
    ``low``/``high`` broadcast to ``shape``, as ``gymnasium.spaces.Box``."""

    def __init__(self, low, high, shape: Optional[Sequence[int]] = None,
                 dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low)
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape)

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Discrete:
    """The actions 0 .. n-1."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"
