"""DataContext: per-driver execution knobs.

The port's copy of the JAX package's ``data/context.py`` (reference:
data/context.py DataContext), with the fields the port's executor reads.
Left out: the object-store pressure fields (``memory_high_water``,
``memory_pressure_cap``), since blocks here are numpy arrays of the
calling process and there is no store to read the pressure of; the
block size targets (``target_max_block_size``,
``target_min_block_size``), since no stage of the port splits or
coalesces blocks by size.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import ClassVar, Optional


@dataclass
class DataContext:
    # Streaming executor backpressure: the most blocks a read or task-map
    # stage has in flight on its thread pool (reference:
    # ConcurrencyCapBackpressurePolicy).
    max_tasks_in_flight: int = 8
    preserve_order: bool = True
    default_batch_format: str = "numpy"
    # Shuffle fan-out (#output partitions defaults to #input blocks).
    shuffle_partitions: Optional[int] = None
    read_parallelism: int = 8

    _lock: ClassVar[threading.Lock] = threading.Lock()
    _current: ClassVar[Optional["DataContext"]] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = DataContext()
            return cls._current
