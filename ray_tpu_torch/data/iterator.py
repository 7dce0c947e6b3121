"""Batch iteration and device prefetch.

The port's counterpart of the JAX package's ``data/iterator.py``
(reference: data/iterator.py DataIterator, block_batching/ — the batcher
and the local shuffle buffer). ``batch_stream`` re-chunks the block
stream into batches; ``device_batch_stream`` moves them to a CUDA card
ahead of use, the reference's ``prefetch_batches`` with pinned memory:

- a producer thread fills a ring of pinned host buffers from the numpy
  batches and copies each to the card with ``non_blocking=True`` on a
  side stream, then records an event;
- the consumer's stream waits on that event before the batch is yielded,
  and each yielded tensor is ``record_stream``-ed on it, so the caching
  allocator keeps its memory until the consumer's work is done;
- a pinned buffer is refilled only after the event of the copy that read
  it has completed;
- dropping the generator sets a stop event: the producer leaves, and the
  ring and the queued batches are freed.

Resumable ingest (``IngestCursor``) and the coordinated streaming split
need a checkpointing control plane and are not ported.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .block import BlockAccessor, concat_blocks


def batch_stream(blocks: Iterator[Any], batch_size: Optional[int],
                 batch_format: str, drop_last: bool,
                 shuffle_buffer: Optional[int],
                 shuffle_seed: Optional[int]) -> Iterator[Any]:
    """Re-chunk a stream of blocks into batches of ``batch_size`` rows
    (the whole block each with None); with a local shuffle buffer, rows
    are permuted within each ``shuffle_buffer`` rows gathered."""
    rng = np.random.default_rng(shuffle_seed)
    carry = None  # leftover block
    buffer: List[Dict[str, np.ndarray]] = []
    buffered_rows = 0

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

    for block in blocks:
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
