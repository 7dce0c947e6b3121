"""The port core's serialization rules (counterpart of the JAX package's
``core/serialization.py``, which cloudpickles and threads refs through
an ownership sidecar).

- Functions and classes go by plain pickle, by reference (the card's
  machine has no cloudpickle): a nested function, a closure or a lambda
  cannot travel and raises where it is sent (``util/procs.py`` ``dumps``).
- CPU tensors and arrays go out of band where the channel takes buffers
  (a spilled file, pickle protocol 5); bfloat16, which numpy lacks, as
  int16 bits (``procs._TensorPickler``).
- A CUDA tensor travels as its host copy, and the receiving process puts
  it on its own device (:func:`own_device`): its card where it took one,
  else the current card where it has CUDA, else the CPU. Plain pickle
  would rebuild it on the receiver's ``cuda:0``, whatever card that
  process was given.
- An :class:`ObjectRef` travels by id, and so does an actor handle
  (``core/api.py``). The driver owns every object: where the driver
  sends a ref to a process, that process borrows it (:func:`capture`
  tells the driver which refs a message carried), and the object stays
  pinned until the process drops its last copy or exits. In the driver
  a ref that arrives is the driver's own again; in a task worker or an
  actor it is a client's ref (``core/api.py`` ``_Client``), whose last
  drop tells the driver.
"""
from __future__ import annotations

import contextlib
import io
import pickle
import sys
import threading
from typing import Any, Iterator, List, Optional

from ..util import procs
from . import context as ctx

# Results and arguments that pickle to this many bytes or more travel as
# files (``procs.Spilled``); smaller ones through the pipe.
SPILL_BYTES = 1 << 20

# The refs each active :func:`capture` of this thread has seen pickled.
_captures = threading.local()
# What makes a ref that arrives in this process: the driver's runtime or
# a worker's client (``core/api.py``), set where either starts; without
# one a ref rebuilds untracked.
_tracker: Optional[Any] = None


def set_tracker(tracker: Optional[Any]) -> None:
    global _tracker
    _tracker = tracker


@contextlib.contextmanager
def capture() -> Iterator[List[str]]:
    """The ids of the refs pickled in this thread inside the block, once
    for each time one was pickled (the innermost capture takes them)."""
    stack = getattr(_captures, "stack", None)
    if stack is None:
        stack = _captures.stack = []
    found: List[str] = []
    stack.append(found)
    try:
        yield found
    finally:
        stack.pop()


def _captured(found: List[str]) -> None:
    """Hand refs an inner capture took on to the capture around it."""
    stack = getattr(_captures, "stack", None)
    if stack:
        stack[-1].extend(found)


@contextlib.contextmanager
def delivering() -> Iterator[None]:
    """Refs unpickled in this thread inside the block were sent by the
    driver, which counted them as this process's borrows (a worker's
    client counts them back when it releases them)."""
    _captures.delivering = getattr(_captures, "delivering", 0) + 1
    try:
        yield
    finally:
        _captures.delivering -= 1


def is_delivering() -> bool:
    return bool(getattr(_captures, "delivering", 0))


def loads_delivered(data) -> Any:
    """``pickle.loads`` of a message from the driver."""
    with delivering():
        return pickle.loads(data)


def _rebuild_ref(object_id: str) -> "ObjectRef":
    tracker = _tracker
    if tracker is None:
        return ObjectRef(object_id)
    return tracker.adopt(object_id)


class ObjectRef:
    """A future of the driver's core: ``get(ref)`` resolves it. It
    travels by id (see the module docstring)."""

    __slots__ = ("object_id", "__weakref__")

    def __init__(self, object_id: str):
        self.object_id = object_id

    def hex(self) -> str:
        return self.object_id

    def __reduce__(self):
        stack = getattr(_captures, "stack", None)
        if stack:
            stack[-1].append(self.object_id)
        return _rebuild_ref, (self.object_id,)

    def __hash__(self) -> int:
        return hash(self.object_id)

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, ObjectRef)
                and other.object_id == self.object_id)

    def __repr__(self) -> str:
        return f"ObjectRef({self.object_id[:16]})"


def own_device():
    """The device a CUDA tensor arriving in this process goes to."""
    import torch

    c = ctx.current()
    if c is not None and c.card is not None:
        return torch.device("cuda", c.card)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def _from_host(arr, dtype: str):
    """A CUDA tensor's host copy, put on this process's own device."""
    return procs._tensor_from_numpy(arr, dtype).to(own_device())


class Pickler(procs._TensorPickler):
    """``procs._TensorPickler`` (CPU tensors as numpy views) that also
    sends a CUDA tensor (no grad) as its host copy."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and type(obj) is torch.Tensor
                and not obj.requires_grad and _on_card(obj)):
            t = obj.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                return _from_host, (t.view(torch.int16).numpy(), "bfloat16")
            return _from_host, (t.numpy(), "")
        return super().reducer_override(obj)


def dumps(obj: Any, buffers: Optional[List[pickle.PickleBuffer]] = None
          ) -> bytes:
    """``obj`` by these rules; with ``buffers``, arrays' and CPU tensors'
    bytes go there, out of band."""
    f = io.BytesIO()
    Pickler(f, protocol=5,
            buffer_callback=None if buffers is None
            else buffers.append).dump(obj)
    return f.getvalue()


def loads(data, buffers=None) -> Any:
    return pickle.loads(data, buffers=buffers)


def spill_if_large(path: str, obj: Any) -> Any:
    """``obj`` itself where it pickles to fewer than ``SPILL_BYTES`` (the
    pipe carries it), else a ``procs.Spilled`` file of it at ``path``,
    its buffers out of band; pickled once either way. The refs in a file
    count for the capture around the call; those of an ``obj`` returned
    as it is count when it is pickled again."""
    bufs: List[pickle.PickleBuffer] = []
    with capture() as found:
        meta = dumps(obj, bufs)
    raws = [b.raw() for b in bufs]
    if len(meta) + sum(r.nbytes for r in raws) < SPILL_BYTES:
        return obj
    _captured(found)
    return procs.Spilled(path, None, _parts=(meta, raws))
