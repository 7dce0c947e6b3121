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
- :class:`ObjectRef` stays in the driver: in this slice a ref (and an
  actor handle, ``core/api.py``) refuses to pickle, so passing one to
  another process raises ``TypeError`` where it is sent.
"""
from __future__ import annotations

import io
import pickle
import sys
from typing import Any, List, Optional

from ..util import procs
from . import context as ctx

# Results and arguments that pickle to this many bytes or more travel as
# files (``procs.Spilled``); smaller ones through the pipe.
SPILL_BYTES = 1 << 20

HANDLES_STAY = (
    "handles and refs stay in the driver in this slice of the port: "
    "passing an ObjectRef or an ActorHandle to another process, and "
    "submitting a task from a task, wait for the next slice")


class ObjectRef:
    """A future of the driver's core: ``get(ref)`` resolves it. It never
    leaves the driver (see the module docstring)."""

    __slots__ = ("object_id", "__weakref__")

    def __init__(self, object_id: str):
        self.object_id = object_id

    def hex(self) -> str:
        return self.object_id

    def __reduce__(self):
        raise TypeError(f"{self!r} cannot be sent to another process: "
                        f"{HANDLES_STAY}")

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
    its buffers out of band; pickled once either way."""
    bufs: List[pickle.PickleBuffer] = []
    meta = dumps(obj, bufs)
    raws = [b.raw() for b in bufs]
    if len(meta) + sum(r.nbytes for r in raws) < SPILL_BYTES:
        return obj
    return procs.Spilled(path, None, _parts=(meta, raws))
