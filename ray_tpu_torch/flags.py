"""Registry of the ``RTPU_*`` environment flags the PyTorch port reads.

The same contract as the JAX package's flag registry: every flag is defined
once with its type, default and documentation, and read through :func:`get`
at call time (environment over default), so a flag set by a test or a
parent process is honoured. Only the flags the port's modules read are
defined here; the port keeps its own copy and imports nothing of the JAX
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterator, Mapping


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    type: type
    default: Any
    doc: str


REGISTRY: Dict[str, Flag] = {}


def _define(name: str, type_: type, default: Any, doc: str) -> None:
    REGISTRY[name] = Flag(name, type_, default, doc)


_define("RTPU_ATTN_IMPL", str, "auto",
        "Attention implementation: auto (the hand-written flash kernel for "
        "CUDA tensors, the plain reference attention on the CPU) | flash "
        "(flash_attention: the kernel on CUDA, its plain version on the "
        "CPU) | xla (the plain reference attention everywhere; the name is "
        "kept from the JAX package).")
_define("RTPU_SP_MODE", str, "ring",
        "Context-parallel attention scheme over the seq mesh axis: "
        "ring | ulysses | auto (ulysses when head counts divide the axis).")


def get(name: str) -> Any:
    """Read a registered flag from the environment (call-time), else its
    registered default."""
    f = REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return f.default
    if f.type is bool:
        return raw.strip().lower() not in ("0", "", "false", "no")
    if f.type in (int, float):
        return f.type(raw)
    return raw


@contextlib.contextmanager
def scoped(env: Mapping[str, str]) -> Iterator[None]:
    """Set environment flags (``{"RTPU_SP_MODE": "ulysses"}``) for a
    block, restoring their earlier values (or absence) after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
