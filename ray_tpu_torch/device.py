"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device (the
CPU tests pass ``device="cpu"``). When no device is given and CUDA is not
present they raise: they never fall back to the CPU on their own.
"""
from __future__ import annotations

import os
from typing import Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def _rank_card() -> int:
    """This process's card: ``LOCAL_RANK`` (as a launcher sets it) once a
    process group is up, else the current device."""
    if dist.is_available() and dist.is_initialized() and (
            "LOCAL_RANK" in os.environ):
        return int(os.environ["LOCAL_RANK"])
    return torch.cuda.current_device()


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", _rank_card())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _rank_card())
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    return resolve_device(a) == resolve_device(b)
