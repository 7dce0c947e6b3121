"""Build-at-first-use for the port's hand-written CUDA kernels.

Each kernel source under ``ops/csrc/`` exposes a plain C function (no
PyTorch headers, so `nvcc` takes seconds, not minutes). It is compiled for
Hopper (``sm_90a``) with ``nvcc -shared`` into
``ray_tpu_torch/_build/<name>/<name>-<hash>.so`` the first time a wrapper
needs it and loaded with ``ctypes``; the wrapper passes raw device pointers,
strides and PyTorch's current stream. The file name carries a hash of the
sources and flags, so a later process reuses the build and an edited source
builds anew. Nothing here runs at import time: the CPU tests import every
module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-O3", "-std=c++17", ARCH_FLAG)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc "
                           "on PATH): cannot build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(name: str, sources: Sequence[Path]) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        digest.update(s.read_bytes())
    build_dir = BUILD_ROOT / name
    out = build_dir / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    # Build under a per-process name, then rename: a process that races
    # this one never loads a half-written library.
    tmp = build_dir / f".{out.name}.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), *[str(s) for s in sources]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library ``name``
    from ``csrc/<source>`` files; later calls return the loaded library."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _build(name, [CSRC / s for s in sources])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
