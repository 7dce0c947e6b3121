"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

The counterpart of the JAX package's Pallas forward
(``ray_tpu/ops/flash_attention.py``: ``_fwd_kernel`` launched by
``_flash_fwd``). The kernel is CUDA C++ in ``csrc/flash_fwd.cu`` (design
and bound in its header note), built for ``sm_90a`` at first use.

- :func:`flash_attention_fwd` is the wrapper: for CUDA tensors it launches
  the kernel or raises, for CPU tensors it runs the plain version. It
  counts its launches in ``flash_attention_fwd.launches``.
- :func:`flash_attention_fwd_plain` is the same function in plain PyTorch,
  computed in f32 with the same masking and ``l == 0`` guard.
- :func:`flash_attention` is the public entry in model layout [B, S, H, D].

All functions take the model layout [B, S, H, D] / [B, S, KVH, D] and
return ``o`` in q's layout and dtype and ``lse`` as [B, H, S, 1] f32 (the
layout of the JAX ``_flash_fwd``). The backward kernels of the JAX package
are not ported yet.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_LIB_NAME = "rtpu_flash_fwd"
# Engines prefill on their callers' threads: the launch count is shared.
_count_lock = threading.Lock()


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,S,H,D], k/v [B,S,KVH,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"heads {H} not divisible by kv_heads {k.shape[2]}")


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: f32 softmax over the whole row,
    mask constant -1e30, ``o = 0`` for a row with ``l == 0``.
    Returns (o [B,S,H,D] in q.dtype, lse [B,H,S,1] f32)."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    group = H // k.shape[2]
    qf = q.float().transpose(1, 2)                                # [B,H,S,D]
    # GQA: query head h reads kv head h // group (repeat_interleave).
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale            # [B,H,S,S]
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p, vf) / l_safe
    lse = m + torch.log(l_safe)
    return o.transpose(1, 2).to(q.dtype), lse


def _kernel_library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library(_LIB_NAME, ["flash_fwd.cu"])
    fn = lib.rtpu_flash_fwd_bf16
    if fn.argtypes is None:
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = ([vp] * 5 + [ctypes.c_int] * 5 + [ll] * 12
                       + [ctypes.c_float, ctypes.c_int, vp])
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel now (otherwise done at the first launch)."""
    _kernel_library()


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    # The kernel reads rows of D contiguous bf16 with 16-byte loads.
    if (x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1])
            or x.data_ptr() % 16):
        x = x.contiguous()
    return x


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B,S,H,D], lse [B,H,S,1] f32). CUDA tensors launch the Hopper
    kernel (bf16, D in 32/64/128) or raise; CPU tensors take the plain
    version."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        if k.device.type != "cpu" or v.device.type != "cpu":
            raise ValueError("q, k and v must be on one device")
        return flash_attention_fwd_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device "
                         f"{q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the flash kernel takes bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the flash kernel supports head_dim in "
                         f"{SUPPORTED_HEAD_DIMS}, got {D}")
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtpu_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, KVH, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash forward kernel launch failed: "
                           f"cudaError {err}")
    with _count_lock:
        flash_attention_fwd.launches += 1
    return o, lse.unsqueeze(-1)


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention in model layout [B, S, H, D] -> o [B, S, H, D]."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    o, _ = flash_attention_fwd(q, k, v, scale, causal)
    return o
