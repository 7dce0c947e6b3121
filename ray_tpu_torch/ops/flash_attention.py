"""Flash attention: hand-written Hopper kernels and their plain versions.

The counterpart of the JAX package's Pallas kernels
(``ray_tpu/ops/flash_attention.py``): the forward ``_fwd_kernel`` (K1, in
``csrc/flash_fwd.cu``) and the backward ``_dq_kernel`` (K2) and
``_dkv_kernel`` (K3, both in ``csrc/flash_bwd.cu``). Each is CUDA C++ built
for ``sm_90a`` at first use; design and bound are in each source's header.

- :func:`flash_attention_fwd`, :func:`flash_bwd_dq` and
  :func:`flash_bwd_dkv` are the wrappers: for CUDA tensors they launch
  their kernel or raise, for CPU tensors they run the plain version. Each
  counts its launches in ``<wrapper>.launches``.
- ``*_plain`` are the same functions in plain PyTorch, in f32, with the
  same masks.
- :func:`flash_bwd_core` is the backward given the row statistics lse and
  delta from outside (ring attention passes global ones through it).
- :func:`flash_attention` is the public, differentiable entry in model
  layout [B, S, H, D]: a ``torch.autograd.Function`` whose forward is K1
  and whose backward is K2 and K3, as the JAX ``custom_vjp``.

All functions take the model layout [B, S, H, D] / [B, S, KVH, D]; lse and
delta are [B, H, S, 1] f32 (the layout of the JAX ``_flash_fwd``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_LIB_NAME = "rtpu_flash"
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
    """K1, K2 and K3 in one library, built (one nvcc per source, at once)
    and loaded at first use."""
    from ._build import load_library

    lib = load_library(_LIB_NAME, ["flash_fwd.cu", "flash_bwd.cu"])
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    for fn, n_ptr, n_strides in ((lib.rtpu_flash_fwd_bf16, 5, 12),
                                 (lib.rtpu_flash_bwd_dq_bf16, 7, 15),
                                 (lib.rtpu_flash_bwd_dkv_bf16, 8, 18)):
        if fn.argtypes is None:
            fn.argtypes = ([vp] * n_ptr + [i] * 5 + [ll] * n_strides
                           + [ctypes.c_float, i, vp])
            fn.restype = i
    return lib


def build() -> None:
    """Build and load K1, K2 and K3 now (otherwise done at first launch)."""
    _kernel_library()


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    # The kernels read rows of D contiguous bf16 through TMA, which takes a
    # 16-byte aligned base and strides.
    if (x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1])
            or x.data_ptr() % 16):
        x = x.contiguous()
    return x


def _stat_operand(x: torch.Tensor) -> torch.Tensor:
    # lse/delta [B, H, S, 1] f32 as one contiguous run; K3 reads it through
    # a 1-D TMA map, which takes a 16-byte aligned base.
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B,S,H,D], lse [B,H,S,1] f32). CUDA tensors launch the Hopper
    kernel (bf16, D in 32/64/128; q/k/v read through TMA tensor maps built
    from their strides, so views of a fused projection are not copied) or
    raise; CPU tensors take the plain version."""
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
    lse = torch.empty((B, H, S, 1), dtype=torch.float32, device=q.device)
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
    return o, lse


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------- backward


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check_shapes(q, k, v)
    B, S, H, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (B, H, S, 1):
            raise ValueError(f"{name} must be [B, H, S, 1] = "
                             f"{(B, H, S, 1)}, got {tuple(x.shape)}")


def _plain_p_ds(q, k, v, do, lse, delta, scale, causal):
    """p = exp(scale q k^T + mask - lse) and ds = p (do v^T - delta) scale,
    in f32 [B, H, S, S], with q/do/k (k broadcast over the GQA group) in
    f32 [B, H, S, D]."""
    S, H = q.shape[1], q.shape[2]
    group = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    dof = do.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.exp(s - lse.float())
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.float()) * scale
    return qf, dof, kf, p, ds


def _sum_group(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, H, S, D] per query head -> [B, S, KVH, D] summed over groups."""
    B, H, S, D = x.shape
    return x.reshape(B, kvh, H // kvh, S, D).sum(dim=2).transpose(1, 2)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float,
                       causal: bool) -> torch.Tensor:
    """Plain PyTorch version of K2: dq [B,S,H,D] in q.dtype, f32 inside."""
    _check_bwd(q, k, v, do, lse, delta)
    _, _, kf, _, ds = _plain_p_ds(q, k, v, do, lse, delta, scale, causal)
    return torch.matmul(ds, kf).transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: (dk, dv) [B,S,KVH,D], f32 inside,
    summed over each kv head's group of query heads."""
    _check_bwd(q, k, v, do, lse, delta)
    qf, dof, _, p, ds = _plain_p_ds(q, k, v, do, lse, delta, scale, causal)
    kvh = k.shape[2]
    dk = _sum_group(torch.matmul(ds.transpose(-1, -2), qf), kvh)
    dv = _sum_group(torch.matmul(p.transpose(-1, -2), dof), kvh)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, do, lse, delta, scale: float,
                              causal: bool):
    """Plain PyTorch version of the whole backward: (dq, dk, dv)."""
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


def _bwd_on_kernel(name, q, k, v, do, lse, delta) -> bool:
    """True for CUDA tensors the kernels take, False for CPU tensors (the
    plain version); raises for anything else."""
    _check_bwd(q, k, v, do, lse, delta)
    devices = {x.device for x in (q, k, v, do, lse, delta)}
    if len(devices) != 1:
        raise ValueError(f"{name}: all inputs must be on one device, got "
                         f"{sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if not (q.dtype == k.dtype == v.dtype == do.dtype == torch.bfloat16):
        raise TypeError(f"{name} takes bfloat16 q/k/v/do, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}/{do.dtype}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 lse/delta, got {lse.dtype}/"
                        f"{delta.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name} supports head_dim in "
                         f"{SUPPORTED_HEAD_DIMS}, got {q.shape[-1]}")
    return True


def _raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float,
                 causal: bool) -> torch.Tensor:
    """dq [B,S,H,D]. CUDA tensors launch K2 (bf16, D in 32/64/128) or
    raise; CPU tensors take the plain version."""
    if not _bwd_on_kernel("flash_bwd_dq", q, k, v, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    B, S, H, D = q.shape
    q, k, v, do = map(_kernel_operand, (q, k, v, do))
    lse, delta = _stat_operand(lse), _stat_operand(delta)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtpu_flash_bwd_dq_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, S, H, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *dq.stride()[:3],
            float(scale), int(bool(causal)), stream)
    _raise_on_error(err, "flash backward dq")
    with _count_lock:
        flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,S,KVH,D]. CUDA tensors launch K3 (bf16, D in 32/64/128)
    or raise; CPU tensors take the plain version."""
    if not _bwd_on_kernel("flash_bwd_dkv", q, k, v, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    B, S, H, D = q.shape
    KVH = k.shape[2]
    q, k, v, do = map(_kernel_operand, (q, k, v, do))
    lse, delta = _stat_operand(lse), _stat_operand(delta)
    dk = torch.empty((B, S, KVH, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, KVH, D), dtype=v.dtype, device=q.device)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtpu_flash_bwd_dkv_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, KVH, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            float(scale), int(bool(causal)), stream)
    _raise_on_error(err, "flash backward dk/dv")
    with _count_lock:
        flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_core(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """The backward given externally supplied row statistics (JAX
    ``flash_bwd_core``): lse/delta [B,H,S,1] may come from a global softmax,
    since p is recomputed as exp(s - lse). Returns (dq, dk, dv)."""
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in f32, [B,S,H,D] -> [B,H,S,1] (the JAX
    ``_flash_bwd``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).unsqueeze(-1)


# ---------------------------------------------------------------- public

# K1 as an operator the dispatcher sees: a selective-checkpoint policy
# (models/transformer.py) can then save its outputs instead of launching
# it again in the backward. A ctypes call alone is invisible to it.
@torch.library.custom_op(
    "ray_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float scale, bool causal)"
           " -> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, scale, causal):
    return flash_attention_fwd(q, k, v, scale, causal)


_FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


class _FlashAttention(torch.autograd.Function):
    """Forward K1, saving q, k, v, o and lse; backward K2 and K3 (the JAX
    ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = _FLASH_FWD_OP(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        do = g.to(q.dtype)
        dq, dk, dv = flash_bwd_core(q, k, v, do, lse, attention_delta(do, o),
                                    scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention in model layout [B, S, H, D]."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal))
