"""Vision Transformer encoder (counterpart of the JAX package's
``models/vit.py``): ViT-L/16 batch inference, BASELINE config 5.

- Patch embedding is a reshape and one product ([B, N, p*p*C] @ [p*p*C,
  d]), flattened in (p, p, C) order as the reference's im2col.
- Encoder blocks are pre-LN MHA and a tanh-GELU MLP over ``cfg.dtype``
  activations with ``cfg.param_dtype`` params, the layers stacked [L, ...]
  and run as a loop over per-layer views (the reference's ``lax.scan``).
  Attention goes through ``ops.attention.attention(causal=False)``: on a
  CUDA tensor that is K1 without a mask.
- LayerNorm has eps 1e-6 and a biased variance in f32, its result cast
  back to the activations' dtype. The CLS head is f32, both operands.
- Weights are read through ``quantize.maybe_dequant``, so int8 weights
  (``quantize_params_int8``) work as for the decoder.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.attention import attention
from .quantize import maybe_dequant
from .transformer import iter_layers

Params = Dict[str, Any]

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 1024       # ViT-L
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3

    def num_params(self) -> int:
        d, L, F_ = self.d_model, self.n_layers, self.d_ff
        per_layer = 4 * d * d + 2 * d * F_ + 4 * d
        return (self.patch_dim * d + d + (self.num_patches + 1) * d + d
                + L * per_layer + 2 * d + d * self.num_classes
                + self.num_classes)


def vit_l16(**overrides) -> ViTConfig:
    return ViTConfig(**overrides)


def vit_tiny(**overrides) -> ViTConfig:
    kw = dict(image_size=32, patch_size=8, num_classes=10, d_model=64,
              n_layers=2, n_heads=4, d_ff=128)
    kw.update(overrides)
    return ViTConfig(**kw)


def param_spec(cfg: ViTConfig) -> Params:
    """Names, shapes and initial scales of the reference's ``init_params``
    tree: ``{name: (shape, init)}``, layer leaves stacked [L, ...]."""
    d, L, F_ = cfg.d_model, cfg.n_layers, cfg.d_ff
    H = cfg.n_heads
    return {
        "patch_embed": ((cfg.patch_dim, d), 1.0 / math.sqrt(cfg.patch_dim)),
        "patch_bias": ((d,), "zeros"),
        "pos_embed": ((cfg.num_patches + 1, d), 0.02),
        "cls_token": ((d,), "zeros"),
        "layers": {
            "ln1": ((L, d), "ones"),
            "ln1_b": ((L, d), "zeros"),
            "wqkv": ((L, d, 3, H, d // H), 1.0 / math.sqrt(d)),
            "wo": ((L, d, d), 1.0 / math.sqrt(2 * L * d)),
            "ln2": ((L, d), "ones"),
            "ln2_b": ((L, d), "zeros"),
            "w_up": ((L, d, F_), 1.0 / math.sqrt(d)),
            "w_down": ((L, F_, d), 1.0 / math.sqrt(2 * L * F_)),
        },
        "final_ln": ((d,), "ones"),
        "final_ln_b": ((d,), "zeros"),
        "head": ((d, cfg.num_classes), 0.02),
        "head_b": ((cfg.num_classes,), "zeros"),
    }


def init_params(generator: torch.Generator, cfg: ViTConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters with the reference's structure and scales, made in
    ``cfg.param_dtype`` on ``device`` (the card unless the caller asks
    for the CPU). ``generator`` must live on ``device``."""
    device = resolve_device(device)

    def make(shape, init):
        if init in ("ones", "zeros"):
            fill = torch.ones if init == "ones" else torch.zeros
            return fill(shape, dtype=cfg.param_dtype, device=device)
        t = torch.randn(shape, generator=generator, dtype=cfg.param_dtype,
                        device=device)
        return t.mul_(init)

    spec = param_spec(cfg)
    params: Params = {k: make(*v) for k, v in spec.items() if k != "layers"}
    params["layers"] = {k: make(*v) for k, v in spec["layers"].items()}
    return params


def param_logical_specs(cfg: ViTConfig) -> Params:
    return {
        "patch_embed": (None, "embed"),
        "patch_bias": (None,),
        "pos_embed": (None, "embed"),
        "cls_token": (None,),
        "layers": {
            "ln1": ("layers", None),
            "ln1_b": ("layers", None),
            "wqkv": ("layers", "embed", None, "heads", None),
            "wo": ("layers", "heads", "embed"),
            "ln2": ("layers", None),
            "ln2_b": ("layers", None),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_ln": (None,),
        "final_ln_b": (None,),
        "head": ("embed", "vocab"),
        "head_b": (None,),
    }


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + LN_EPS)
    return (out * w.float() + b.float()).to(x.dtype)


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, p*p*C] (reshape and permute only)."""
    B, H, W, C = images.shape
    p = cfg.patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, Hp, Wp, p, p, C]
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def forward(params: Params, images: Any, cfg: ViTConfig) -> torch.Tensor:
    """images [B, H, W, C] (a tensor or numpy array; moved to the params'
    device) -> logits [B, num_classes] f32. Differentiable, as the
    reference; batch inference runs it under ``torch.inference_mode()``."""
    device = params["patch_embed"].device
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.asarray(images))
    dt = cfg.dtype
    B = images.shape[0]
    H = cfg.n_heads
    hd = cfg.d_model // H
    x = patchify(images.to(device, dt), cfg)
    x = x @ params["patch_embed"].to(dt)
    x = x + params["patch_bias"].to(dt)
    cls = params["cls_token"].to(dt).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dt)[None]
    S = x.shape[1]
    for layer in iter_layers(params):
        y = _ln(x, layer["ln1"], layer["ln1_b"])
        wqkv = maybe_dequant(layer, "wqkv", dt)
        # One [d, 3*H*hd] product; q, k and v are strided views of it.
        qkv = (y @ wqkv.reshape(cfg.d_model, -1)).view(B, S, 3, H, hd)
        o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                      causal=False)
        x = x + o.reshape(B, S, H * hd) @ maybe_dequant(layer, "wo", dt)
        y = _ln(x, layer["ln2"], layer["ln2_b"])
        y = F.gelu(y @ maybe_dequant(layer, "w_up", dt), approximate="tanh")
        x = x + y @ maybe_dequant(layer, "w_down", dt)
    cls_out = _ln(x[:, 0], params["final_ln"], params["final_ln_b"])
    return (cls_out.float() @ params["head"].float()
            + params["head_b"].float())
