"""Decoder-only transformer in PyTorch: the GPT-2 family (LayerNorm / GELU /
learned positions) and the Llama family (RMSNorm / SwiGLU / RoPE / GQA),
selected by config.

Counterpart of the JAX package's ``models/transformer.py``, with the same
parameter names, shapes and numerics, so weights carry across unchanged
(``ray_tpu_torch/convert.py``):

- params are a plain dict of tensors, layers stacked [L, ...];
- the layer stack is a Python loop over the stacked weights (the JAX
  package scans);
- activations in ``cfg.dtype``, every weight cast to it at use (``_w``);
  norms, RoPE and logits in f32.

Loss, remat and the MoE layer are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.attention import attention
from .quantize import maybe_dequant

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # None => MHA
    d_ff: Optional[int] = None  # None => 4*d_model (gelu) or 8/3*d_model (swiglu)
    max_seq_len: int = 2048
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | gelu
    positional: str = "rope"  # rope | learned
    rope_theta: float = 500000.0
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # Training-side fields kept as plain data for config parity; the
    # training slice of the port reads them.
    remat: bool = False
    remat_policy: str = "dots"
    moe_num_experts: int = 0
    moe_experts_per_token: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    fused_ce: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.activation == "swiglu":
            # Llama sizing: 2/3 * 4d rounded to a multiple of 128.
            d = int(8 * self.d_model / 3)
            return (d + 127) // 128 * 128
        return 4 * self.d_model

    def num_params(self) -> int:
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        h = self.head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.kv_heads * h) + (self.n_heads * h) * d
        if self.moe_num_experts:
            mlp = self.moe_num_experts * 3 * d * self.ff_dim + d * self.moe_num_experts
        elif self.activation == "swiglu":
            mlp = 3 * d * self.ff_dim
        else:
            mlp = 2 * d * self.ff_dim
        norms = 2 * d * L + d
        if self.norm == "layernorm":
            norms *= 2  # biases alongside scales
        emb = V * d * (1 if self.tie_embeddings else 2)
        pos = 0 if self.positional == "rope" else self.max_seq_len * d
        return L * (attn + mlp) + norms + emb + pos

    def num_active_params(self) -> int:
        """Params touched per token (MoE: only experts_per_token of E)."""
        if not self.moe_num_experts:
            return self.num_params()
        d, L, F_ = self.d_model, self.n_layers, self.ff_dim
        full_mlp = self.moe_num_experts * 3 * d * F_
        active_mlp = self.moe_experts_per_token * 3 * d * F_
        return self.num_params() - L * (full_mlp - active_mlp)

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Forward+backward FLOPs/token ~ 6*N_active + 12*L*S*d (attn)."""
        S = seq_len or self.max_seq_len
        return (6.0 * self.num_active_params()
                + 12.0 * self.n_layers * S * self.d_model)


def _require_dense(cfg: TransformerConfig) -> None:
    if cfg.moe_num_experts:
        raise NotImplementedError(
            "the MoE layer is not ported to PyTorch yet (ROADMAP queue A)")


# name -> (shape, init) where init is "ones", "zeros" or a normal std.
def param_spec(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's names, shapes and initial scales, the same as
    the JAX ``init_params``: ``{"embed": (shape, init), ..., "layers":
    {name: (shape, init)}}`` with layer shapes stacked [L, ...]."""
    _require_dense(cfg)
    d, L, V, F_ = cfg.d_model, cfg.n_layers, cfg.vocab_size, cfg.ff_dim
    H, KVH, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    fan_in = 1.0 / math.sqrt(d)
    layers: Dict[str, Any] = {
        "attn_norm": ((L, d), "ones"),
        "wo": ((L, H * hd, d), 1.0 / math.sqrt(2 * L * H * hd)),
        "mlp_norm": ((L, d), "ones"),
        "w_down": ((L, F_, d), 1.0 / math.sqrt(2 * L * F_)),
    }
    if KVH == H:
        layers["wqkv"] = ((L, d, 3, H, hd), fan_in)
    else:
        layers["wq"] = ((L, d, H, hd), fan_in)
        layers["wkv"] = ((L, d, 2, KVH, hd), fan_in)
    if cfg.activation == "swiglu":
        layers["w_gate_up"] = ((L, d, 2, F_), fan_in)
    else:
        layers["w_up"] = ((L, d, F_), fan_in)
    if cfg.norm == "layernorm":
        layers["attn_norm_b"] = ((L, d), "zeros")
        layers["mlp_norm_b"] = ((L, d), "zeros")
    spec: Dict[str, Any] = {
        "embed": ((V, d), 0.02),
        "final_norm": ((d,), "ones"),
        "layers": layers,
    }
    if cfg.norm == "layernorm":
        spec["final_norm_b"] = ((d,), "zeros")
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, V), 0.02)
    if cfg.positional == "learned":
        spec["pos_embed"] = ((cfg.max_seq_len, d), 0.02)
    return spec


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random parameters with the JAX ``init_params`` structure and scales,
    made directly in ``cfg.param_dtype`` on ``device`` (no f32 staging
    copy). ``generator`` must live on ``device``."""
    device = resolve_device(device)

    def make(shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=cfg.param_dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=cfg.param_dtype, device=device)
        t = torch.randn(shape, generator=generator, dtype=cfg.param_dtype,
                        device=device)
        return t.mul_(init)

    spec = param_spec(cfg)
    params: Params = {k: make(*v) for k, v in spec.items() if k != "layers"}
    params["layers"] = {k: make(*v) for k, v in spec["layers"].items()}
    return params


def iter_layers(params: Params) -> Iterator[Params]:
    """One dict of per-layer views per layer of the stacked weights."""
    stacked = params["layers"]
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        yield {k: w[i] for k, w in stacked.items()}


def _norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        x2 = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(x2 + 1e-6) * w.float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * w.float()
        if b is not None:
            out = out + b.float()
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding (half-split layout) over the last dim of
    [B, S, H, D]; angles in f32."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[:, :, None].float() * freqs[None, None, :]  # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _w(layer: Params, name: str, cfg: TransformerConfig) -> torch.Tensor:
    """Weight access for the layer helpers: compute-dtype view,
    dequantizing int8 weight-only params when a scale sibling is present."""
    return maybe_dequant(layer, name, cfg.dtype)


def _qkv_proj(cfg: TransformerConfig, h: torch.Tensor, layer: Params,
              positions: torch.Tensor):
    """Projection + rope shared by the forward and KV-cache decode."""
    if "wqkv" in layer:
        qkv = torch.einsum("bsd,dcnh->bscnh", h, _w(layer, "wqkv", cfg))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.einsum("bsd,dnh->bsnh", h, _w(layer, "wq", cfg))
        kv = torch.einsum("bsd,dcnh->bscnh", h, _w(layer, "wkv", cfg))
        k, v = kv[:, :, 0], kv[:, :, 1]
    if cfg.positional == "rope":
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp_block(cfg: TransformerConfig, h: torch.Tensor,
               layer: Params) -> torch.Tensor:
    """Post-attention FFN (swiglu / tanh-gelu), shared with decode."""
    _require_dense(cfg)
    if cfg.activation == "swiglu":
        gu = torch.einsum("bsd,dcf->bscf", h, _w(layer, "w_gate_up", cfg))
        act = F.silu(gu[:, :, 0]) * gu[:, :, 1]
        return act @ _w(layer, "w_down", cfg)
    act = F.gelu(h @ _w(layer, "w_up", cfg), approximate="tanh")
    return act @ _w(layer, "w_down", cfg)


def _layer_body(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                positions: torch.Tensor, return_kv: bool = False):
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = _norm(x, layer["attn_norm"], layer.get("attn_norm_b"), cfg.norm)
    q, k, v = _qkv_proj(cfg, h, layer, positions)
    o = attention(q, k, v, causal=True)
    x = x + o.reshape(B, S, H * hd) @ _w(layer, "wo", cfg)
    h = _norm(x, layer["mlp_norm"], layer.get("mlp_norm_b"), cfg.norm)
    x = x + _mlp_block(cfg, h, layer)
    if return_kv:
        return x, k, v
    return x


def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """tokens [B, S] -> embeddings [B, S, d] (cfg.dtype). Gathers the rows
    before the cast, so a wide table is never copied whole."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.positional == "learned":
        x = x + params["pos_embed"][:S].to(cfg.dtype)[None]
    return x


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def backbone_with_aux(params: Params, tokens: torch.Tensor,
                      cfg: TransformerConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens -> hidden [B, S, d] and the MoE aux loss (0 for dense)."""
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = _positions(B, S, tokens.device)
    for layer in iter_layers(params):
        x = _layer_body(cfg, x, layer, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def final_hidden_and_head(params: Params, x: torch.Tensor,
                          cfg: TransformerConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final norm + the head weight (tied: ``embed.T``) in cfg.dtype."""
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), cfg.norm)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x, head.to(cfg.dtype)


def lm_head(params: Params, x: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Final norm + output projection: hidden [B,S,d] -> logits f32."""
    x, head = final_hidden_and_head(params, x, cfg)
    return (x @ head).float()


def forward_with_aux(params: Params, tokens: torch.Tensor,
                     cfg: TransformerConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    x, aux = backbone_with_aux(params, tokens, cfg)
    return lm_head(params, x, cfg), aux


def forward(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens [B, S] integer -> logits [B, S, V] (f32)."""
    return forward_with_aux(params, tokens, cfg)[0]
