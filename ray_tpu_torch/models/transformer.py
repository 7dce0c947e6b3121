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
  norms, RoPE and logits in f32;
- remat is non-reentrant ``torch.utils.checkpoint`` around each layer, one
  way for each JAX ``jax.checkpoint`` policy (``layer_scan_body``): "full"
  is plain checkpointing, "dots"/"dots_attn" replay the projection outputs
  saved in the forward (``_SavedDots``), "min" is a selective-checkpoint
  policy, and "half_*" checkpoints half the stack;
- the loss (``loss_fn``) in both token conventions, unfused or through the
  chunked fused lm-head + CE (``ops/fused_ce.py``).
- on a mesh (a training step's sharding context, ``parallel/sharding.py``)
  params and activations are DTensors, and ``maybe_constrain`` redistributes
  the activations where the JAX model constrains them.

The MoE layer is not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device
from ..ops.attention import attention
from ..ops.fused_ce import fused_next_token_loss
from ..parallel.sharding import (current_sharding_ctx, gather_for_use,
                                 maybe_constrain, replicated_like,
                                 sharding_ctx)
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


def init_leaves(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None
                ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """The random parameters one at a time, as (path, tensor) with path
    ``(name,)`` or ``("layers", name)``, in the order :func:`init_params`
    draws them from ``generator``. A sharded trainer distributes each leaf
    before the next is made, so no device holds the whole model."""
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
    for k, v in spec.items():
        if k != "layers":
            yield (k,), make(*v)
    for k, v in spec["layers"].items():
        yield ("layers", k), make(*v)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random parameters with the JAX ``init_params`` structure and scales,
    made directly in ``cfg.param_dtype`` on ``device`` (no f32 staging
    copy). ``generator`` must live on ``device``."""
    params: Params = {"layers": {}}
    for path, t in init_leaves(cfg, generator, device):
        (params["layers"] if path[0] == "layers" else params)[path[-1]] = t
    return params


def param_logical_specs(cfg: TransformerConfig) -> Params:
    """Tree of logical axis names matching init_params' structure (consumed
    by parallel.sharding.tree_shardings): the JAX package's
    ``param_logical_specs``."""
    _require_dense(cfg)
    # The leading dim is the layer stack: logical axis "layers" maps onto
    # the `pipe` mesh axis.
    layers = {
        "attn_norm": ("layers", None),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", None),
        "w_down": ("layers", "mlp", "embed"),
    }
    if cfg.kv_heads == cfg.n_heads:
        layers["wqkv"] = ("layers", "embed", None, "heads", None)
    else:
        layers["wq"] = ("layers", "embed", "heads", None)
        layers["wkv"] = ("layers", "embed", None, "kv_heads", None)
    if cfg.activation == "swiglu":
        layers["w_gate_up"] = ("layers", "embed", None, "mlp")
    else:
        layers["w_up"] = ("layers", "embed", "mlp")
    if cfg.norm == "layernorm":
        layers["attn_norm_b"] = ("layers", None)
        layers["mlp_norm_b"] = ("layers", None)
    specs: Params = {
        "embed": ("vocab", "embed"),
        "final_norm": (None,),
        "layers": layers,
    }
    if cfg.norm == "layernorm":
        specs["final_norm_b"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    if cfg.positional == "learned":
        specs["pos_embed"] = (None, "embed")
    return specs


def iter_layers(params: Params) -> Iterator[Params]:
    """One dict of per-layer views per layer of the stacked weights.

    The views come from ``unbind``: its backward stacks the L layer
    gradients once. Indexing ``w[i]`` would scatter each layer's gradient
    into a zero [L, ...] tensor and add it, L times over."""
    unbound = {k: w.unbind(0) for k, w in params["layers"].items()}
    n = len(next(iter(unbound.values())))
    for i in range(n):
        yield {k: ws[i] for k, ws in unbound.items()}


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
    cos = replicated_like(torch.cos(angles)[:, :, None, :], x)
    sin = replicated_like(torch.sin(angles)[:, :, None, :], x)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# What the remat policies read while a layer runs, per thread (engines
# prefill on their callers' threads; autograd recomputes on its own):
# ``name``, the value the ops running now compute (the JAX package's
# ``checkpoint_name``), and ``dots``, the _SavedDots of a "dots" layer.
_remat = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the ops run inside as computing the value ``name``."""
    prev = getattr(_remat, "name", None)
    _remat.name = name
    try:
        yield
    finally:
        _remat.name = prev


class _SavedDots:
    """The projection outputs of one checkpointed layer call under "dots":
    recorded in the forward, handed back in order when the backward
    recomputes the layer, so only the work between products runs again."""

    def __init__(self):
        self.outs = []
        self.replay: Optional[int] = None  # next index while replaying


def _matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    d = h.shape[-1]
    out = h.reshape(-1, d) @ w.reshape(d, -1)
    return out.reshape(*h.shape[:-1], *w.shape[1:])


class _SavedDot(torch.autograd.Function):
    """``_matmul`` whose output comes from a _SavedDots on recompute."""

    @staticmethod
    def forward(ctx, h, w, store):
        ctx.save_for_backward(h, w)
        if store.replay is None:
            out = _matmul(h, w)
            store.outs.append(out.detach())
            return out
        out = store.outs[store.replay]
        store.replay += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        d = h.shape[-1]
        g2 = g.reshape(-1, w[0].numel())
        gh = (g2 @ w.reshape(d, -1).T).reshape(h.shape)
        gw = (h.reshape(-1, d).T @ g2).reshape(w.shape)
        return gh, gw, None


def _sharded_out_dim(w: torch.Tensor) -> Optional[int]:
    """The output dim past the first that a DTensor weight [d, ...] is
    split on (tensor parallelism: the heads of wqkv [d, 3, H, hd]), if
    any."""
    if not isinstance(w, DTensor):
        return None
    dims = {p.dim for p in w.placements if isinstance(p, Shard)} - {0, 1}
    return dims.pop() if dims else None


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A projection of the layer, h [..., d] @ w [d, ...] (a product with
    no batch dimension: what the "dots" policies save)."""
    lead = _sharded_out_dim(w)
    if lead is not None:
        # DTensor keeps a split through the flattening of w's output dims
        # only on the first of them: move the split dim there and back.
        n = h.ndim - 1
        return _proj(h, w.movedim(lead, 1)).movedim(n, n + lead - 1)
    store = getattr(_remat, "dots", None)
    if store is None:
        return _matmul(h, w)
    return _SavedDot.apply(h, w, store)


def _w(layer: Params, name: str, cfg: TransformerConfig) -> torch.Tensor:
    """Weight access for the layer helpers: compute-dtype view,
    dequantizing int8 weight-only params when a scale sibling is present.
    On a mesh the weight is gathered over the batch axes after the cast
    (FSDP's all-gather at use, in the compute dtype)."""
    return gather_for_use(maybe_dequant(layer, name, cfg.dtype))


def _qkv_proj(cfg: TransformerConfig, h: torch.Tensor, layer: Params,
              positions: torch.Tensor):
    """Projection + rope shared by the forward and KV-cache decode."""
    if "wqkv" in layer:
        w = _w(layer, "wqkv", cfg)
        with checkpoint_name("qkv_proj"):
            qkv = _proj(h, w)                                # [B,S,3,H,hd]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = _proj(h, _w(layer, "wq", cfg))                   # [B,S,H,hd]
        w = _w(layer, "wkv", cfg)
        with checkpoint_name("qkv_proj"):
            kv = _proj(h, w)                                 # [B,S,2,KVH,hd]
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
        w = _w(layer, "w_gate_up", cfg)
        with checkpoint_name("gate_up"):
            gu = _proj(h, w)                                 # [B,S,2,F]
        act = F.silu(gu[:, :, 0]) * gu[:, :, 1]
        return _proj(act, _w(layer, "w_down", cfg))
    w = _w(layer, "w_up", cfg)
    with checkpoint_name("gate_up"):
        up = _proj(h, w)
    act = F.gelu(up, approximate="tanh")
    return _proj(act, _w(layer, "w_down", cfg))


def _layer_body(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                positions: torch.Tensor, return_kv: bool = False):
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = _norm(x, layer["attn_norm"], layer.get("attn_norm_b"), cfg.norm)
    q, k, v = _qkv_proj(cfg, h, layer, positions)
    q = maybe_constrain(q, ("batch", "seq_act", "heads", None))
    o = attention(q, k, v, causal=True)
    x = x + _proj(o.reshape(B, S, H * hd), _w(layer, "wo", cfg))
    x = maybe_constrain(x, ("batch", "seq_act", "embed"))
    h = _norm(x, layer["mlp_norm"], layer.get("mlp_norm_b"), cfg.norm)
    x = x + _mlp_block(cfg, h, layer)
    x = maybe_constrain(x, ("batch", "seq_act", "embed"))
    if return_kv:
        return x, k, v
    return x


def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """tokens [B, S] -> embeddings [B, S, d] (cfg.dtype). Gathers the rows
    before the cast, so a wide table is never copied whole. On a mesh the
    table is gathered whole for the lookup, as in the JAX package (a lookup
    in a vocab/embed-sharded table would reshard its output); the sharded
    original still feeds the head, and the backward reduce-scatters the
    lookup's gradient into the table's layout."""
    S = tokens.shape[1]
    tbl = maybe_constrain(params["embed"], (None, None))
    if isinstance(tbl, DTensor):
        # DTensor (torch 2.11) cannot propagate the backward of an indexing
        # lookup (index_put) with batch-sharded indices; that of
        # F.embedding it can.
        x = F.embedding(tokens, tbl).to(cfg.dtype)
    else:
        x = tbl[tokens].to(cfg.dtype)
    x = maybe_constrain(x, ("batch", "seq_act", "embed"))
    if cfg.positional == "learned":
        x = x + params["pos_embed"][:S].to(cfg.dtype)[None]
    return x


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _save_all_but_projections(ctx, op, *args, **kwargs):
    """``save_anything_except_these_names("qkv_proj", "gate_up")``."""
    if getattr(_remat, "name", None) in ("qkv_proj", "gate_up"):
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


def _checkpointed_with_saved_dots(body):
    """``dots_with_no_batch_dims_saveable``: the whole layer is recomputed
    in the backward except its projections (``_proj``), whose outputs are
    kept from the forward. The flash forward is no product, so it runs
    again, as the Pallas call does under this policy in the JAX package.
    Done here and not by a selective-checkpoint policy, which would run
    every op of the layer through a Python dispatch mode."""
    def run(store, x, layer):
        prev = getattr(_remat, "dots", None)
        _remat.dots = store
        try:
            return body(x, layer)
        finally:
            _remat.dots = prev
            store.replay = 0  # the next run is the backward's recompute

    def remat_body(x, layer):
        return checkpoint(run, _SavedDots(), x, layer, use_reentrant=False)

    return remat_body


def layer_scan_body(cfg: TransformerConfig, positions: torch.Tensor
                    ) -> Callable[[torch.Tensor, Params], torch.Tensor]:
    """The (remat-wrapped) per-layer body ``(x, layer) -> x``. With
    ``cfg.remat`` the layer runs under non-reentrant checkpointing:
    "full" recomputes the whole layer in the backward; "dots" and
    "dots_attn" keep the projections' outputs; "min" keeps everything but
    the qkv and gate/up projections (a selective-checkpoint policy).
    "dots_attn" keeps what "dots" keeps: the JAX package also saves the
    attention output there, but its backward still re-runs the flash
    forward for lse, which carries no name, and the port's K1 gives o and
    lse together; so both launch K1 twice per layer and step, as the JAX
    package's gradient program does (tests/test_torch_train.py).
    "half_*" is resolved by ``backbone_with_aux``; any other name
    raises."""
    ctx = current_sharding_ctx()
    if ctx is None:
        def body(x, layer):
            return _layer_body(cfg, x, layer, positions)
    else:
        def body(x, layer):
            # Entered again here: autograd recomputes a checkpointed layer
            # on its own thread (for CUDA tensors), where the caller's
            # thread-local context is not set.
            with sharding_ctx(*ctx):
                return _layer_body(cfg, x, layer, positions)

    if not cfg.remat:
        return body
    policy = cfg.remat_policy
    if policy in ("dots", "dots_attn"):
        return _checkpointed_with_saved_dots(body)
    if policy == "full":
        kw = {}
    elif policy == "min":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_all_but_projections)}
    else:
        raise ValueError(
            f"unhandled remat_policy {policy!r} at the layer level "
            f"(full | dots | dots_attn | min; half_* composes only through "
            f"backbone_with_aux)")

    def remat_body(x, layer):
        return checkpoint(body, x, layer, use_reentrant=False, **kw)

    return remat_body


def backbone_with_aux(params: Params, tokens: torch.Tensor,
                      cfg: TransformerConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens -> hidden [B, S, d] and the MoE aux loss (0 for dense)."""
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = _positions(B, S, tokens.device)
    layers = list(iter_layers(params))
    if cfg.remat and cfg.remat_policy.startswith("half"):
        # Mixed remat: the first half of the stack checkpoints (its saved
        # activations would live longest), the second keeps activations.
        inner = dataclasses.replace(
            cfg, remat_policy="dots" if cfg.remat_policy == "half_dots"
            else "full")
        plain = dataclasses.replace(cfg, remat=False)
        half = cfg.n_layers // 2
        stages = [(layer_scan_body(inner, positions), layers[:half]),
                  (layer_scan_body(plain, positions), layers[half:])]
    else:
        stages = [(layer_scan_body(cfg, positions), layers)]
    for body, stage in stages:
        for layer in stage:
            x = body(x, layer)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def final_hidden_and_head(params: Params, x: torch.Tensor,
                          cfg: TransformerConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final norm + the head weight (tied: ``embed.T``) in cfg.dtype."""
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), cfg.norm)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x, gather_for_use(head.to(cfg.dtype))


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


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Mean CE of logits [B,S,V] vs targets [B,S] over positions where
    ``valid`` (f32 weights) is nonzero: logits[target] - logsumexp, with
    no second [B,S,V] log-softmax tensor."""
    # On a mesh the vocab is made whole first: DTensor's gather from a
    # vocab-sharded operand returns a masked partial sum that its
    # reduction then fails on.
    logits = maybe_constrain(logits, ("batch", "seq_act", None))
    lse = torch.logsumexp(logits, dim=-1)
    at_target = logits.gather(-1, targets.long()[..., None])[..., 0]
    ll = at_target - lse
    return -(ll * valid).sum() / valid.sum().clamp(min=1.0)


def shift_targets_valid(tokens: torch.Tensor,
                        mask: Optional[torch.Tensor] = None):
    """targets/valid for the shift_inputs convention: tokens is [B,S+1],
    the forward ran on tokens[:, :-1]."""
    targets = tokens[:, 1:]
    valid = replicated_like(torch.ones(targets.shape, dtype=torch.float32,
                                       device=tokens.device), tokens)
    if mask is not None:
        valid = valid * mask[:, 1:].float()
    return targets, valid


def inplace_targets_valid(batch: Dict[str, torch.Tensor]):
    """targets/valid for the in-place convention (final position masked)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    targets = torch.cat(
        [tokens[:, 1:], replicated_like(
            torch.zeros((B, 1), dtype=tokens.dtype, device=dev), tokens)],
        dim=1)
    valid = replicated_like(torch.cat(
        [torch.ones((B, S - 1), dtype=torch.float32, device=dev),
         torch.zeros((B, 1), dtype=torch.float32, device=dev)], dim=1),
        tokens)
    mask = batch.get("mask")
    if mask is not None:
        shifted = torch.cat(
            [mask[:, 1:], replicated_like(
                torch.zeros((B, 1), dtype=mask.dtype, device=dev), mask)],
            dim=1)
        valid = valid * shifted.float()
    return targets, valid


def next_token_loss(logits: torch.Tensor,
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token CE over logits [B,S,V] in the in-place convention."""
    targets, valid = inplace_targets_valid(batch)
    return token_cross_entropy(logits, targets, valid)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig, *,
            shift_inputs: bool = False) -> torch.Tensor:
    """Next-token cross-entropy (the JAX ``loss_fn``).

    - in-place (default): tokens [B,S]; the forward runs on the full
      sequence and the final position is masked out of the loss;
    - shift_inputs: tokens [B,S+1]; forward on tokens[:, :-1], targets
      tokens[:, 1:], every position valid (the high-throughput convention:
      the model runs at the power-of-two length S).
    ``batch["mask"]``, if given, weights positions as in the reference.
    With ``cfg.fused_ce`` the head and CE go through ``ops/fused_ce.py``.
    An MoE config raises NotImplementedError in the layer until the MoE
    layer is ported; its aux term is then added as in the reference.
    """
    tokens = batch["tokens"]
    if cfg.fused_ce:
        tokens_in = tokens[:, :-1] if shift_inputs else tokens
        x, aux = backbone_with_aux(params, tokens_in, cfg)
        x, head = final_hidden_and_head(params, x, cfg)
        if shift_inputs:
            targets, valid = shift_targets_valid(tokens, batch.get("mask"))
        else:
            targets, valid = inplace_targets_valid(batch)
        loss = fused_next_token_loss(x.to(cfg.dtype), head, targets, valid)
    elif shift_inputs:
        logits, aux = forward_with_aux(params, tokens[:, :-1], cfg)
        targets, valid = shift_targets_valid(tokens, batch.get("mask"))
        loss = token_cross_entropy(logits, targets, valid)
    else:
        logits, aux = forward_with_aux(params, tokens, cfg)
        loss = next_token_loss(logits, batch)
    if cfg.moe_num_experts:
        loss = loss + cfg.moe_aux_coef * aux
    return loss
