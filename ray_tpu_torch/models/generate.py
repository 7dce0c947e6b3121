"""Autoregressive decoding with a preallocated KV cache (counterpart of the
JAX package's ``models/generate.py``).

- **Prefill/decode split**: the prompt runs through the batched forward
  capturing each layer's K/V; each decode step is a [B, 1] pass attending
  over the cache.
- **Ragged rows**: ``cache.pos`` is a scalar (uniform batch) or [B]
  (per-row prompt lengths); decode writes and masks per row.
- **In place**: a decode step writes its K/V slot into the cache tensors and
  returns a KVCache that shares them, instead of copying the cache each
  step. A write past the end is clamped to the last slot, as the JAX
  ``dynamic_update_slice`` clamps it; :func:`decode_step` raises for that
  case before computing, the engine's tick does not check (the check
  synchronises with the device).

Layout: cache K/V are [L, B, max_len, KVH, hd].
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from .transformer import (
    TransformerConfig,
    _layer_body,
    _mlp_block,
    _norm,
    _positions,
    _qkv_proj,
    _w,
    embed_tokens,
    final_hidden_and_head,
    iter_layers,
)

Params = Dict[str, torch.Tensor]


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, max_len, KVH, hd] (cfg.dtype)
    v: torch.Tensor  # [L, B, max_len, KVH, hd]
    # Tokens filled so far: [] (uniform batch) or [B] (ragged batch).
    pos: torch.Tensor


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int, lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt [B, S] through the batched forward, returning logits
    for the last REAL position [B, V] and the primed cache.

    ``lengths`` [B] enables ragged prompts: rows are right-padded to S, each
    row's logits come from index lengths[i]-1, and cache.pos = lengths.
    Right-padding needs no key mask: causal attention keeps real tokens from
    attending pads, and decode overwrites the pad K/V slot at pos[i] before
    attending (see :func:`decode_step`)."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds cache max_len {max_len}")
    x = embed_tokens(params, tokens, cfg)
    positions = _positions(B, S, tokens.device)
    L, KVH, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    ck = torch.zeros((L, B, max_len, KVH, hd), dtype=cfg.dtype,
                     device=x.device)
    cv = torch.zeros_like(ck)
    for i, layer in enumerate(iter_layers(params)):
        x, k, v = _layer_body(cfg, x, layer, positions, return_kv=True)
        ck[i, :, :S] = k
        cv[i, :, :S] = v
    if lengths is None:
        last = x[:, -1:]
        pos = torch.tensor(S, dtype=torch.int64, device=x.device)
    else:
        lengths = lengths.to(device=x.device, dtype=torch.int64)
        idx = (lengths - 1)[:, None, None].expand(B, 1, x.shape[-1])
        last = x.gather(1, idx)
        pos = lengths.clone()
    h, head = final_hidden_and_head(params, last, cfg)
    logits = (h @ head).float()[:, 0]
    return logits, KVCache(k=ck, v=cv, pos=pos)


def _decode(params: Params, cache: KVCache, token: torch.Tensor,
            cfg: TransformerConfig) -> Tuple[torch.Tensor, KVCache]:
    """decode_step without the overflow check (no host synchronisation)."""
    if cfg.positional == "learned":
        raise NotImplementedError(
            "decode_step: learned positional embeddings index by absolute "
            "position, which embed_tokens applies only for full sequences; "
            "use rope (the flagship configs) for incremental decoding")
    B = token.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    G = H // KVH
    max_len = cache.k.shape[2]
    pos = cache.pos
    ragged = pos.dim() == 1
    dev = token.device
    x = embed_tokens(params, token[:, None], cfg)  # [B, 1, d]
    slots = torch.arange(max_len, device=dev)
    if ragged:
        positions = pos[:, None]
        # [B, 1, 1, max_len]: row i attends slots < pos[i] and its own
        # just-written slot.
        valid = (slots[None] <= pos[:, None])[:, None, None]
    else:
        positions = pos.expand(B)[:, None]
        valid = (slots <= pos)[None, None, None]
    # The write index clamps to the last slot, as dynamic_update_slice does:
    # an idle engine slot keeps advancing past max_len and must not fault.
    rows = torch.arange(B, device=dev)
    widx = pos.clamp(0, max_len - 1).expand(B)

    for i, layer in enumerate(iter_layers(params)):
        ck, cv = cache.k[i], cache.v[i]  # [B, max_len, KVH, hd] views
        h = _norm(x, layer["attn_norm"], layer.get("attn_norm_b"), cfg.norm)
        q, k, v = _qkv_proj(cfg, h, layer, positions)
        # Write this step's K/V slot BEFORE attending: ragged rows read it.
        ck[rows, widx] = k[:, 0].to(ck.dtype)
        cv[rows, widx] = v[:, 0].to(cv.dtype)
        # GQA: query head h reads kv head h // G.
        qg = q.float().reshape(B, KVH, G, hd)
        scores = torch.matmul(qg, ck.float().permute(0, 2, 3, 1)) / (hd ** 0.5)
        scores = scores.masked_fill(~valid, -1e30)  # [B, KVH, G, max_len]
        probs = torch.softmax(scores, dim=-1)
        o = torch.matmul(probs, cv.float().permute(0, 2, 1, 3)).to(cfg.dtype)
        x = x + o.reshape(B, 1, H * hd) @ _w(layer, "wo", cfg)
        h = _norm(x, layer["mlp_norm"], layer.get("mlp_norm_b"), cfg.norm)
        x = x + _mlp_block(cfg, h, layer)
    x, head = final_hidden_and_head(params, x, cfg)
    logits = (x @ head).float()[:, 0]
    return logits, KVCache(k=cache.k, v=cache.v, pos=pos + 1)


@torch.no_grad()
def decode_step(params: Params, cache: KVCache, token: torch.Tensor,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, KVCache]:
    """One token [B] -> logits [B, V] + the cache advanced by one (the K/V
    slot is written in place). Raises when the cache is full; this check
    reads ``pos`` on the host."""
    max_len = cache.k.shape[2]
    hi = int(cache.pos.max())
    if hi >= max_len:
        raise ValueError(
            f"decode_step: cache full (pos {hi} >= max_len {max_len}); size "
            f"prefill's max_len for the tokens you intend to generate")
    return _decode(params, cache, token, cfg)


def _gumbel_argmax(scaled: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``scaled`` logits (Gumbel-max)."""
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


def _decode_loop(params, cfg, cache, logits, pick: Callable, max_new_tokens,
                 eos_id):
    """Shared first-token + eos-freeze loop of generate()/generate_ragged().
    Returns (first [B], rest [max_new_tokens-1, B])."""
    first = pick(logits)
    done = (torch.zeros_like(first, dtype=torch.bool) if eos_id is None
            else first == eos_id)
    tok = first
    rest = []
    for _ in range(max(max_new_tokens - 1, 0)):
        logits, cache = _decode(params, cache, tok, cfg)
        nxt = pick(logits)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        rest.append(nxt)
        tok = nxt
    if rest:
        return first, torch.stack(rest)
    return first, first.new_zeros((0, first.shape[0]))


def _default_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


@torch.no_grad()
def generate(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
             max_new_tokens: int, *, temperature: float = 0.0,
             top_k: int = 0, generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """Greedy (temperature=0) or sampled continuation of ``tokens`` [B, S]
    -> [B, S + max_new_tokens]. Once a row emits ``eos_id`` it keeps
    repeating it. Runs on the device of ``tokens``."""
    B, S = tokens.shape
    max_len = S + max_new_tokens
    logits, cache = prefill(params, tokens, cfg, max_len)
    gen = generator or _default_generator(tokens.device)

    def pick(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        scaled = logits / max(temperature, 1e-6)
        if top_k:
            kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
            scaled = scaled.masked_fill(scaled < kth, -1e30)
        return _gumbel_argmax(scaled, gen)

    first, rest = _decode_loop(params, cfg, cache, logits, pick,
                               max_new_tokens, eos_id)
    out = torch.cat([tokens, first[:, None].to(tokens.dtype),
                     rest.T.to(tokens.dtype)], dim=1)
    return out[:, :max_len]


@torch.no_grad()
def generate_ragged(params: Params, tokens: torch.Tensor,
                    lengths: torch.Tensor, cfg: TransformerConfig,
                    max_new_tokens: int, *,
                    temperature: Union[float, torch.Tensor] = 0.0,
                    generator: Optional[torch.Generator] = None,
                    eos_id: Optional[int] = None) -> torch.Tensor:
    """Mixed-length batched generation: prompts right-padded to [B, S] with
    true ``lengths`` [B] -> GENERATED tokens [B, max_new_tokens].
    ``temperature`` may be a scalar or a [B] vector (rows with
    temperature <= 0 decode greedily)."""
    B, S = tokens.shape
    max_len = S + max_new_tokens
    logits, cache = prefill(params, tokens, cfg, max_len, lengths=lengths)
    gen = generator or _default_generator(tokens.device)
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=tokens.device)
    temp = temp.expand(B) if temp.dim() == 0 else temp
    tcol = temp[:, None]
    any_sampled = bool((temp > 0).any())

    def pick(logits):
        greedy = torch.argmax(logits, dim=-1)
        if not any_sampled:
            return greedy
        sampled = _gumbel_argmax(logits / tcol.clamp_min(1e-6), gen)
        return torch.where(temp <= 0.0, greedy, sampled)

    first, rest = _decode_loop(params, cfg, cache, logits, pick,
                               max_new_tokens, eos_id)
    return torch.cat([first[:, None], rest.T], dim=1)
