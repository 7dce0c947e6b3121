"""Named model configs (the JAX package's ``models/configs.py``, as plain
data): GPT-2 125M, Llama-3-8B, the single-chip bench model and tiny
variants for tests."""
from __future__ import annotations

from .transformer import TransformerConfig


def gpt2_125m(**overrides) -> TransformerConfig:
    kw = dict(
        vocab_size=50257,
        d_model=768,
        n_layers=12,
        n_heads=12,
        max_seq_len=1024,
        norm="layernorm",
        activation="gelu",
        positional="learned",
        tie_embeddings=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def llama3_8b(**overrides) -> TransformerConfig:
    kw = dict(
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        max_seq_len=8192,
        norm="rmsnorm",
        activation="swiglu",
        positional="rope",
        rope_theta=500000.0,
        tie_embeddings=False,
        remat=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def llama_tiny(**overrides) -> TransformerConfig:
    """Llama-family shape small enough for CPU tests and dry-runs."""
    kw = dict(
        vocab_size=512,
        d_model=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        max_seq_len=128,
        norm="rmsnorm",
        activation="swiglu",
        positional="rope",
        tie_embeddings=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def gpt2_tiny(**overrides) -> TransformerConfig:
    kw = dict(
        vocab_size=512,
        d_model=128,
        n_layers=2,
        n_heads=4,
        max_seq_len=128,
        norm="layernorm",
        activation="gelu",
        positional="learned",
        tie_embeddings=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


# The single-chip bench model of the JAX package.
def bench_350m(**overrides) -> TransformerConfig:
    kw = dict(
        vocab_size=32000,
        d_model=1024,
        n_layers=24,
        n_heads=16,
        max_seq_len=1024,
        norm="rmsnorm",
        activation="swiglu",
        positional="rope",
        tie_embeddings=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def moe_tiny(**overrides) -> TransformerConfig:
    """Tiny mixture-of-experts decoder (the MoE layer is not ported yet)."""
    kw = dict(
        vocab_size=512,
        d_model=128,
        n_layers=2,
        n_heads=4,
        max_seq_len=128,
        norm="rmsnorm",
        activation="swiglu",
        positional="rope",
        tie_embeddings=True,
        moe_num_experts=4,
        moe_experts_per_token=2,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)
