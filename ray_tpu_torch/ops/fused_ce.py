"""Chunked fused lm-head + cross-entropy (vocab-blocked, custom backward).

The counterpart of the JAX package's ``ray_tpu/ops/fused_ce.py``. The plain
``logits = x @ head; CE(logits)`` forms an [M, V] f32 logits tensor in the
forward and an [M, V] dlogits tensor in the backward (1 GB each at M =
8 * 1024 tokens, V = 32000). This op forms neither: the forward walks the
vocab in chunks with an online logsumexp (running max and sum) and keeps
only [M] statistics; the backward recomputes each chunk's logits, forms
that chunk's dlogits and contracts it into dx and dhead at once. Peak extra
memory is one [M, chunk] tile.

The JAX version is an XLA ``lax.scan`` with no Pallas kernel, so this is a
``torch.autograd.Function`` over plain PyTorch products. Numerics as the
reference: logits and both gradients accumulate in f32 whatever the dtype
of x and head (the operands are cast up, which is exact for bf16).
"""
from __future__ import annotations

import torch


def _pick_chunk(V: int, target: int = 4096) -> int:
    """Chunk width for a vocab of V: the largest 128-multiple divisor
    <= target if one exists, else the largest divisor <= target, else V
    itself (a prime vocab must not degrade to V chunks of width 1)."""
    best_any = 0
    for c in range(min(target, V), 1, -1):
        if V % c == 0:
            if c % 128 == 0:
                return c  # descending: the first 128-multiple is the largest
            if best_any == 0:
                best_any = c
    return best_any or V


def _chunk_width(V: int, chunk: int) -> int:
    C = chunk or _pick_chunk(V)
    if V % C:
        raise ValueError(f"chunk {C} does not divide the vocab {V}")
    return C


def _in_chunk(targets: torch.Tensor, ci: int, C: int):
    """(target index inside chunk ci, clamped; whether it lies there)."""
    local = targets - ci * C
    return local.clamp(0, C - 1), (local >= 0) & (local < C)


class FusedCE(torch.autograd.Function):
    """Mean next-token CE of ``x @ head`` against ``targets``.

    x: [M, d] (any float dtype); head: [d, V]; targets: [M] int64;
    valid: [M] f32 weights (0 masks a position); chunk: vocab chunk width
    (0 picks one)."""

    @staticmethod
    def forward(ctx, x, head, targets, valid, chunk):
        M = x.shape[0]
        V = head.shape[1]
        C = _chunk_width(V, chunk)
        xf = x.float()
        m = torch.full((M,), float("-inf"), device=x.device)
        s = torch.zeros(M, device=x.device)
        tgt = torch.zeros(M, device=x.device)
        for ci in range(V // C):
            logits = xf @ head[:, ci * C:(ci + 1) * C].float()
            new_m = torch.maximum(m, logits.amax(dim=-1))
            # Online logsumexp: rescale the running sum to the new max.
            s = s * torch.exp(m - new_m) + torch.exp(
                logits - new_m[:, None]).sum(-1)
            m = new_m
            local, here = _in_chunk(targets, ci, C)
            picked = logits.gather(1, local[:, None])[:, 0]
            tgt = torch.where(here, picked, tgt)
        lse = m + torch.log(s)
        denom = valid.sum().clamp(min=1.0)
        ctx.save_for_backward(x, head, targets, valid, lse)
        ctx.chunk = C
        return -(((tgt - lse) * valid).sum() / denom)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, head, targets, valid, lse = ctx.saved_tensors
        C = ctx.chunk
        V = head.shape[1]
        xf = x.float()
        w = (g * valid / valid.sum().clamp(min=1.0)).float()
        dx = torch.zeros_like(xf)
        dhead = torch.empty((head.shape[0], V), device=x.device)
        for ci in range(V // C):
            hc = head[:, ci * C:(ci + 1) * C].float()
            logits = xf @ hc
            dlogits = torch.exp(logits - lse[:, None])  # softmax chunk
            local, here = _in_chunk(targets, ci, C)
            dlogits.scatter_add_(1, local[:, None], -here.float()[:, None])
            dlogits *= w[:, None]                       # one [M, C] tile
            dx += dlogits @ hc.T
            dhead[:, ci * C:(ci + 1) * C] = xf.T @ dlogits
        return dx.to(x.dtype), dhead.to(head.dtype), None, None, None


def fused_ce(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
             valid: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    return FusedCE.apply(x, head, targets, valid, chunk)


def fused_next_token_loss(x: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor, valid: torch.Tensor,
                          chunk: int = 0) -> torch.Tensor:
    """[B, S, d] hidden states -> mean CE, flattened for the op."""
    B, S, d = x.shape
    return fused_ce(x.reshape(B * S, d), head,
                    targets.reshape(B * S).long(),
                    valid.reshape(B * S).float(), chunk)
