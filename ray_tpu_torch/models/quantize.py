"""Weight-only int8 quantization for inference (counterpart of the JAX
package's ``models/quantize.py``).

Symmetric absmax per OUTPUT channel: for a weight [d_in, ...out] the scale
is [1, ...out] f32 (the reduced d_in axis kept as size 1, so ``q * scale``
broadcasts the same for the stacked [L, d_in, ...out] leaf and for one
layer's slice). The layer helpers dequantize through :func:`maybe_dequant`
whenever a ``<name>_q8_scale`` sibling is present.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

Params = Dict[str, Any]

# Per-layer weights worth quantizing (the stacked [L, ...] leaves).
DEFAULT_NAMES = ("wqkv", "wq", "wkv", "wo", "w_gate_up", "w_up", "w_down")

SCALE_SUFFIX = "_q8_scale"


def _quantize_stacked(w: torch.Tensor):
    """[L, d_in, ...out] -> (int8 [same shape], scale [L, 1, ...out] f32)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_params_int8(params: Params,
                         names: Iterable[str] = DEFAULT_NAMES) -> Params:
    """Same tree with each named layer weight replaced by int8 plus a
    ``<name>_q8_scale`` sibling (per layer: the scale keeps the leading L)."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in names:
        w = layers.get(name)
        if w is None:
            continue
        if w.dtype == torch.int8 or name + SCALE_SUFFIX in layers:
            # Already quantized: re-quantizing would take absmax over the
            # int8 CODES (~127), overwrite the real scale with ~1.0 and
            # corrupt every channel. Idempotent skip.
            continue
        q, scale = _quantize_stacked(w)
        layers[name] = q
        layers[name + SCALE_SUFFIX] = scale
    out["layers"] = layers
    return out


def maybe_dequant(layer: Params, name: str, dtype: torch.dtype
                  ) -> torch.Tensor:
    """The layer weight in compute dtype, dequantizing if quantized — the
    access path the transformer's layer helpers use for every weight."""
    w = layer[name]
    scale = layer.get(name + SCALE_SUFFIX)
    if scale is None:
        return w.to(dtype)
    return (w.float() * scale).to(dtype)
