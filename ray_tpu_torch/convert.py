"""Carry transformer parameters between the JAX package and the port.

The JAX parameter pytree, converted leaf by leaf with ``np.asarray``, has
the same names and shapes as the port's parameters (layers stacked
[L, ...]: ``wqkv`` [L,d,3,H,hd] for MHA, ``wq`` [L,d,H,hd] with ``wkv``
[L,d,2,KVH,hd] for GQA, ``w_gate_up`` [L,d,2,F], optional
``<name>_q8_scale`` siblings of int8 weights; a tied head has no
``lm_head`` and reads ``embed.T``). :func:`params_to_mesh` carries them
onto a device mesh as DTensors, placed as a sharded train step places
them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .device import DeviceLike, resolve_device
from .models.quantize import SCALE_SUFFIX
from .models.transformer import (TransformerConfig, param_logical_specs,
                                 param_spec)
from .parallel import sharding as shd
from .parallel.mesh import mesh_device

Params = Dict[str, Any]


def _leaf_to_tensor(a, device: torch.device) -> torch.Tensor:
    # A copy: arrays viewed from JAX buffers are read-only.
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes provides it): carry
        # the bits across as uint16 and reinterpret them.
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _check_shape(name: str, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"param {name}: shape {tuple(got)}, config "
                         f"expects {tuple(want)}")


def _check_names(where: str, got, want) -> None:
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{where}: missing {missing}, unexpected {extra}")


def params_from_numpy(tree: Params, cfg: TransformerConfig,
                      device: DeviceLike = None) -> Params:
    """JAX param tree of numpy arrays -> the port's params on ``device``.
    Names and shapes are checked against ``cfg``; leaf dtypes are kept."""
    device = resolve_device(device)
    spec = param_spec(cfg)
    layer_spec = spec["layers"]
    top = {k: v for k, v in tree.items() if k != "layers"}
    _check_names("params", top, [k for k in spec if k != "layers"])
    out: Params = {}
    for name, a in top.items():
        _check_shape(name, np.shape(a), spec[name][0])
        out[name] = _leaf_to_tensor(a, device)
    layers = tree["layers"]
    weights = {k: v for k, v in layers.items()
               if not k.endswith(SCALE_SUFFIX)}
    _check_names("params['layers']", weights, layer_spec)
    out["layers"] = {}
    for name, a in layers.items():
        if name.endswith(SCALE_SUFFIX):
            base = name[:-len(SCALE_SUFFIX)]
            if base not in layer_spec:
                raise ValueError(f"scale {name} has no weight {base}")
            want = list(layer_spec[base][0])
            want[1] = 1  # the reduced d_in axis stays as size 1
            _check_shape(name, np.shape(a), want)
        else:
            _check_shape(name, np.shape(a), layer_spec[name][0])
        out["layers"][name] = _leaf_to_tensor(a, device)
    return out


def params_to_mesh(tree: Params, cfg: TransformerConfig, mesh,
                   rules: Optional[shd.Rules] = None) -> Params:
    """JAX param tree of numpy arrays (the same on every rank) -> DTensors
    on ``mesh`` with the placements ``tree_shardings(mesh,
    param_logical_specs(cfg), rules)`` gives them, one leaf on the device
    at a time. Names and shapes are checked as by
    :func:`params_from_numpy`."""
    host = params_from_numpy(tree, cfg, "cpu")
    device = mesh_device(mesh)
    return shd.tree_map(
        lambda t, s: s.distribute(t.to(device)), host,
        shd.tree_shardings(mesh, param_logical_specs(cfg), rules))


def params_to_numpy(params: Params) -> Params:
    """The inverse of :func:`params_from_numpy`: a tree of numpy arrays on
    the host. bfloat16 leaves come out as float32 (numpy has no bfloat16
    of its own), which is exact. DTensor leaves are gathered whole (every
    rank of their mesh calls this)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    out: Params = {k: leaf(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: leaf(v) for k, v in params["layers"].items()}
    return out
