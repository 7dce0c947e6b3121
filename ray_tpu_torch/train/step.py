"""One-device training step: params + optimizer + batch -> one update.

The counterpart of the JAX package's ``train/step.py`` on one device.
``TrainStep`` keeps ``ShardedTrainStep``'s surface (``init``, ``step``,
``eval_loss``) without a mesh: PyTorch runs eagerly, so there is no program
to compile, and the backward goes through the hand-written flash kernels
(``ops/flash_attention.py``) on CUDA tensors.

Two differences from the reference, by design:

- parameters and optimizer state update in place; the JAX step donates its
  input buffers and returns new ones. ``step`` still returns
  ``(params, opt_state, loss)`` so a caller's loop reads the same;
- the optimizer state is the ``torch.optim.Optimizer`` object itself.

The mesh, the sharding rules and the pipeline branch of
``transformer_train_step`` wait for the distributed slice of the port.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device, same_device

Params = Dict[str, Any]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def default_optimizer(leaves: List[torch.Tensor]) -> torch.optim.Optimizer:
    """AdamW as ``optax.adamw(3e-4, weight_decay=0.0)`` (the reference's
    default). Torch's own default weight_decay is 0.01, so it is set."""
    return torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The tensors of a param tree, top level first, then the layers."""
    out = [v for k, v in params.items() if k != "layers"]
    return out + list(params.get("layers", {}).values())


class TrainStep:
    """Holds the loss, the optimizer factory and the device of one-device
    training.

    ``loss_fn(params, batch) -> scalar loss``; ``init_params_fn(generator,
    device) -> params``. ``optimizer`` builds the optimizer over the param
    leaves (default: :func:`default_optimizer`). ``device=None`` means the
    current CUDA card, and raises without one.
    """

    def __init__(self, *, init_params_fn: Callable[..., Params],
                 loss_fn: Callable[[Params, Any], torch.Tensor],
                 device: DeviceLike = None,
                 optimizer: Optional[OptimizerFactory] = None):
        self.device = resolve_device(device)
        self._init_params_fn = init_params_fn
        self._loss_fn = loss_fn
        self._make_optimizer = optimizer or default_optimizer

    def init_opt_state(self, params: Params) -> torch.optim.Optimizer:
        """Mark the param leaves trainable and build the optimizer over
        them (the counterpart of ``optimizer.init(params)``)."""
        leaves = param_leaves(params)
        for t in leaves:
            if not same_device(t.device, self.device):
                raise ValueError(f"param on {t.device}, the step runs on "
                                 f"{self.device}")
            t.requires_grad_(True)
        return self._make_optimizer(leaves)

    def init(self, generator: torch.Generator
             ) -> Tuple[Params, torch.optim.Optimizer]:
        """Random params from ``generator`` (on the step's device) and a
        fresh optimizer over them."""
        with torch.no_grad():
            params = self._init_params_fn(generator, self.device)
        return params, self.init_opt_state(params)

    def step(self, params: Params, opt_state: torch.optim.Optimizer,
             batch: Any) -> Tuple[Params, torch.optim.Optimizer,
                                  torch.Tensor]:
        """One update in place; returns (params, opt_state, loss). The loss
        stays on the device (reading it waits for the step)."""
        opt_state.zero_grad(set_to_none=True)
        loss = self._loss_fn(params, batch)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    def eval_loss(self, params: Params, batch: Any) -> torch.Tensor:
        with torch.no_grad():
            return self._loss_fn(params, batch)


def transformer_train_step(cfg, *, device: DeviceLike = None,
                           optimizer: Optional[OptimizerFactory] = None,
                           shift_inputs: bool = False, mesh: Any = None,
                           rules: Any = None,
                           pipeline_microbatches: Optional[int] = None
                           ) -> TrainStep:
    """Wire a ``models.transformer`` config into a :class:`TrainStep`.
    ``shift_inputs`` selects the [B, S+1]-tokens convention (see
    ``loss_fn``). ``mesh``, ``rules`` and ``pipeline_microbatches`` are the
    reference's distributed options and raise NotImplementedError here."""
    from ..models import transformer as tfm

    if (mesh is not None or rules is not None
            or pipeline_microbatches is not None):
        raise NotImplementedError(
            "the mesh, sharding rules and pipeline of transformer_train_step "
            "are not ported yet (ROADMAP queue A3/A4); the port trains on "
            "one device")
    return TrainStep(
        init_params_fn=lambda gen, dev: tfm.init_params(cfg, gen, dev),
        loss_fn=lambda params, batch: tfm.loss_fn(
            params, batch, cfg, shift_inputs=shift_inputs),
        device=device,
        optimizer=optimizer,
    )
