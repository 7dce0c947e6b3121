"""Default model catalog: obs/action space -> RLModule (counterpart of the
JAX package's ``rllib/core/catalog.py``): one MLP family, one Nature-CNN
family for pixels.

The reference's convolutions are NHWC with HWIO weights and VALID padding.
The port keeps the params in that layout (so weights and optimizer state
carry across unchanged) and hands ``F.conv2d`` views: the [N, H, W, C]
batch permuted to NCHW (a channels-last tensor) and each HWIO weight
permuted to OIHW. The conv stack's output is permuted back to NHWC before
the flatten, so the trunk reads features in the reference's (H, W, C)
order. The convolutions and their gradients run in f32 with TF32 off, as
the reference computes them (cuDNN allows TF32 by default).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .rl_module import MLPModule, Params, RLModule, _dense, _dense_init

# (out_channels, kernel, stride) — the Nature DQN/IMPALA-shallow stack.
NATURE_CONV = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def f32_convs():
    """cuDNN with TF32 off for the block; its other settings unchanged.
    The forward's convolutions run under it, and the learner's backward
    too: ``convolution_backward`` reads the flag when it runs."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class CNNModule(RLModule):
    """Pixel policy: shared conv trunk + separate pi/vf heads (reference
    catalog's conv defaults for Atari)."""

    def __init__(self, obs_shape: Tuple[int, int, int], num_actions: int,
                 conv: Sequence[Tuple[int, int, int]] = NATURE_CONV,
                 hidden: int = 512):
        self.obs_shape = tuple(obs_shape)  # (H, W, C)
        self.num_actions = num_actions
        self.conv = tuple(conv)
        self.hidden = hidden

    def _conv_out_dim(self) -> int:
        h, w, _ = self.obs_shape
        for _, k, s in self.conv:
            h = (h - k) // s + 1
            w = (w - k) // s + 1
        return h * w * self.conv[-1][0]

    def init(self, generator: torch.Generator) -> Params:
        device = generator.device
        convs = []
        c_in = self.obs_shape[-1]
        for c_out, k, _ in self.conv:
            fan_in = k * k * c_in
            w = torch.randn(k, k, c_in, c_out, generator=generator,
                            device=device) * float(np.sqrt(2.0 / fan_in))
            convs.append({"w": w, "b": torch.zeros(c_out, device=device)})
            c_in = c_out
        return {
            "convs": convs,
            "trunk": _dense_init(generator, self._conv_out_dim(),
                                 self.hidden),
            "pi": _dense_init(generator, self.hidden, self.num_actions,
                              scale=0.01),
            "vf": _dense_init(generator, self.hidden, 1, scale=1.0),
        }

    def forward(self, params: Params, obs: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        # Only uint8 pixels are scaled; f32 observations arrive as they are.
        x = obs.float()
        if obs.dtype == torch.uint8:
            x = x / 255.0
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC batch
        with f32_convs():
            for p, (_, _, stride) in zip(params["convs"], self.conv):
                x = F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"],
                             stride=stride)
                x = torch.relu(x)
        # Flatten in (H, W, C) order, as the reference's NHWC reshape.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        h = torch.relu(_dense(params["trunk"], x))
        logits = _dense(params["pi"], h)
        vf = _dense(params["vf"], h)[..., 0]
        return {"logits": logits, "vf": vf}


def module_for_space(obs_space, act_space,
                     model_config: Dict[str, Any]) -> RLModule:
    """Spaces -> default RLModule. Takes the port's ``spaces`` or
    gymnasium's, by their ``shape`` and ``n``: only discrete action spaces
    (those with an ``n``)."""
    if getattr(act_space, "n", None) is None:
        raise NotImplementedError(
            f"only Discrete action spaces supported, got {act_space}")
    shape = tuple(obs_space.shape)
    if len(shape) == 3:
        return CNNModule(shape, int(act_space.n),
                         conv=model_config.get("conv", NATURE_CONV),
                         hidden=model_config.get("hidden", 512))
    if len(shape) == 1:
        return MLPModule(shape[0], int(act_space.n),
                         hiddens=model_config.get("fcnet_hiddens", (64, 64)))
    raise NotImplementedError(f"unsupported obs shape {shape}")
