"""Connectors: the three composable transform pipelines around the module
(numpy only; the port's copy of the JAX package's
``rllib/connectors/connector.py``).

Parity: reference rllib/connectors/ (connector_v2.py + env_to_module/,
module_to_env/, learner/ pipeline packages):

- **env-to-module** (`ConnectorV2` here): raw vector observations ->
  module inputs, run inside the env runner before the policy
  forward. Image preprocessing (GrayScale/ResizeImage/ScaleObs/FrameStack)
  lives on this path — the Atari chain of the reference's
  FrameStackingEnvToModule + gym wrappers.
- **module-to-env** (also `ConnectorV2`, applied to ACTIONS): module action
  outputs -> env actions (clip/unsquash for continuous spaces; reference
  module_to_env/unsquash_and_clip_actions). Buffers record the MODULE's
  actions; only the env sees the transformed ones.
- **learner** (`LearnerConnector`): [T, N] fragment columns -> fragment
  columns, applied by the algorithm BEFORE advantage estimation (the
  reference puts GAE itself in this pipeline; here GAE stays a
  function and the connector handles the data transforms around it, e.g.
  Atari reward clipping).

Connectors are plain objects with numpy __call__ (the env side is CPU
work); stateful ones (FrameStack) keep per-env state and are reset on
episode boundaries.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class ConnectorV2:
    """One transform stage: obs batch [N, ...] -> obs batch [N, ...]."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reset(self, env_index: Optional[int] = None) -> None:
        """Clear per-env state (episode boundary); None = all envs."""

    def output_shape(self, input_shape: Sequence[int]) -> Sequence[int]:
        """Shape of one transformed observation (for module sizing)."""
        return input_shape


class ConnectorPipeline(ConnectorV2):
    def __init__(self, connectors: Sequence[ConnectorV2]):
        self.connectors = list(connectors)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            obs = c(obs)
        return obs

    def reset(self, env_index: Optional[int] = None) -> None:
        for c in self.connectors:
            c.reset(env_index)

    def output_shape(self, input_shape):
        for c in self.connectors:
            input_shape = c.output_shape(input_shape)
        return input_shape


class FlattenObs(ConnectorV2):
    """[N, *dims] -> [N, prod(dims)] (reference FlattenObservations)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return np.asarray(obs).reshape(len(obs), -1)

    def output_shape(self, input_shape):
        return (int(np.prod(input_shape)),)


class NormalizeObs(ConnectorV2):
    """Running mean/std normalization (reference MeanStdFilter)."""

    def __init__(self, clip: float = 10.0, epsilon: float = 1e-8):
        self.clip = clip
        self.epsilon = epsilon
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[1:], np.float64)
            self._m2 = np.ones(obs.shape[1:], np.float64)
        for row in obs:  # Welford update per observation
            self._count += 1.0
            delta = row - self._mean
            self._mean += delta / self._count
            self._m2 += delta * (row - self._mean)
        std = np.sqrt(self._m2 / max(1.0, self._count - 1)) + self.epsilon
        out = (obs - self._mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)


class FrameStack(ConnectorV2):
    """Stack the last k observations per env along the last axis
    (reference FrameStackingEnvToModule)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: Dict[int, "collections.deque"] = {}

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs)
        out = []
        for i, row in enumerate(obs):
            dq = self._frames.get(i)
            if dq is None or not dq:
                dq = collections.deque([row] * self.k, maxlen=self.k)
                self._frames[i] = dq
            else:
                dq.append(row)
            out.append(np.concatenate(list(dq), axis=-1))
        return np.stack(out)

    def reset(self, env_index: Optional[int] = None) -> None:
        if env_index is None:
            self._frames.clear()
        else:
            self._frames.pop(env_index, None)

    def output_shape(self, input_shape):
        shape = list(input_shape)
        shape[-1] = shape[-1] * self.k
        return tuple(shape)


# --------------------------------------------------------- image transforms


class GrayScale(ConnectorV2):
    """[N, H, W, C>=3] RGB -> [N, H, W, 1] luma; dtype preserved
    (reference: gym AtariPreprocessing grayscale_obs)."""

    _LUMA = np.array([0.299, 0.587, 0.114], np.float32)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs)
        gray = np.tensordot(obs[..., :3].astype(np.float32), self._LUMA,
                            axes=([-1], [0]))
        if np.issubdtype(obs.dtype, np.integer):
            gray = np.clip(np.rint(gray), 0, 255)
        return gray.astype(obs.dtype)[..., None]

    def output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (1,)


class ResizeImage(ConnectorV2):
    """[N, H, W, C] -> [N, h, w, C]: block-mean ("area") when the source
    divides evenly, nearest-neighbor index maps otherwise (210x160 -> 84x84
    takes the nearest path); dtype preserved. Pure numpy — no cv2/PIL in
    this image."""

    def __init__(self, height: int = 84, width: int = 84):
        self.h, self.w = int(height), int(width)
        self._idx: Dict[Any, Any] = {}

    def _maps(self, H: int, W: int):
        key = (H, W)
        got = self._idx.get(key)
        if got is None:
            if H % self.h == 0 and W % self.w == 0:
                got = ("area", H // self.h, W // self.w)
            else:
                ri = np.minimum((np.arange(self.h) + 0.5) * H / self.h,
                                H - 1).astype(np.int64)
                ci = np.minimum((np.arange(self.w) + 0.5) * W / self.w,
                                W - 1).astype(np.int64)
                got = ("nearest", ri, ci)
            self._idx[key] = got
        return got

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs)
        N, H, W = obs.shape[:3]
        kind, a, b = self._maps(H, W)
        if kind == "area":
            out = obs.reshape(N, self.h, a, self.w, b, *obs.shape[3:])
            out = out.mean(axis=(2, 4))
            if np.issubdtype(obs.dtype, np.integer):
                out = np.rint(out)
            return out.astype(obs.dtype)
        return obs[:, a][:, :, b]

    def output_shape(self, input_shape):
        return (self.h, self.w) + tuple(input_shape[2:])


class ScaleObs(ConnectorV2):
    """uint8 pixels -> float32 in [0, 1] (reference: normalize_images)."""

    def __init__(self, scale: float = 1.0 / 255.0):
        self.scale = float(scale)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return np.asarray(obs, np.float32) * self.scale


def atari_preprocessor(k: int = 4, size: int = 84) -> ConnectorPipeline:
    """The standard Atari chain: gray -> resize -> scale -> stack-k.
    Pass the FUNCTION as env_to_module_connector (it is the factory).
    FrameStack concatenates along the channel axis, so the module sees
    [size, size, k] — the DQN-lineage CNN input layout."""
    return ConnectorPipeline(
        [GrayScale(), ResizeImage(size, size), ScaleObs(), FrameStack(k)])


# ------------------------------------------------- module-to-env (actions)


class ClipActions(ConnectorV2):
    """Clip continuous module actions into the env's bounds — scalars or
    per-dimension Box arrays (space.low/space.high), as in reference
    module_to_env clip_actions. No-op for integer/discrete arrays."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        actions = np.asarray(actions)
        if np.issubdtype(actions.dtype, np.integer):
            return actions
        return np.clip(actions, self.low, self.high)


class UnsquashActions(ConnectorV2):
    """Map tanh-squashed module outputs in [-1, 1] onto [low, high]
    (scalar or per-dimension array bounds; reference module_to_env
    unsquash_actions)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        actions = np.asarray(actions, np.float32)
        return self.low + (np.clip(actions, -1.0, 1.0) + 1.0) * 0.5 * (
            self.high - self.low)


# ------------------------------------------------------ learner connectors


class LearnerConnector:
    """One transform over a fragment dict of [T, N] columns (obs, actions,
    rewards, dones, truncs, valid, ...), applied before advantage
    estimation. Mutating a COPY keeps runner-side buffers intact."""

    def __call__(self, frag: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class LearnerConnectorPipeline(LearnerConnector):
    def __init__(self, connectors: Sequence[LearnerConnector]):
        self.connectors = list(connectors)

    def __call__(self, frag):
        for c in self.connectors:
            frag = c(frag)
        return frag


class ClipRewards(LearnerConnector):
    """Clip (or sign-compress) rewards before GAE/v-trace — the Atari
    convention (reference: learner pipeline reward clipping / the classic
    DQN sign(r))."""

    def __init__(self, bound: float = 1.0, sign: bool = False):
        self.bound = float(bound)
        self.sign = sign

    def __call__(self, frag):
        frag = dict(frag)
        r = np.asarray(frag["rewards"])
        frag["rewards"] = (np.sign(r) if self.sign
                           else np.clip(r, -self.bound, self.bound))
        return frag
