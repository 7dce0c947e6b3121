"""Dataset preprocessors: fit/transform over numpy batches.

The port's copy of the JAX package's ``data/preprocessors.py`` (reference:
python/ray/data/preprocessors/ — Preprocessor base with
fit/transform/transform_batch, BatchMapper, StandardScaler, Chain,
TorchVisionPreprocessor). Every transform is a numpy batch function,
numpy in and numpy out with the reference's dtypes, applied through
``Dataset.map_batches``: preprocessing fuses into the task stage that
feeds the pool of card workers (BASELINE.json config 5).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]


class Preprocessor:
    """fit() computes statistics over a Dataset; transform() applies the
    batch function lazily via map_batches; transform_batch() applies it to
    one in-memory batch (the serve/inference path)."""

    _fitted = True  # stateless by default

    def fit(self, ds) -> "Preprocessor":
        self._fitted = True
        return self

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform(self, ds):
        if not self._fitted:
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return ds.map_batches(self.transform_batch, batch_format="numpy")

    def transform_batch(self, batch: Batch) -> Batch:
        raise NotImplementedError


class BatchMapper(Preprocessor):
    """Wrap a plain numpy-batch function (reference BatchMapper)."""

    def __init__(self, fn: Callable[[Batch], Batch]):
        self.fn = fn

    def transform_batch(self, batch: Batch) -> Batch:
        return self.fn(batch)


class Chain(Preprocessor):
    def __init__(self, *stages: Preprocessor):
        self.stages = stages

    def fit(self, ds) -> "Preprocessor":
        # Each stage fits on the data as transformed by the previous ones
        # (reference Chain semantics).
        for i, st in enumerate(self.stages):
            st.fit(ds)
            if i < len(self.stages) - 1:
                ds = st.transform(ds)
        return self

    def transform_batch(self, batch: Batch) -> Batch:
        for st in self.stages:
            batch = st.transform_batch(batch)
        return batch


class StandardScaler(Preprocessor):
    """Column-wise (x - mean) / std, statistics from fit()."""

    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.stats: Dict[str, Tuple[float, float]] = {}
        self._fitted = False

    def fit(self, ds) -> "Preprocessor":
        agg = {c: [0.0, 0.0, 0] for c in self.columns}  # sum, sumsq, n
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                v = np.asarray(batch[c], np.float64)
                agg[c][0] += float(v.sum())
                agg[c][1] += float((v * v).sum())
                agg[c][2] += v.size
        for c, (s, sq, n) in agg.items():
            mean = s / max(n, 1)
            var = max(sq / max(n, 1) - mean * mean, 0.0)
            self.stats[c] = (mean, float(np.sqrt(var)) or 1.0)
        self._fitted = True
        return self

    def transform_batch(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats[c]
            out[c] = (np.asarray(batch[c], np.float32) - mean) / (std + 1e-8)
        return out


class ImageNormalizer(Preprocessor):
    """uint8 [B,H,W,C] images -> float32, scaled to [0,1], then per-channel
    (x - mean) / std — the torchvision Normalize recipe in numpy
    (reference TorchVisionPreprocessor's common use)."""

    def __init__(self, mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225),
                 column: str = "image"):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.column = column

    def transform_batch(self, batch: Batch) -> Batch:
        out = dict(batch)
        img = np.asarray(batch[self.column], np.float32) / 255.0
        out[self.column] = (img - self.mean) / self.std
        return out


class LabelEncoder(Preprocessor):
    """String labels -> int codes (reference LabelEncoder)."""

    def __init__(self, column: str):
        self.column = column
        self.classes_: Dict[Any, int] = {}
        self._fitted = False

    def fit(self, ds) -> "Preprocessor":
        seen = set()
        for batch in ds.iter_batches(batch_format="numpy"):
            seen.update(np.asarray(batch[self.column]).tolist())
        self.classes_ = {v: i for i, v in enumerate(sorted(seen))}
        self._fitted = True
        return self

    def transform_batch(self, batch: Batch) -> Batch:
        out = dict(batch)
        out[self.column] = np.asarray(
            [self.classes_[v] for v in
             np.asarray(batch[self.column]).tolist()], np.int64)
        return out
