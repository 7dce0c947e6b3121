"""Predictors: checkpoint -> batch inference.

The port's counterpart of the JAX package's ``train/predictor.py`` (the
reference's Predictor.from_checkpoint/predict). ``TorchPredictor`` takes
the place of ``JaxPredictor``: ``apply_fn(params, x)`` under
``torch.inference_mode`` on the port's device, numpy in and out.
``BatchPredictor`` runs one in each worker of a data pool, one card each.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .checkpoint import Checkpoint


class Predictor:
    """Base predictor: subclass and implement _predict_numpy."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, data: Union[Dict[str, np.ndarray], np.ndarray],
                **kwargs) -> Union[Dict[str, np.ndarray], np.ndarray]:
        single_col = not isinstance(data, dict)
        batch = {"__value__": data} if single_col else data
        out = self._predict_numpy(batch, **kwargs)
        if single_col and isinstance(out, dict) and set(out) == {"__value__"}:
            return out["__value__"]
        return out

    def _predict_numpy(self, batch: Dict[str, np.ndarray], **kwargs):
        raise NotImplementedError


def _to_device(tree: Any, device: torch.device) -> Any:
    """A tree (dicts, lists, tuples) of numpy arrays or tensors onto
    ``device`` as tensors."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, copy=True)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class TorchPredictor(Predictor):
    """Predictor over a function ``apply_fn(params, x)``, ``x`` a tensor on
    the predictor's device.

    The checkpoint holds {"params": tree} (tensors, or numpy arrays as the
    JAX package's trees convert); ``input_column`` selects the feature
    column, outputs land in ``output_column``. ``device=None`` is the
    current CUDA card, and raises without one.
    """

    def __init__(self, apply_fn: Callable[[Any, Any], Any], params: Any,
                 *, input_column: str = "__value__",
                 output_column: str = "predictions",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._apply = apply_fn
        self._params = _to_device(params, self.device)
        self._input_column = input_column
        self._output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        apply_fn: Callable[[Any, Any], Any],
                        **kwargs) -> "TorchPredictor":
        state = checkpoint.to_dict()
        params = state.get("params", state)
        return cls(apply_fn, params, **kwargs)

    def _predict_numpy(self, batch: Dict[str, np.ndarray], **kwargs):
        col = self._input_column
        if col not in batch:
            if len(batch) == 1:
                col = next(iter(batch))
            else:
                raise KeyError(
                    f"input column {self._input_column!r} not in batch "
                    f"columns {list(batch)}")
        x = _to_device(np.asarray(batch[col]), self.device)
        with torch.inference_mode():
            out = self._apply(self._params, x)
        out = out.detach().cpu().numpy()
        if self._input_column == "__value__" and col == "__value__":
            return {"__value__": out}
        return {**batch, self._output_column: out}


class _ScoringWorker:
    """The pool worker's UDF behind ``BatchPredictor.predict``: a predictor
    made from the checkpoint in the worker, on the worker's card. It is
    module-level, and takes what the reference's nested ``_ScoringActor``
    closes over as constructor arguments, because a pool worker receives
    its class by plain pickle, by reference."""

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 predictor_kwargs: Dict[str, Any],
                 predict_kwargs: Dict[str, Any]):
        self.predictor = predictor_cls.from_checkpoint(checkpoint,
                                                       **predictor_kwargs)
        self._predict_kwargs = predict_kwargs

    def __call__(self, batch):
        return self.predictor.predict(batch, **self._predict_kwargs)


class BatchPredictor:
    """Scalable inference: a predictor in each pool worker, over
    ``Dataset.map_batches``.

    The reference's ``train/batch_predictor.py`` (predict -> map_batches
    on an actor pool). Each worker takes one card (``num_gpus_per_actor``,
    default 1): ask for the CPU with ``num_gpus_per_actor=0`` and the
    predictor's ``device="cpu"``. Asking for more cards than are visible,
    or for a card without CUDA, raises before any worker is spawned.
    """

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    def predict(
        self,
        dataset,
        *,
        batch_size: int = 4096,
        min_scoring_workers: int = 1,
        max_scoring_workers: int = 1,
        num_gpus_per_actor: float = 1,
        **predict_kwargs,
    ):
        return dataset.map_batches(
            _ScoringWorker,
            batch_size=batch_size,
            concurrency=(min_scoring_workers, max_scoring_workers),
            num_gpus=num_gpus_per_actor,
            fn_constructor_args=(self._checkpoint, self._predictor_cls,
                                 self._predictor_kwargs, predict_kwargs),
        )
