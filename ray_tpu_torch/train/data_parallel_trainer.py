"""DataParallelTrainer + TorchTrainer + Result.

The port's counterpart of the JAX package's
``train/data_parallel_trainer.py`` (the reference's BaseTrainer.fit and
DataParallelTrainer): ``fit()`` drives the TrainingIterator directly.
``TorchTrainer`` takes the place of ``JaxTrainer``: one worker process a
card, one ``torch.distributed`` world over them, and a ``DeviceMesh`` that
``ray_tpu_torch.train.get_mesh()`` hands to the loop, which runs the
port's sharded train step on it.

The train loop goes to the workers by pickle, by reference: it is a
module-level function (the reference sends closures with cloudpickle).
``fit`` checks that before it starts any worker. ``as_trainable`` makes
the trainer a Tune trainable (``ray_tpu_torch.tune``): a trial runs
``fit()``, each rank-0 report an intermediate Tune result.
"""
from __future__ import annotations

import dataclasses
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from .backend import Backend, HostCollectiveBackend, TorchBackend
from .backend_executor import TrainingFailedError, TrainingIterator
from .checkpoint import Checkpoint
from .config import RunConfig, ScalingConfig
from .storage import CheckpointManager, StorageContext
from .worker_group import dumps


@dataclass
class Result:
    """Terminal metrics + best/latest checkpoint. ``spawn_s``: each
    attempt's seconds from its start to every worker answering."""

    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None
    best_checkpoints: list = field(default_factory=list)
    spawn_s: List[float] = field(default_factory=list)


class DataParallelTrainer:
    """SPMD function trainer: run `train_loop_per_worker` on N workers.

    Gradient sync strategy is the worker function's business: host
    collectives for CPU smoke (util.collective), the sharded train step's
    collectives on the cards (the loop just calls ``step``).
    """

    _default_backend_cls = HostCollectiveBackend

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        backend: Optional[Backend] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.backend = backend or self._default_backend_cls()
        self.resume_from_checkpoint = resume_from_checkpoint

    # ------------------------------------------------------------------- fit

    def fit(self) -> Result:
        # Before any worker starts: the loop, its config and the datasets
        # every rank gets as they are (split iterators, say) go by pickle.
        dumps("train_loop_per_worker", self.train_loop_per_worker)
        dumps("train_loop_config", self.train_loop_config)
        for k, ds in self.datasets.items():
            if not hasattr(ds, "split_shard"):
                dumps(f"datasets[{k!r}]", ds)
        name = self.run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        storage = StorageContext(
            storage_path=self.run_config.resolved_storage_path(),
            experiment_name=name,
        )
        ckpt_manager = CheckpointManager(storage, self.run_config.checkpoint_config)
        from .callbacks import CallbackList

        cbs = CallbackList(self.run_config.callbacks)
        tune_hook = getattr(self, "_tune_report_hook", None)
        report_count = [0]

        def on_report(item: Dict[str, Any]) -> None:
            report_count[0] += 1
            cbs.on_report(report_count[0], dict(item.get("metrics") or {}),
                          item.get("checkpoint"))
            if tune_hook is not None:
                tune_hook(item)

        iterator = TrainingIterator(
            scaling_config=self.scaling_config,
            backend=self.backend,
            train_fn=self.train_loop_per_worker,
            config=self.train_loop_config,
            storage=storage,
            checkpoint_manager=ckpt_manager,
            max_failures=self.run_config.failure_config.max_failures,
            resume_checkpoint=self.resume_from_checkpoint,
            dataset_shard_fn=self._dataset_shard_fn(),
            on_report=on_report,
        )
        error: Optional[BaseException] = None
        metrics: Dict[str, Any] = {}
        cbs.on_start(self.train_loop_config)
        try:
            metrics = iterator.run()
        except TrainingFailedError as e:
            error = e
        cbs.on_end(metrics, error)
        best = ckpt_manager.best
        result = Result(
            metrics=metrics,
            checkpoint=best.checkpoint if best else None,
            path=storage.trial_dir,
            error=error,
            best_checkpoints=[(t.checkpoint, t.metrics) for t in ckpt_manager.tracked],
            spawn_s=iterator.spawn_s,
        )
        if error is not None:
            raise TrainingFailedError(str(error)) from error
        return result

    # --------------------------------------------------------------- datasets

    def _dataset_shard_fn(self) -> Optional[Callable]:
        if not self.datasets:
            return None
        datasets = self.datasets
        materialized: Dict[str, Any] = {}

        def shard(rank: int, world_size: int) -> Dict[str, Any]:
            out = {}
            for k, ds in datasets.items():
                if hasattr(ds, "split_shard"):
                    # Execute the pipeline ONCE and shard the result:
                    # per-rank re-execution would hand ranks shards of
                    # *different* runs.
                    if k not in materialized:
                        materialized[k] = ds.materialize()
                    out[k] = materialized[k].split_shard(rank, world_size)
                else:
                    out[k] = ds
            return out

        return shard

    # ------------------------------------------------------------- tune glue

    def as_trainable(self) -> type:
        """Wrap into a Tune trainable class (reference:
        base_trainer._generate_trainable_cls :693)."""
        from ..tune.trainable import wrap_trainer_as_trainable

        return wrap_trainer_as_trainable(self)


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer whose backend forms one ``torch.distributed``
    world and a ``DeviceMesh`` on every worker.

    Each worker runs on its own card (``device=None`` or ``"cuda"``; raises
    when CUDA is absent or the cards are fewer than the workers) unless the
    caller passes ``device="cpu"`` (gloo). ``mesh_shape`` is a
    ``MeshSpec``'s axes (default: every rank on ``data``).
    """

    def __init__(self, *args, mesh_shape: Optional[Dict[str, int]] = None,
                 device: Optional[str] = None, **kwargs):
        device_type = torch.device(device or "cuda").type
        if device_type not in ("cuda", "cpu"):
            raise ValueError(f"device {device!r}: the workers run on 'cuda' "
                             "(one card each) or on 'cpu'")
        kwargs.setdefault("backend", TorchBackend(mesh_shape=mesh_shape))
        super().__init__(*args, **kwargs)
        self.scaling_config = dataclasses.replace(
            self.scaling_config, use_gpu=device_type == "cuda")
