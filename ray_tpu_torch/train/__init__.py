"""ray_tpu_torch.train: the Train layer of the port.

The JAX package's ``ray_tpu.train`` names: ``DataParallelTrainer`` and
``TorchTrainer`` (the counterpart of ``JaxTrainer``) on the port's own
worker processes, their backends, configs, session, checkpoints,
callbacks and predictors. ``ShardedTrainStep``/``transformer_train_step``
load lazily, as the reference's do: a worker that runs a numpy loop needs
no model code.
"""
from .backend import Backend, HostCollectiveBackend, TorchBackend
from .callbacks import (CallbackList, JsonLineLogger, ProgressPrinter,
                        TrainCallback, TransformersCallbackAdapter)
from .backend_executor import BackendExecutor, TrainingFailedError, TrainingIterator
from .checkpoint import Checkpoint
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from .data_parallel_trainer import DataParallelTrainer, Result, TorchTrainer
from .predictor import BatchPredictor, Predictor, TorchPredictor
from .session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_mesh,
    report,
)
from .storage import CheckpointManager, StorageContext
from .worker_group import RayTrainWorker, WorkerGroup


def __getattr__(name):
    if name in ("ShardedTrainStep", "transformer_train_step"):
        from . import step

        return getattr(step, name)
    raise AttributeError(name)


__all__ = [
    "Backend",
    "BackendExecutor",
    "BatchPredictor",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "DataParallelTrainer",
    "FailureConfig",
    "HostCollectiveBackend",
    "Predictor",
    "RayTrainWorker",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "ShardedTrainStep",
    "StorageContext",
    "TorchBackend",
    "TorchPredictor",
    "TorchTrainer",
    "TrainingFailedError",
    "TrainingIterator",
    "WorkerGroup",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "get_mesh",
    "report",
    "transformer_train_step",
]
