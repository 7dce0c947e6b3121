"""ray_tpu_torch.train: the Train layer of the port.

The JAX package's ``ray_tpu.train`` names: ``DataParallelTrainer`` and
``TorchTrainer`` (the counterpart of ``JaxTrainer``) on the port's own
worker processes, their backends, configs, session, checkpoints,
callbacks and predictors. Every name loads with its module at first use,
as the reference's ``ShardedTrainStep``/``transformer_train_step`` do:
a process that needs only the configs or a dict checkpoint (a Tune trial
running numpy, a worker running a numpy loop) never loads torch or the
model code.
"""
import importlib

_EXPORTS = {
    "Backend": "backend",
    "HostCollectiveBackend": "backend",
    "TorchBackend": "backend",
    "CallbackList": "callbacks",
    "JsonLineLogger": "callbacks",
    "ProgressPrinter": "callbacks",
    "TrainCallback": "callbacks",
    "TransformersCallbackAdapter": "callbacks",
    "BackendExecutor": "backend_executor",
    "TrainingFailedError": "backend_executor",
    "TrainingIterator": "backend_executor",
    "Checkpoint": "checkpoint",
    "CheckpointConfig": "config",
    "FailureConfig": "config",
    "RunConfig": "config",
    "ScalingConfig": "config",
    "DataParallelTrainer": "data_parallel_trainer",
    "Result": "data_parallel_trainer",
    "TorchTrainer": "data_parallel_trainer",
    "BatchPredictor": "predictor",
    "Predictor": "predictor",
    "TorchPredictor": "predictor",
    "get_checkpoint": "session",
    "get_context": "session",
    "get_dataset_shard": "session",
    "get_mesh": "session",
    "report": "session",
    "CheckpointManager": "storage",
    "StorageContext": "storage",
    "RayTrainWorker": "worker_group",
    "WorkerGroup": "worker_group",
    "ShardedTrainStep": "step",
    "transformer_train_step": "step",
}
_SUBMODULES = frozenset(_EXPORTS.values())


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
