"""Driver-side orchestration of the training worker gang.

The port's counterpart of the JAX package's ``train/backend_executor.py``
(the reference's BackendExecutor and TrainingIterator with its restart
loop). Failure policy: any worker error, or a worker that dies, tears the
whole group down and restarts from the latest checkpoint, up to
FailureConfig.max_failures: fixed-size worlds per attempt, like the
reference. There is no placement group: the workers are processes of this
host, and ``WorkerGroup`` checks the card count before it spawns any.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .backend import Backend, HostCollectiveBackend
from .checkpoint import Checkpoint
from .config import ScalingConfig
from .session import TrainContext
from .storage import CheckpointManager, StorageContext
from .worker_group import WorkerDiedError, WorkerGroup


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(
        self,
        scaling_config: ScalingConfig,
        backend: Optional[Backend] = None,
        storage: Optional[StorageContext] = None,
        checkpoint_manager: Optional[CheckpointManager] = None,
    ):
        self.scaling = scaling_config
        self.backend = backend or HostCollectiveBackend()
        self.storage = storage
        self.ckpt_manager = checkpoint_manager
        self.worker_group: Optional[WorkerGroup] = None

    # ---------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.worker_group = WorkerGroup(
            self.scaling.num_workers,
            resources_per_worker=self.scaling.worker_resources(),
        )
        self.backend.on_start(self.worker_group)

    def shutdown(self) -> None:
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group)
            finally:
                self.worker_group.shutdown()
                self.worker_group = None

    # ----------------------------------------------------------------- training

    def start_training(
        self,
        train_fn: Callable,
        config: Optional[Dict[str, Any]],
        checkpoint: Optional[Checkpoint],
        dataset_shard_fn: Optional[Callable[[int, int], Dict[str, Any]]] = None,
        experiment_name: str = "",
        trial_name: str = "",
    ) -> None:
        wg = self.worker_group
        assert wg is not None
        n = len(wg)
        args = []
        for m in wg.workers:
            ctx = TrainContext(
                world_size=n,
                world_rank=m.world_rank,
                local_rank=m.local_rank,
                local_world_size=sum(1 for x in wg.workers if x.node_id == m.node_id),
                node_rank=m.node_rank,
                experiment_name=experiment_name,
                trial_name=trial_name,
            )
            shards = dataset_shard_fn(m.world_rank, n) if dataset_shard_fn else None
            args.append((ctx, checkpoint, shards))
        wg.call("init_session", args)
        self.backend.on_training_start(wg)
        wg.foreach("start_training", train_fn, config)

    def fetch_results(self, ranks: Sequence[int],
                      poll_timeout: float = 5.0) -> List[Dict[str, Any]]:
        """One polling round across ``ranks``; returns the drained items. A
        worker that died becomes an error item naming its rank and exit
        code."""
        wg = self.worker_group
        assert wg is not None
        try:
            got = wg.poll(ranks, "next_result", poll_timeout)
        except WorkerDiedError as e:
            return [{"type": "error", "rank": e.rank, "error": str(e)}]
        return [got[r] for r in sorted(got) if got[r] is not None]

    def finish(self) -> None:
        if self.worker_group is not None:
            self.worker_group.foreach("finish")


class TrainingIterator:
    """Runs attempts until success or FailureConfig budget exhausted."""

    def __init__(
        self,
        *,
        scaling_config: ScalingConfig,
        backend: Backend,
        train_fn: Callable,
        config: Optional[Dict[str, Any]],
        storage: StorageContext,
        checkpoint_manager: CheckpointManager,
        max_failures: int = 0,
        resume_checkpoint: Optional[Checkpoint] = None,
        dataset_shard_fn: Optional[Callable] = None,
        on_report: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.scaling_config = scaling_config
        self.backend = backend
        self.train_fn = train_fn
        self.config = config
        self.storage = storage
        self.ckpt_manager = checkpoint_manager
        self.max_failures = max_failures
        self.resume_checkpoint = resume_checkpoint
        self.dataset_shard_fn = dataset_shard_fn
        self.on_report = on_report
        self.failures = 0
        self.latest_metrics: Dict[str, Any] = {}
        # Seconds from each attempt's start to its workers answering.
        self.spawn_s: List[float] = []

    def run(self) -> Dict[str, Any]:
        while True:
            executor = BackendExecutor(self.scaling_config, self.backend, self.storage,
                                       self.ckpt_manager)
            try:
                executor.start()
                self.spawn_s.append(executor.worker_group.spawn_s)
                executor.start_training(
                    self.train_fn,
                    self.config,
                    self._restore_checkpoint(),
                    self.dataset_shard_fn,
                    experiment_name=self.storage.experiment_name,
                    trial_name=self.storage.trial_name,
                )
                self._drain(executor)
                executor.finish()
                return self.latest_metrics
            except TrainingFailedError:
                self.failures += 1
                if self.max_failures >= 0 and self.failures > self.max_failures:
                    raise
                time.sleep(0.5)  # back off, then restart from latest checkpoint
            finally:
                executor.shutdown()

    def _restore_checkpoint(self) -> Optional[Checkpoint]:
        tracked = self.ckpt_manager.latest
        if tracked is not None:
            return tracked.checkpoint
        return self.resume_checkpoint

    def _drain(self, executor: BackendExecutor) -> None:
        n = executor.scaling.num_workers
        done_ranks: set = set()
        while len(done_ranks) < n:
            live = [r for r in range(n) if r not in done_ranks]
            try:
                items = executor.fetch_results(live)
            except Exception as e:
                raise TrainingFailedError(f"worker poll failed: {e!r}") from e
            for item in items:
                t = item["type"]
                if t == "error":
                    raise TrainingFailedError(
                        f"worker rank {item['rank']} failed:\n{item.get('traceback', item['error'])}"
                    )
                if t == "done":
                    done_ranks.add(item["rank"])
                elif t == "report":
                    if item["rank"] == 0:
                        self.latest_metrics = dict(item["metrics"])
                        self.latest_metrics.setdefault(
                            "training_iteration", item["iteration"])
                    # Rank 0's checkpoint is canonical (other ranks' are
                    # dropped — reference convention).
                    ckpt = item.get("checkpoint")
                    if ckpt is not None and item["rank"] == 0:
                        self.ckpt_manager.register(ckpt, item["metrics"])
                    if self.on_report is not None and item["rank"] == 0:
                        self.on_report(item)
