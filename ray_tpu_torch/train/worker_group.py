"""The process group forming the training world.

The port's counterpart of the JAX package's ``train/worker_group.py``
(there N actors of the control plane, gang-scheduled in a placement
group). Here the workers are processes of one host, started with
``multiprocessing``'s spawn method (CUDA cannot be used in a forked
child), one card each on the card: a ``torchrun``-style world, PyTorch's
own process model. World rank is the spawn order; ``local_rank`` equals
it, ``node_rank`` is 0 and ``node_id`` is the host name.

Each worker runs ``RayTrainWorker``'s methods from a command loop over a
pipe (``util/procs.py``, shared with the data layer's pool workers): the
trainer process (the one that calls ``fit()``) sends ``(seq,
method, args, kwargs)`` pickled, the worker answers ``(seq, "ok",
result)`` or ``(seq, "err", traceback)``. The train loop runs on a thread
of the worker, and its results go through the session's queue, as in the
reference. Functions travel by plain ``pickle``, by reference (the
reference uses cloudpickle): train loops and backend hooks are
module-level functions. A worker that dies sends nothing: the trainer
process watches every worker's sentinel while it waits and raises
:class:`WorkerDiedError` naming the rank and exit code.
"""
from __future__ import annotations

import multiprocessing
import queue
import socket
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..util import procs
from .session import TrainContext, _get_session, _init_session, _shutdown_session


class WorkerDiedError(RuntimeError):
    """A worker process exited while the trainer process waited on
    it."""

    def __init__(self, rank: int, exitcode: Optional[int]):
        super().__init__(f"train worker rank {rank} died (exit code "
                         f"{exitcode})")
        self.rank = rank
        self.exitcode = exitcode


class WorkerError(RuntimeError):
    """A call raised on a worker; carries the worker's traceback text (the
    exception object itself may not pickle)."""

    def __init__(self, rank: int, method: str, tb: str):
        super().__init__(f"train worker rank {rank}: {method} failed:\n{tb}")
        self.rank = rank


class RayTrainWorker:
    """The per-worker object hosting the user's train loop: a shell that
    executes functions, with the training thread and session queue of the
    reference's worker."""

    def __init__(self, card: Optional[int] = None) -> None:
        self._card = card  # this worker's CUDA card, None on the CPU
        self._thread: Optional[threading.Thread] = None

    # Generic execution (backend hooks, probes).
    def execute(self, fn: Callable, *args, **kwargs) -> Any:
        return fn(*args, **kwargs)

    def node_id(self) -> str:
        return socket.gethostname()

    def join_collective(self, world_size: int, rank: int, backend: str,
                        group_name: str, store_address: Optional[str] = None
                        ) -> None:
        from ..util import collective

        collective.init_collective_group(world_size, rank, backend,
                                         group_name, store_address)

    # ------------------------------------------------------------- train loop

    def init_session(self, context: TrainContext, checkpoint=None, dataset_shards=None) -> None:
        _init_session(context, checkpoint, dataset_shards)

    def setup_session_extras(self, collective_group: Optional[str] = None) -> None:
        _get_session().collective_group = collective_group

    def start_training(self, train_fn: Callable, config: Optional[Dict[str, Any]]) -> None:
        s = _get_session()

        def run() -> None:
            if self._card is not None:
                # The current card is the thread's own (cudaSetDevice): a
                # new thread starts on card 0, where a collective's
                # buffers would land on another rank's card.
                torch.cuda.set_device(self._card)
            try:
                if config is not None:
                    train_fn(config)
                else:
                    train_fn()
                s.results.put({"type": "done", "rank": s.context.world_rank})
            except StopIteration:
                s.results.put({"type": "done", "rank": s.context.world_rank})
            except BaseException as e:  # noqa: BLE001 — surfaced to the trainer
                s.results.put({
                    "type": "error",
                    "rank": s.context.world_rank,
                    "error": repr(e),
                    "traceback": traceback.format_exc(),
                })

        self._thread = threading.Thread(target=run, name="train-loop", daemon=True)
        self._thread.start()

    def next_result(self, timeout: float = 10.0) -> Optional[Dict[str, Any]]:
        """Drain one queued result; None when nothing arrived in `timeout`."""
        s = _get_session(strict=False)
        if s is None:
            return None
        try:
            item = s.results.get(timeout=timeout)
        except queue.Empty:
            return None
        if item.get("type") == "report" and item.get("checkpoint") is not None:
            # The trainer process persists it; ship the local path (one
            # host: it copies the directory by path).
            item["checkpoint_path"] = item["checkpoint"].path
        return item

    def request_stop(self) -> None:
        s = _get_session(strict=False)
        if s is not None:
            s.stop_requested = True

    def finish(self) -> None:
        if self._thread is not None:
            self._thread.join(timeout=30)
        _shutdown_session()


def _worker_main(conn, rank: int, device_type: str) -> None:
    """A worker process: take this rank's card, then serve commands until
    the trainer process sends None or goes away."""
    if device_type == "cuda":
        procs.take_card(rank)
    procs.serve(conn, lambda: RayTrainWorker(
        rank if device_type == "cuda" else None))


def dumps(what: str, obj: Any) -> bytes:
    """``obj`` pickled for a worker; a function that plain pickle cannot
    send by reference raises here, in the trainer process, saying
    why."""
    return procs.dumps(obj, what, "train worker processes",
                       "define the train loop and any function it is given "
                       "at module level, not inside a function or as a "
                       "lambda")


def _encode(msg: Tuple) -> bytes:
    return dumps(msg[1], msg)


class _WorkerProcess(procs.Worker):
    """The trainer process's handle on one worker process."""

    def __init__(self, ctx, rank: int, device_type: str):
        super().__init__(ctx, _worker_main, (rank, device_type),
                         f"rtpu-train-worker-{rank}", encode=_encode)
        self.rank = rank


@dataclass
class WorkerMetadata:
    process: _WorkerProcess
    node_id: str
    world_rank: int = -1
    local_rank: int = -1
    node_rank: int = -1


def _worker_device(num_workers: int, res: Dict[str, float]) -> str:
    """The workers' device type: ``cuda`` where they ask for a ``GPU``;
    raises, before anything is spawned, where the cards cannot give one
    card to each worker."""
    gpus = res.get("GPU", 0)
    if not gpus:
        return "cpu"
    if gpus > 1:
        raise ValueError(
            f"a worker asks for {gpus} cards: the port runs one process a "
            "card, so each worker takes exactly one")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the workers on the CPU")
    cards = torch.cuda.device_count()
    if num_workers > cards:
        raise ValueError(f"{num_workers} workers need {num_workers} cards, "
                         f"{cards} visible: each worker takes one card")
    return "cuda"


class WorkerGroup:
    """Spawn and address a gang of worker processes: one card each where
    ``resources_per_worker`` asks for a ``GPU``, else on the CPU."""

    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Optional[Dict[str, float]] = None,
    ):
        res = dict(resources_per_worker or {"CPU": 1})
        self.device_type = _worker_device(num_workers, res)
        self.num_workers = num_workers
        self.workers: List[WorkerMetadata] = []
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        started: List[_WorkerProcess] = []
        try:
            for rank in range(num_workers):
                started.append(_WorkerProcess(ctx, rank, self.device_type))
            self.workers = [WorkerMetadata(process=p, node_id="",
                                           world_rank=p.rank,
                                           local_rank=p.rank, node_rank=0)
                            for p in started]
            for m, node in zip(self.workers, self.foreach("node_id")):
                m.node_id = node
        except BaseException:
            self.workers = [WorkerMetadata(process=p, node_id="")
                            for p in started]
            self.shutdown()
            raise
        # Spawn to every worker answering: interpreter, imports, card.
        self.spawn_s = time.perf_counter() - t0

    # ------------------------------------------------------------------ calls

    def call(self, method: str, args_by_rank: Sequence[Tuple],
             timeout: Optional[float] = None) -> List[Any]:
        """``method(*args_by_rank[r])`` on every worker r at once; the
        results in rank order."""
        seqs = {m.world_rank: m.process.send(method, args, {})
                for m, args in zip(self.workers, args_by_rank)}
        got = self._gather(method, seqs, timeout)
        return [got[r] for r in sorted(got)]

    def foreach(self, method: str, *args, **kwargs) -> List[Any]:
        seqs = {m.world_rank: m.process.send(method, args, kwargs)
                for m in self.workers}
        got = self._gather(method, seqs, None)
        return [got[r] for r in sorted(got)]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return self.foreach("execute", fn, *args, **kwargs)

    def poll(self, ranks: Sequence[int], method: str, *args) -> Dict[int, Any]:
        """``method(*args)`` on the given ranks; rank -> result."""
        seqs = {r: self.workers[r].process.send(method, args, {}) for r in ranks}
        return self._gather(method, seqs, None)

    def _gather(self, method: str, seqs: Dict[int, int],
                timeout: Optional[float]) -> Dict[int, Any]:
        """Wait for the replies numbered ``seqs`` (rank -> seq) and return
        rank -> result. Raises :class:`WorkerError` for a call that raised,
        and :class:`WorkerDiedError` as soon as any worker of the group is
        dead (its peers may be waiting on it in a collective). A stale
        reply, of a call abandoned after an error, is dropped."""
        pending = dict(seqs)
        results: Dict[int, Any] = {}
        deadline = None if timeout is None else time.monotonic() + timeout
        workers = [m.process for m in self.workers]
        while pending:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"{method}: ranks {sorted(pending)} did "
                                   f"not answer in {timeout} s")
            replies, dead = procs.wait(workers, left)
            for w, seq, status, value in replies:
                if pending.get(w.rank) != seq:
                    continue
                del pending[w.rank]
                if status == "err":
                    raise WorkerError(w.rank, method, value)
                results[w.rank] = value
            if dead:
                w = min(dead, key=lambda w: w.rank)
                raise WorkerDiedError(w.rank, w.exitcode())
        return results

    # -------------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        """Ask every worker to leave; join each with a bounded timeout,
        then terminate it, then kill it. No process is left behind."""
        procs.stop(m.process for m in self.workers)
        self.workers = []

    def __len__(self) -> int:
        return len(self.workers)
