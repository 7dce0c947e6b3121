"""Durable workflow storage: step state on the file system (counterpart
of the JAX package's ``workflow/storage.py``, the same layout)::

    <root>/<workflow_id>/
        workflow.json          # status and times
        dag.pkl                # the pickled output DAGNode
        owner.json             # the driving process's heartbeat
        cancel.json            # a cancel request, while one stands
        events.jsonl           # the append-only lifecycle log
        steps/<step_id>.pkl    # a step's checkpointed result (or error)
        steps/<step_id>.json   # its state
        steps/<step_id>.sub/   # a continuation's own steps

Every write is atomic (a temporary file, then a rename), so a crash or a
reader never sees half a file. The driving process keeps ``owner.json``
fresh every ``HEARTBEAT_S``; a RUNNING workflow whose heartbeat is older
than ``LIVENESS_S`` has lost its driver and is resumable.

Divergences by design:

- The JAX package stores a DAG's remote functions and actor classes by
  value (``_DurablePickler``, through cloudpickle). The port pickles by
  reference with plain pickle (the card's machine has no cloudpickle):
  a ``@remote`` function or class goes by its module and name, with its
  options (``core/api.py`` ``_rebuild_remote``), so a stored workflow
  resumes only where its module-level functions and classes import by
  the same names. Results go by the core's rules
  (``core/serialization.py``: a CUDA tensor as its host copy, put back
  on the loading process's own device).
- The default root is the port's own, ``~/.ray_tpu_torch/workflows``
  (``RTPU_WORKFLOW_STORAGE`` over it), so ``list_all`` in one package
  never lists the other's runs, which it could not load.
"""
from __future__ import annotations

import json
import os
import pickle
import socket
import time
from typing import Any, Dict, List, Optional

from .. import flags
from ..core import serialization


def _write_json_atomic(path: str, obj: Any) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def default_storage_root() -> str:
    return flags.get("RTPU_WORKFLOW_STORAGE") or os.path.join(
        os.path.expanduser("~"), ".ray_tpu_torch", "workflows")


class WorkflowStorage:
    # A RUNNING status alone cannot tell "another process drives this
    # workflow now" (a second driver would run its steps twice) from "the
    # driver died mid-run" (resumable): the owner's heartbeat does.
    HEARTBEAT_S = 2.0
    LIVENESS_S = 10.0

    def __init__(self, workflow_id: str, root: Optional[str] = None):
        self.workflow_id = workflow_id
        self.root = root or default_storage_root()
        self.dir = os.path.join(self.root, workflow_id)

    def _ensure_dir(self) -> None:
        # Made at the first write: reads (get_status of an unknown id,
        # list_all) leave no empty directories behind.
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    # ---------------------------------------------------------- workflow

    def save_dag(self, node: Any, name: str = "dag.pkl", *,
                 exclusive: bool = False) -> None:
        """Store the DAG atomically; with ``exclusive`` the publish is a
        hard link, which fails with FileExistsError where another run
        claimed the id first (``workflow.run``'s claim)."""
        self._ensure_dir()
        path = os.path.join(self.dir, name)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(serialization.dumps(node))
            if exclusive:
                os.link(tmp, path)
            else:
                os.replace(tmp, path)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def load_dag(self, name: str = "dag.pkl") -> Any:
        with open(os.path.join(self.dir, name), "rb") as f:
            return pickle.load(f)

    def has_dag(self, name: str = "dag.pkl") -> bool:
        return os.path.exists(os.path.join(self.dir, name))

    def set_status(self, status: str) -> None:
        self._ensure_dir()
        meta = self.get_meta()
        meta["status"] = status
        meta.setdefault("created_at", time.time())
        if status in ("SUCCESSFUL", "FAILED", "CANCELED"):
            meta["finished_at"] = time.time()
        _write_json_atomic(os.path.join(self.dir, "workflow.json"), meta)

    def get_meta(self) -> Dict[str, Any]:
        path = os.path.join(self.dir, "workflow.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    # ------------------------------------------------- owner and cancel

    def _owner_path(self) -> str:
        return os.path.join(self.dir, "owner.json")

    def touch_owner(self) -> None:
        self._ensure_dir()
        _write_json_atomic(self._owner_path(),
                           {"pid": os.getpid(), "host": socket.gethostname(),
                            "ts": time.time()})

    def clear_owner(self) -> None:
        try:
            os.remove(self._owner_path())
        except OSError:
            pass

    def owner_alive(self) -> bool:
        try:
            with open(self._owner_path()) as f:
                ts = json.load(f).get("ts", 0)
        except (OSError, ValueError):
            return False
        return (time.time() - ts) < self.LIVENESS_S

    def request_cancel(self) -> None:
        self._ensure_dir()
        _write_json_atomic(os.path.join(self.dir, "cancel.json"),
                           {"ts": time.time()})

    def cancel_requested(self) -> bool:
        return os.path.exists(os.path.join(self.dir, "cancel.json"))

    def clear_cancel(self) -> None:
        try:
            os.remove(os.path.join(self.dir, "cancel.json"))
        except OSError:
            pass

    def log_event(self, event: str, **fields) -> None:
        self._ensure_dir()
        rec = {"ts": time.time(), "event": event, **fields}
        with open(os.path.join(self.dir, "events.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------- steps

    def _step_paths(self, step_id: str):
        base = os.path.join(self.dir, "steps", step_id)
        return base + ".pkl", base + ".json"

    def save_step_result(self, step_id: str, value: Any, *,
                         is_exception: bool = False) -> None:
        """The step's value (a continuation's DAGNode too), then its state:
        a state file never names a result that is not there."""
        self._ensure_dir()
        pkl, meta = self._step_paths(step_id)
        tmp = f"{pkl}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(serialization.dumps(value))
        os.replace(tmp, pkl)
        _write_json_atomic(meta, {
            "state": "FAILED" if is_exception else "SUCCESSFUL",
            "ts": time.time()})

    def step_state(self, step_id: str) -> Optional[str]:
        _, meta = self._step_paths(step_id)
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            return json.load(f).get("state")

    def load_step_result(self, step_id: str) -> Any:
        pkl, _ = self._step_paths(step_id)
        with open(pkl, "rb") as f:
            return pickle.load(f)

    def sub_storage(self, step_id: str) -> "WorkflowStorage":
        """The storage of one step's continuation, under the step."""
        sub = WorkflowStorage.__new__(WorkflowStorage)
        sub.workflow_id = self.workflow_id
        sub.root = self.root
        sub.dir = os.path.join(self.dir, "steps", step_id + ".sub")
        return sub


def list_workflows(root: Optional[str] = None) -> List[Dict[str, Any]]:
    root = root or default_storage_root()
    out: List[Dict[str, Any]] = []
    if not os.path.isdir(root):
        return out
    for wid in sorted(os.listdir(root)):
        meta_path = os.path.join(root, wid, "workflow.json")
        if not os.path.isfile(meta_path):
            continue  # not a workflow
        with open(meta_path) as f:
            out.append({"workflow_id": wid, **json.load(f)})
    return out
