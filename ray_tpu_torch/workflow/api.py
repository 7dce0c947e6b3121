"""The workflow API: run, resume and inspect durable DAG runs
(counterpart of the JAX package's ``workflow/api.py``, whole).

A workflow is a DAG of the port's ``.bind()`` layer (``dag/dag_node.py``)
plus durability: ``run`` claims the id by publishing the DAG (an
exclusive link: a second ``run`` of one id raises and points at
``resume`` and ``delete``), keeps the owner's heartbeat while it drives
the steps (``executor.py``) and stores the output; ``resume`` drives a
stored run again, its finished steps loaded from their checkpoints;
``get_status`` reads RESUMABLE for a RUNNING run whose heartbeat went
stale (its driver died); ``cancel`` stops a run between waves, in this
process at once and in another through the storage's cancel file.

A stored DAG goes by reference (``storage.py``): its remote functions
and classes must be importable by module and name where it resumes.
"""
from __future__ import annotations

import shutil
import threading
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ..dag.dag_node import DAGNode
from .executor import WorkflowCanceled, WorkflowExecutor
from .storage import WorkflowStorage, list_workflows

# The runs this process drives, so that cancel() interrupts them at once.
_running: Dict[str, threading.Event] = {}
_lock = threading.Lock()


def _execute(storage: WorkflowStorage, dag: DAGNode) -> Any:
    if storage.get_meta().get("status") == "RUNNING" and storage.owner_alive():
        raise RuntimeError(
            f"workflow {storage.workflow_id!r} is already being driven by "
            f"another process — concurrent execution would duplicate steps")
    cancel = threading.Event()
    with _lock:
        _running[storage.workflow_id] = cancel
    storage.clear_cancel()
    storage.touch_owner()
    hb_stop = threading.Event()

    def heartbeat():
        while not hb_stop.wait(storage.HEARTBEAT_S):
            storage.touch_owner()

    hb = threading.Thread(target=heartbeat, daemon=True,
                          name=f"wf-heartbeat-{storage.workflow_id}")
    hb.start()
    storage.set_status("RUNNING")
    try:
        result = WorkflowExecutor(storage, cancel).run(dag)
    except WorkflowCanceled:
        storage.set_status("CANCELED")
        raise
    except Exception:
        storage.set_status("FAILED")
        raise
    else:
        storage.save_step_result("__output__", result)
        storage.set_status("SUCCESSFUL")
        return result
    finally:
        hb_stop.set()
        storage.clear_owner()
        with _lock:
            _running.pop(storage.workflow_id, None)


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        storage: Optional[str] = None) -> Any:
    """Execute a DAG durably; blocks until the final output is computed."""
    if not isinstance(dag, DAGNode):
        raise TypeError("workflow.run expects a DAG node (use .bind())")
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:8]}"
    st = WorkflowStorage(workflow_id, storage)
    _claim_fresh(st, dag)
    return _execute(st, dag)


def _claim_fresh(st: WorkflowStorage, dag: DAGNode) -> None:
    """Atomically claim a workflow id by publishing its DAG.

    A second run() with the same id would overwrite dag.pkl while step
    checkpoints from the OLD dag still exist; colliding step ids would then
    replay stale results into the new DAG, so it raises and points at
    resume()/delete().
    The claim is an exclusive link (no check-then-act window), so two
    concurrent run() calls on one id cannot both start executing.
    """
    try:
        st.save_dag(dag, exclusive=True)
    except FileExistsError:
        raise ValueError(
            f"workflow {st.workflow_id!r} already exists "
            f"(status={st.get_meta().get('status')}). Use workflow.resume() "
            f"to continue it, or workflow.delete() before reusing the id."
        ) from None


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              storage: Optional[str] = None) -> Future:
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:8]}"
    st = WorkflowStorage(workflow_id, storage)
    _claim_fresh(st, dag)
    fut: Future = Future()

    def body():
        try:
            fut.set_result(_execute(st, dag))
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=body, daemon=True,
                     name=f"workflow-{workflow_id}").start()
    return fut


def resume(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    """Re-drive a stored workflow; completed steps load from checkpoints."""
    st = WorkflowStorage(workflow_id, storage)
    if not st.has_dag():
        raise ValueError(f"no stored workflow {workflow_id!r}")
    if st.get_meta().get("status") == "SUCCESSFUL":
        return st.load_step_result("__output__")
    return _execute(st, st.load_dag())


def resume_async(workflow_id: str, *, storage: Optional[str] = None) -> Future:
    fut: Future = Future()

    def body():
        try:
            fut.set_result(resume(workflow_id, storage=storage))
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=body, daemon=True).start()
    return fut


def get_status(workflow_id: str, *, storage: Optional[str] = None) -> str:
    st = WorkflowStorage(workflow_id, storage)
    status = st.get_meta().get("status")
    if status == "RUNNING" and not st.owner_alive():
        # The driving process (any process — liveness is heartbeat-based,
        # not this-process-based) died mid-run; the state is resumable.
        return "RESUMABLE"
    return status or "UNKNOWN"


def get_output(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    st = WorkflowStorage(workflow_id, storage)
    if st.get_meta().get("status") != "SUCCESSFUL":
        raise ValueError(
            f"workflow {workflow_id!r} has no output "
            f"(status={st.get_meta().get('status')})")
    return st.load_step_result("__output__")


def list_all(*, storage: Optional[str] = None) -> List[Dict[str, Any]]:
    rows = list_workflows(storage)
    for r in rows:
        if r.get("status") == "RUNNING" and not WorkflowStorage(
                r["workflow_id"], storage).owner_alive():
            r["status"] = "RESUMABLE"
    return rows


def cancel(workflow_id: str, *, storage: Optional[str] = None) -> None:
    st = WorkflowStorage(workflow_id, storage)
    if not st.has_dag():
        # No such workflow: writing cancel.json would litter an empty dir.
        return
    with _lock:
        ev = _running.get(workflow_id)
    if ev is not None:
        ev.set()  # in-process: interrupt between waves immediately
    st.request_cancel()  # cross-process: the owner's executor polls this
    if not st.owner_alive() and st.get_meta().get("status") == "RUNNING":
        st.set_status("CANCELED")


def delete(workflow_id: str, *, storage: Optional[str] = None) -> None:
    st = WorkflowStorage(workflow_id, storage)
    shutil.rmtree(st.dir, ignore_errors=True)
