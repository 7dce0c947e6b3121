"""The workflow executor: the DAG in waves, each step's value
checkpointed (counterpart of the JAX package's ``workflow/executor.py``,
its wave executor ``:66-202`` kept as it is).

- a step's value is checkpointed before its dependents take it, so a
  resume never runs a finished step again;
- independent steps run together: every ready step is submitted, and
  the finished ones are taken with ``wait``;
- a step that returns a DAG node is a continuation: the step is
  checkpointed with the node as its value before the node is driven,
  under the step's own storage (``sub_storage``), and its output becomes
  the step's value;
- ``catch_exceptions`` on a step turns its outcome into ``(result,
  None)`` or ``(None, exception)`` (of a continuation, its final value);
- a step of ``num_returns`` n is its list of values, one of 0 is None;
- a cancel request stops the run between waves;
- task retries (``max_retries``) are the core's (``core/api.py``).

One divergence: the run waits for the steps still in flight once none
is left to submit, where the JAX package's loop ends and raises a
KeyError for a last step that takes more than its one-second wait
(``ray_tpu/workflow/executor.py:98``, ``:189``).

Step ids come from :func:`assign_step_ids`: the DAG's topological order
and each node's name, so the same DAG gives the same ids in any process,
which is what lets a resumed run find its checkpoints.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..core import api
from ..dag.dag_node import (ClassMethodNode, ClassNode, DAGNode,
                            FunctionNode, InputAttributeNode, InputNode,
                            MultiOutputNode)
from .storage import WorkflowStorage


class WorkflowCanceled(RuntimeError):
    pass


def _catches(node: DAGNode) -> bool:
    fn_opts = getattr(getattr(node, "_remote_fn", None), "_options", {}) or {}
    return bool(getattr(node, "_options", {}).get("catch_exceptions")
                or fn_opts.get("catch_exceptions"))


def assign_step_ids(output: DAGNode) -> Dict[int, str]:
    """Stable ids: topological position + a human hint."""
    ids: Dict[int, str] = {}
    counts: Dict[str, int] = {}
    for node in output.topological():
        hint = node._name_hint()
        n = counts.get(hint, 0)
        counts[hint] = n + 1
        ids[id(node)] = f"{hint}.{n}"
    return ids


class WorkflowExecutor:
    def __init__(self, storage: WorkflowStorage,
                 cancel_event: Optional[threading.Event] = None):
        self.storage = storage
        self.cancel_event = cancel_event or threading.Event()

    # The executor walks the DAG in dependency waves. ``memo`` maps node id
    # -> computed *value* (not ref): workflow steps are checkpointed at the
    # driver, so values are already local when dependents are submitted.
    def run(self, output: DAGNode, run_input=((), {})) -> Any:
        ids = assign_step_ids(output)
        nodes = output.topological()
        memo: Dict[int, Any] = {"__input__": run_input}

        # Dependency bookkeeping over checkpointable nodes.
        pending: Dict[int, DAGNode] = {id(n): n for n in nodes}
        inflight: Dict[str, tuple] = {}  # object id str -> (node, ref)

        def checkpointable(n: DAGNode) -> bool:
            return isinstance(n, (FunctionNode, ClassMethodNode))

        def deps_ready(n: DAGNode) -> bool:
            return all(id(u) in memo for u in n._upstream())

        def resolve_local(n: DAGNode) -> Any:
            """Evaluate non-task nodes (input selectors, actor creation).

            Passing the live memo is safe: every upstream is already
            resolved, so _execute_memo only reads (plus writes this node's
            own entry, which the caller overwrites with the same value).
            """
            if isinstance(n, InputNode) or isinstance(n, InputAttributeNode) \
                    or isinstance(n, MultiOutputNode) or isinstance(n, ClassNode):
                return n._execute_memo(memo)
            raise AssertionError(type(n))

        # Until every step has run: the JAX package's loop (``while
        # pending``) ends once nothing waits to be submitted, and a last
        # step still in flight after its one-second wait leaves the output
        # unset (KeyError).
        while pending or inflight:
            if self.cancel_event.is_set() or self.storage.cancel_requested():
                raise WorkflowCanceled(self.storage.workflow_id)
            progressed = False
            for nid, node in list(pending.items()):
                if not deps_ready(node):
                    continue
                step_id = ids[nid]
                if not checkpointable(node):
                    memo[nid] = resolve_local(node)
                    del pending[nid]
                    progressed = True
                    continue
                state = self.storage.step_state(step_id)
                if state == "SUCCESSFUL":
                    value = self.storage.load_step_result(step_id)
                    if isinstance(value, DAGNode):
                        # Stored continuation: drive/resume it, then apply
                        # catch wrapping to its *final* value (mirrors the
                        # fresh path below).
                        value = self._maybe_continue(step_id, value)
                        if _catches(node):
                            value = (value, None)
                    memo[nid] = value
                    del pending[nid]
                    progressed = True
                    continue
                # Submit: upstream values are plain objects in memo.
                ref = node._execute_impl(memo)
                self.storage.log_event("step_started", step=step_id)
                # Normalize num_returns variants: a list of refs (wait on
                # the first, get them all) or None for num_returns=0.
                refs = ref if isinstance(ref, list) else (
                    [] if ref is None else [ref])
                if not refs:
                    self.storage.save_step_result(step_id, None)
                    self.storage.log_event("step_finished", step=step_id)
                    memo[nid] = None
                else:
                    inflight[refs[0].object_id] = (node, ref, step_id)
                del pending[nid]
                progressed = True

            if inflight:
                first_refs = [
                    (r[1][0] if isinstance(r[1], list) else r[1])
                    for r in inflight.values()
                ]
                ready, _ = api.wait(first_refs, num_returns=1, timeout=1.0)
                for r in ready:
                    node, ref, step_id = inflight.pop(r.object_id)
                    catch = _catches(node)
                    try:
                        value = api.get(ref)
                    except Exception as e:  # step failed
                        if catch:
                            value = (None, e)
                            self.storage.save_step_result(step_id, value)
                            self.storage.log_event("step_finished",
                                                   step=step_id, caught=True)
                        else:
                            self.storage.save_step_result(
                                step_id, e, is_exception=True)
                            self.storage.log_event("step_failed", step=step_id,
                                                   error=repr(e))
                            raise
                    else:
                        if isinstance(value, DAGNode):
                            # Continuation: checkpoint the step as SUCCESSFUL
                            # with the DAG node as its value BEFORE driving
                            # the sub-DAG — a crash mid-continuation must not
                            # re-run this step's body (side effects!). Resume
                            # then re-enters the continuation via
                            # _maybe_continue on the stored DAGNode value.
                            # catch_exceptions wraps the continuation's FINAL
                            # value, not the intermediate node.
                            self.storage.save_step_result(step_id, value)
                            value = self._maybe_continue(step_id, value)
                            if catch:
                                value = (value, None)
                        else:
                            if catch:
                                value = (value, None)
                            self.storage.save_step_result(step_id, value)
                        self.storage.log_event("step_finished", step=step_id)
                    memo[id(node)] = value
                progressed = True
            elif not progressed and pending:
                raise RuntimeError(
                    f"workflow deadlock: unsatisfiable deps for "
                    f"{[ids[i] for i in pending]}")
        return memo[id(output)]

    def _maybe_continue(self, step_id: str, value: Any):
        """Execute (or resume) a dynamic continuation of a finished step.

        The continuation DAG *is* the step's checkpointed value; its own
        steps checkpoint under ``steps/<id>.sub/``, so resume re-enters
        here (via the loaded value) and skips completed sub-steps.
        """
        if not isinstance(value, DAGNode):
            return value
        sub = WorkflowExecutor(self.storage.sub_storage(step_id),
                               self.cancel_event)
        return sub.run(value)
