"""Durable workflows on the port's DAG layer (counterpart of the JAX
package's ``workflow/``): ``storage.py`` (the on-disk layout, atomic
writes, the owner's heartbeat), ``executor.py`` (the wave executor with
a checkpoint a step, continuations and ``catch_exceptions``) and
``api.py`` (run, resume, status, output, list, cancel, delete). Stored
DAGs go by reference and under the port's own root (``storage.py``).
"""
from .api import (
    cancel,
    delete,
    get_output,
    get_status,
    list_all,
    resume,
    resume_async,
    run,
    run_async,
)
from .storage import WorkflowStorage

__all__ = [
    "run",
    "run_async",
    "resume",
    "resume_async",
    "get_status",
    "get_output",
    "list_all",
    "cancel",
    "delete",
    "WorkflowStorage",
]
