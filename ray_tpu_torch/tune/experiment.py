"""Trial state machine + experiment bookkeeping (the port's copy of the JAX
package's ``tune/experiment.py``: the same experiment-state JSON).

Parity: reference tune/experiment/trial.py (Trial status PENDING/RUNNING/
PAUSED/TERMINATED/ERROR, checkpoint tracking, result log) — trimmed to the
fields the controller and schedulers actually consume.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    last_result: Dict[str, Any] = field(default_factory=dict)
    results: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint_path: Optional[str] = None
    error_msg: Optional[str] = None
    num_failures: int = 0
    resources: Dict[str, float] = field(default_factory=dict)
    local_dir: str = ""

    def metric_value(self, metric: str) -> Optional[float]:
        v = self.last_result.get(metric)
        return None if v is None else float(v)

    @property
    def iteration(self) -> int:
        return int(self.last_result.get("training_iteration", 0))

    def record_result(self, result: Dict[str, Any]) -> None:
        self.last_result = result
        self.results.append(result)

    # ------------------------------------------------------------ persistence

    def to_json(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "checkpoint_path": self.checkpoint_path,
            "error_msg": self.error_msg,
            "num_failures": self.num_failures,
            "local_dir": self.local_dir,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Trial":
        t = cls(config=d["config"], trial_id=d["trial_id"])
        t.status = d["status"]
        t.last_result = d.get("last_result", {})
        t.checkpoint_path = d.get("checkpoint_path")
        t.error_msg = d.get("error_msg")
        t.num_failures = d.get("num_failures", 0)
        t.local_dir = d.get("local_dir", "")
        return t


def save_experiment_state(
    path: str,
    trials: List[Trial],
    searcher_state: Dict,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, ".experiment_state.tmp")
    with open(tmp, "w") as f:
        json.dump(
            {
                "timestamp": time.time(),
                "trials": [t.to_json() for t in trials],
                "searcher": searcher_state,
                "meta": meta or {},
            },
            f,
            default=str,
        )
    os.replace(tmp, os.path.join(path, "experiment_state.json"))


def load_experiment_state(path: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(path, "experiment_state.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)
