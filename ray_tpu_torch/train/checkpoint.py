"""Directory-based checkpoints.

The port's copy of the parts of the JAX package's ``train/checkpoint.py``
that training needs: ``Checkpoint`` as a handle to a directory
(``from_directory``, ``path``, metadata), and ``save_sharded`` /
``load_sharded``, which there go through orbax and here through
``torch.distributed.checkpoint``: every rank writes only the shards it
owns, and a restore into a target with other placements reshards, as orbax
does with a sharded target.
"""
from __future__ import annotations

import json
import os
import tempfile
import uuid
from typing import Any, Dict, Optional

import torch.distributed as dist
import torch.distributed.checkpoint as dcp

_METADATA_FILE = ".metadata.json"


class Checkpoint:
    """A checkpoint is a directory; this is a handle to it."""

    def __init__(self, path: str):
        self.path = os.path.abspath(os.fspath(path))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    # --------------------------------------------------------------- metadata

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METADATA_FILE)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    # --------------------------------------------------- sharded checkpoints

    @classmethod
    def save_sharded(cls, tree: Any, path: Optional[str] = None
                     ) -> "Checkpoint":
        """Persist a tree (nested dicts) of tensors and DTensors; each rank
        writes only its own shards. Every rank of the process group calls
        it; without ``path`` rank 0 picks a new directory under the
        temporary directory and tells the others."""
        if path is None:
            name = [os.path.join(tempfile.gettempdir(),
                                 f"rtpu_sharded_{uuid.uuid4().hex[:12]}")]
            if dist.is_initialized():
                dist.broadcast_object_list(name, src=0)
            path = name[0]
        dest = os.path.abspath(path)
        dcp.save(tree, checkpoint_id=os.path.join(dest, "state"))
        return cls(dest)

    def load_sharded(self, target: Any) -> Any:
        """Restore into ``target``, a tree of live tensors and DTensors with
        the saved names, in place, and return it. Each DTensor receives the
        shards its placements give this rank, whatever the placements at
        save time."""
        dcp.load(target, checkpoint_id=os.path.join(self.path, "state"))
        return target

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path!r})"
