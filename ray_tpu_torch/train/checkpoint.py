"""Directory-based checkpoints.

The port's copy of the JAX package's ``train/checkpoint.py``: ``Checkpoint``
is a handle to a directory (``from_directory``/``to_directory``/
``as_directory``, metadata), with the dict convenience of the reference's
legacy API (``from_dict``/``to_dict``, pickled, as the JAX package does).
``save_sharded``/``load_sharded`` go there through orbax and here through
``torch.distributed.checkpoint``: every rank writes only the shards it
owns; a restore into a target with other placements reshards, as orbax
does with a sharded target, and a restore with no target gives the whole
tree on the caller's process, with no process group.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

import torch.distributed as dist

_DICT_FILE = "_dict_checkpoint.pkl"
_METADATA_FILE = ".metadata.json"


class Checkpoint:
    """A checkpoint is a directory; this is a handle to it."""

    def __init__(self, path: str):
        self.path = os.path.abspath(os.fspath(path))

    # ------------------------------------------------------------ construction

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rtpu_ckpt_")
        with open(os.path.join(d, _DICT_FILE), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    # ------------------------------------------------------------------ access

    def to_dict(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _DICT_FILE)
        if not os.path.exists(p):
            raise ValueError(f"checkpoint at {self.path} is not a dict checkpoint")
        with open(p, "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: Optional[str] = None) -> str:
        dest = path or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

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
        # Imported here, not with the module: it pulls in DTensor, which a
        # worker running a numpy loop never needs.
        import torch.distributed.checkpoint as dcp

        dcp.save(tree, checkpoint_id=os.path.join(dest, "state"))
        return cls(dest)

    def load_sharded(self, target: Any = None) -> Any:
        """Restore the tree. With ``target``, a tree of live tensors and
        DTensors with the saved names, in place (each DTensor receives the
        shards its placements give this rank, whatever the placements at
        save time) and return it. Without, return the whole tree as plain
        CPU tensors on this process alone, with no process group: what the
        trainer process of a run reads."""
        import torch.distributed.checkpoint as dcp

        state = os.path.join(self.path, "state")
        if target is not None:
            dcp.load(target, checkpoint_id=state)
            return target
        # As format_utils.dcp_to_torch_save reads a checkpoint whole
        # (dcp.load itself fills only the keys its target already has).
        from torch.distributed.checkpoint.default_planner import (
            _EmptyStateDictLoadPlanner)
        from torch.distributed.checkpoint.state_dict_loader import (
            _load_state_dict)

        tree: Dict[str, Any] = {}
        _load_state_dict(tree, storage_reader=dcp.FileSystemReader(state),
                         planner=_EmptyStateDictLoadPlanner(), no_dist=True)
        return tree

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path!r})"
