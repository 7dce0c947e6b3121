"""Offline experience IO: write sampled fragments, read them for training
(counterpart of the JAX package's ``rllib/offline/io.py``, numpy only).

Parity: reference rllib/offline/ (json_writer.py / json_reader.py and the
OfflineData datasets path): env runners write experiences to files; offline
algorithms train from those files without touching an environment.
Transitions are columnar .npz shards with a manifest.jsonl beside them, the
JAX package's format: either package reads what the other wrote.
``read_experiences`` gives the shards as the port's data Dataset (one block
a shard, in the order of their sorted names), and ``load_columns`` reads
through it, as the reference's.
"""
from __future__ import annotations

import glob as globlib
import json
import os
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


class JsonWriter:
    """Append transition columns of sampled fragments to .npz shards
    (name kept for reference-API familiarity; payload is npz, with a
    sidecar manifest.jsonl describing the shards, one JSON line each)."""

    def __init__(self, path: str, *, max_rows_per_shard: int = 100_000):
        self.path = path
        self.max_rows = max_rows_per_shard
        os.makedirs(path, exist_ok=True)
        self._shard = 0

    def write(self, columns: Dict[str, np.ndarray]) -> str:
        n = len(next(iter(columns.values())))
        # uuid suffix: two writers (or two write calls in one second) must
        # never collide on a shard name — an overwrite is silent data loss.
        fname = os.path.join(
            self.path,
            f"experiences-{int(time.time())}-{self._shard:05d}-"
            f"{uuid.uuid4().hex[:8]}.npz")
        self._shard += 1
        np.savez_compressed(fname, **columns)
        # Append-only JSONL manifest: O_APPEND single-line writes survive
        # concurrent writers (a read-modify-write JSON doc loses entries
        # when two env runners race) and a truncated tail line from a crash
        # corrupts only itself, not the whole manifest.
        entry = {"file": os.path.basename(fname), "rows": int(n),
                 "columns": sorted(columns)}
        with open(os.path.join(self.path, "manifest.jsonl"), "a") as f:
            f.write(json.dumps(entry) + "\n")
        return fname


def write_fragments(frags: Sequence[Dict[str, Any]], path: str) -> str:
    """Flatten [T,N] rollout fragments (utils/rollout.py layout) into
    transition columns and append them as one shard. Invalid (autoreset)
    rows are dropped at write time so readers see only real transitions."""
    cols: Dict[str, List[np.ndarray]] = {
        "obs": [], "actions": [], "rewards": [], "dones": [], "logp": []}
    for f in frags:
        T, N = f["actions"].shape
        valid = f["valid"].reshape(T * N) > 0

        def flat(x):
            return x.reshape(T * N, *x.shape[2:])[valid]

        cols["obs"].append(flat(f["obs"]))
        cols["actions"].append(flat(f["actions"]))
        cols["rewards"].append(flat(f["rewards"]))
        cols["dones"].append(flat(f["dones"]))
        cols["logp"].append(flat(f["logp"]))
    merged = {k: np.concatenate(v) for k, v in cols.items()}
    return JsonWriter(path).write(merged)


def write_transitions(columns: Dict[str, np.ndarray], path: str) -> str:
    """Append one shard of FLAT transition columns (offline continuous-RL
    data: obs/actions/rewards/next_obs/dones — the (s, a, r, s', d) tuples
    CQL/SAC-style learners consume, vs write_fragments' [T,N] on-policy
    rollout layout). All columns must share the leading length."""
    n = {k: len(v) for k, v in columns.items()}
    if len(set(n.values())) != 1:
        raise ValueError(f"ragged transition columns: {n}")
    return JsonWriter(path).write(dict(columns))


def read_experiences(path: str):
    """Offline dataset of transitions as a ``ray_tpu_torch.data`` Dataset,
    one block a shard (the reference's OfflineData-on-ray.data design,
    rllib/offline/offline_data.py)."""
    from ...data import from_blocks

    files = sorted(globlib.glob(os.path.join(path, "experiences-*.npz")))
    if not files:
        raise FileNotFoundError(f"no experience shards under {path!r}")
    blocks = []
    for fn in files:
        with np.load(fn) as z:
            blocks.append({k: z[k] for k in z.files})
    return from_blocks(blocks)


def load_columns(path: str) -> Dict[str, np.ndarray]:
    """All shards concatenated into one columnar dict (cacheable), in the
    order of their sorted file names."""
    ds = read_experiences(path)
    cols: Dict[str, List[np.ndarray]] = {}
    for batch in ds.iter_batches(batch_format="numpy"):
        for k, v in batch.items():
            cols.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in cols.items()}


def iter_offline_batches(path_or_columns, batch_size: int, *,
                         epochs: int = 1, seed: int = 0
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled minibatches over all shards. Accepts a path (loads every
    call) or a pre-loaded load_columns() dict (the cached fast path).
    A dataset smaller than batch_size yields ONE undersized batch rather
    than silently yielding nothing."""
    full = (path_or_columns if isinstance(path_or_columns, dict)
            else load_columns(path_or_columns))
    n = len(full["actions"])
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        starts = list(range(0, max(n - batch_size + 1, 1), batch_size))
        for s in starts:
            idx = order[s:s + batch_size]
            yield {k: v[idx] for k, v in full.items()}
