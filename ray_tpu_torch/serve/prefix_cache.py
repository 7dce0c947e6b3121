"""KV prefix cache: hot prompts keep their prefilled K/V resident
(counterpart of the JAX package's ``serve/prefix_cache.py``).

Decode replicas of the disaggregated plane (``disagg.py``) cache the
handoff blob, ``(k, v, length, logits)`` exactly as
``ContinuousBatchingEngine.attach_prefilled`` accepts it, keyed by a hash
of the prompt tokens and evicted least-recently-used by bytes, so a
repeated prompt never pays prefill again.

Two layers:
- ``PrefixCache``: the per-replica store, gated by RTPU_PREFIX_CACHE so
  the disabled path is a no-op at every call site. Its entries are CPU
  tensors where the JAX package keeps numpy arrays: numpy has no
  bfloat16 (a divergence recorded with the handoff blob's);
- ``PrefixIndex``: the cluster view of which replicas hold which
  prefixes. The controller feeds it from its replicas' stats, promotes
  hot prefixes to the replicas that lack them, and hands routers its
  ``routes()`` (``serve/controller.py``).

A cache counts its hits and misses and sets its resident bytes and
entries on the metrics plane (``util/metrics.py``), tagged by model.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import flags

_cache_metrics_cache = None


def _cache_metrics():
    """The prefix cache's instruments (one set a process, model tag)."""
    global _cache_metrics_cache
    if _cache_metrics_cache is None:
        from ..util.metrics import Counter, Gauge

        _cache_metrics_cache = {
            "hits": Counter(
                "rtpu_prefix_cache_hits_total",
                description="Prefix-cache hits: requests whose prefilled "
                            "K/V was already resident (prefill skipped)",
                tag_keys=("model",)),
            "misses": Counter(
                "rtpu_prefix_cache_misses_total",
                description="Prefix-cache misses: requests that had to "
                            "run (or wait for) a cold prefill",
                tag_keys=("model",)),
            "bytes": Gauge(
                "rtpu_prefix_cache_bytes",
                description="Resident prefix-cache K/V bytes on this "
                            "replica (LRU evicts past the budget)",
                tag_keys=("model",)),
            "entries": Gauge(
                "rtpu_prefix_cache_entries",
                description="Resident prefix-cache entries on this "
                            "replica",
                tag_keys=("model",)),
        }
    return _cache_metrics_cache

def prefix_key(tokens) -> str:
    """Stable hash of a token sequence: the cache/index/routing key (the
    JAX package's, byte for byte: int32 tokens, blake2b-128).

    Exact-prompt keying (not per-block): a hit means THE WHOLE prefill is
    skippable, which is the common win for repeated system prompts."""
    ids = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return hashlib.blake2b(ids.tobytes(), digest_size=16).hexdigest()


def _host(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (a tensor anywhere, or a numpy array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x, copy=True))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PrefixEntry:
    """One cached prefill handoff blob (CPU tensors, ready to splice)."""

    __slots__ = ("k", "v", "length", "logits", "nbytes", "hits")

    def __init__(self, k: torch.Tensor, v: torch.Tensor, length: int,
                 logits: torch.Tensor):
        self.k = k
        self.v = v
        self.length = int(length)
        self.logits = logits
        self.nbytes = _nbytes(k) + _nbytes(v) + _nbytes(logits)
        self.hits = 0


class PrefixCache:
    """Per-replica LRU-by-bytes store of prefilled K/V blobs."""

    def __init__(self, *, max_bytes: Optional[int] = None, model: str = ""):
        if max_bytes is None:
            max_bytes = int(flags.get("RTPU_PREFIX_CACHE_MAX_MB") * 2**20)
        self.max_bytes = max_bytes
        self.model = model or "default"
        self._mtags = {"model": self.model}
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        return bool(flags.get("RTPU_PREFIX_CACHE"))

    def get(self, h: str) -> Optional[PrefixEntry]:
        """Lookup + LRU touch; counts the hit or miss."""
        if not self.enabled:
            return None
        m = _cache_metrics()
        with self._lock:
            e = self._entries.get(h)
            if e is None:
                self.misses += 1
                m["misses"].inc(1.0, tags=self._mtags)
                return None
            self._entries.move_to_end(h)
            e.hits += 1
            self.hits += 1
        m["hits"].inc(1.0, tags=self._mtags)
        return e

    def put(self, h: str, k, v, length: int, logits) -> bool:
        """Insert a blob (host copies); evicts LRU entries past the byte
        budget. Oversized blobs (> budget) are refused rather than
        wiping the whole cache for one entry."""
        if not self.enabled:
            return False
        e = PrefixEntry(_host(k), _host(v), length, _host(logits))
        if e.nbytes > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(h, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[h] = e
            self._bytes += e.nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
            m = _cache_metrics()
            m["bytes"].set(float(self._bytes), tags=self._mtags)
            m["entries"].set(float(len(self._entries)), tags=self._mtags)
        return True

    def __contains__(self, h: str) -> bool:
        with self._lock:
            return h in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def export(self, h: str) -> Optional[Dict[str, Any]]:
        """One entry as a blob, for another replica to insert."""
        with self._lock:
            e = self._entries.get(h)
            if e is None:
                return None
            return {"k": e.k, "v": e.v, "length": e.length,
                    "logits": e.logits}

    def insert_blob(self, h: str, blob: Dict[str, Any]) -> bool:
        return self.put(h, blob["k"], blob["v"], blob["length"],
                        blob["logits"])

    def stats(self, *, top: int = 64) -> Dict[str, Any]:
        """Counters, residency, and the hottest resident hashes with
        per-entry hit counts."""
        with self._lock:
            hot = sorted(((h, e.hits) for h, e in self._entries.items()),
                         key=lambda kv: -kv[1])[:top]
            return {"hits": self.hits, "misses": self.misses,
                    "bytes": self._bytes, "entries": len(self._entries),
                    "holders": [h for h, _ in hot],
                    "hot": dict(hot)}


class PrefixIndex:
    """Cluster view: which replicas hold which prefixes, and how hot each
    prefix is cluster-wide. Every method snapshots or mutates under one
    lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_replica: Dict[str, Dict[str, int]] = {}  # rid -> {h: hits}
        self._holders: Dict[str, Set[str]] = {}           # h -> {rid}
        self._promoted: Set[Tuple[str, str]] = set()      # (h, target_rid)

    def update_replica(self, rid: str, holders: List[str],
                       hot: Dict[str, int]) -> None:
        """Fold one replica's report into the index. Reports are
        cumulative per replica; cluster hits = sum of latest reports."""
        with self._lock:
            self._by_replica[rid] = {h: int(hot.get(h, 0)) for h in holders}
            self._rebuild_locked()

    def drop_replica(self, rid: str) -> None:
        with self._lock:
            if self._by_replica.pop(rid, None) is not None:
                self._rebuild_locked()

    def _rebuild_locked(self) -> None:
        holders: Dict[str, Set[str]] = {}
        for rid, held in self._by_replica.items():
            for h in held:
                holders.setdefault(h, set()).add(rid)
        self._holders = holders

    def replica_ids(self) -> List[str]:
        with self._lock:
            return list(self._by_replica)

    def holders(self, h: str) -> Set[str]:
        with self._lock:
            return set(self._holders.get(h, ()))

    def _cluster_hits_locked(self, h: str) -> int:
        return sum(held.get(h, 0) for held in self._by_replica.values())

    def cluster_hits(self, h: str) -> int:
        with self._lock:
            return self._cluster_hits_locked(h)

    def routes(self, *, top: int = 128) -> Dict[str, List[str]]:
        """Hot-prefix routing table: hash -> sorted holder replica ids,
        hottest prefixes first."""
        with self._lock:
            scored = sorted(self._holders,
                            key=lambda h: -self._cluster_hits_locked(h))[:top]
            return {h: sorted(self._holders[h]) for h in scored}

    def promotions(self, all_replicas: List[str],
                   *, threshold: int) -> List[Tuple[str, str, str]]:
        """(prefix, holder_rid, target_rid) pulls to run: prefixes with
        at least ``threshold`` cluster-wide hits, for replicas that don't
        hold them yet, each (prefix, target) pair at most once per index
        lifetime. ``threshold <= 0`` disables promotion."""
        if threshold <= 0 or not flags.get("RTPU_PREFIX_CACHE"):
            return []
        out: List[Tuple[str, str, str]] = []
        with self._lock:
            for h, holders in self._holders.items():
                if not holders or self._cluster_hits_locked(h) < threshold:
                    continue
                holder = sorted(holders)[0]
                for t in all_replicas:
                    if t in holders or (h, t) in self._promoted:
                        continue
                    out.append((h, holder, t))
                    self._promoted.add((h, t))
        return out
