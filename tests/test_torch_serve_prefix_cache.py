"""The port's KV prefix cache (``ray_tpu_torch/serve/prefix_cache.py``),
the mirror of tests/test_prefix_cache.py's seven cases: the replica-local
LRU keyed on the token-prefix hash, and the cluster index of holders.
The keys are the JAX package's byte for byte; the entries are CPU
tensors (numpy has no bfloat16), read back here through numpy."""
import numpy as np

from ray_tpu_torch.serve.prefix_cache import (PrefixCache, PrefixIndex,
                                              prefix_key)


def _blob(nbytes=1024, length=4):
    # k/v shaped like a single-slot KV slice [L, S, KVH, hd]; size chosen
    # so k+v together dominate the entry's byte accounting.
    half = max(1, nbytes // 8)  # float32 elements per tensor
    k = np.zeros(half, np.float32).reshape(1, -1, 1, 1)
    v = np.ones_like(k)
    logits = np.zeros(8, np.float32)
    return k, v, length, logits


def test_prefix_key_stable_and_exact():
    """Same tokens -> same hash regardless of container type, and the JAX
    package's hash; any change to the prefix changes the key."""
    from ray_tpu.serve.prefix_cache import prefix_key as jax_prefix_key

    a = prefix_key([1, 2, 3, 4])
    assert a == prefix_key((1, 2, 3, 4))
    assert a == prefix_key(np.asarray([1, 2, 3, 4], np.int64))
    assert a != prefix_key([1, 2, 3])
    assert a != prefix_key([1, 2, 3, 5])
    assert a != prefix_key([4, 3, 2, 1])
    assert len(a) == 32  # blake2b digest_size=16 hexdigest
    for toks in ([1, 2, 3, 4], [7], list(range(300))):
        assert prefix_key(toks) == jax_prefix_key(toks)


def test_lru_eviction_by_bytes():
    """Eviction is by KV bytes, least-recently-used first; a get() is a
    touch that protects the entry from the next eviction."""
    k, v, ln, lg = _blob()
    per_entry = k.nbytes + v.nbytes + lg.nbytes
    cache = PrefixCache(max_bytes=3 * per_entry, model="t")
    hs = [prefix_key([i]) for i in range(4)]
    for h in hs[:3]:
        cache.put(h, k, v, ln, lg)
    assert len(cache) == 3
    cache.get(hs[0])  # touch: h0 becomes most-recent
    cache.put(hs[3], k, v, ln, lg)  # evicts h1 (LRU), not h0
    assert hs[0] in cache and hs[3] in cache
    assert hs[1] not in cache
    st = cache.stats()
    assert st["entries"] == 3
    assert st["bytes"] <= 3 * per_entry


def test_oversized_entry_refused():
    k, v, ln, lg = _blob()
    cache = PrefixCache(max_bytes=k.nbytes // 2, model="t")
    cache.put(prefix_key([1]), k, v, ln, lg)
    assert len(cache) == 0


def test_disabled_flag_is_noop(monkeypatch):
    """RTPU_PREFIX_CACHE=0: get/put are no-ops."""
    monkeypatch.setenv("RTPU_PREFIX_CACHE", "0")
    k, v, ln, lg = _blob()
    cache = PrefixCache(max_bytes=10 * k.nbytes, model="t")
    h = prefix_key([1, 2])
    cache.put(h, k, v, ln, lg)
    assert cache.get(h) is None
    assert len(cache) == 0
    st = cache.stats()
    assert st["hits"] == 0 and st["misses"] == 0


def test_hit_miss_accounting_and_export_roundtrip():
    k, v, ln, lg = _blob()
    cache = PrefixCache(max_bytes=10 * (k.nbytes + v.nbytes), model="t")
    h = prefix_key([7, 8, 9])
    assert cache.get(h) is None  # miss
    cache.put(h, k, v, ln, lg)
    e = cache.get(h)  # hit
    assert e is not None and e.length == ln
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1
    # export/insert_blob is the promotion wire format: a second cache
    # seeded from the blob serves the same entry.
    blob = cache.export(h)
    other = PrefixCache(max_bytes=10 * (k.nbytes + v.nbytes), model="t")
    other.insert_blob(h, blob)
    e2 = other.get(h)
    assert e2 is not None and e2.length == ln
    np.testing.assert_array_equal(np.asarray(e2.k), np.asarray(e.k))
    np.testing.assert_array_equal(np.asarray(e.v), v)


def test_index_routes_hottest_first_and_drop():
    """The index maps prefix -> holder replicas for router steering; dead
    replicas drop out."""
    idx = PrefixIndex()
    idx.update_replica("r1", ["h_a", "h_b"], {"h_a": 5, "h_b": 1})
    idx.update_replica("r2", ["h_a"], {"h_a": 2})
    assert sorted(idx.holders("h_a")) == ["r1", "r2"]
    assert idx.holders("h_b") == {"r1"}
    assert idx.holders("h_zzz") == set()
    assert idx.cluster_hits("h_a") == 7
    routes = idx.routes()
    assert list(routes)[0] == "h_a"  # hottest prefix first
    assert set(routes["h_a"]) == {"r1", "r2"}
    idx.drop_replica("r1")
    assert idx.holders("h_b") == set()
    assert idx.holders("h_a") == {"r2"}


def test_index_promotions_only_cluster_hot_and_once():
    """Promotion targets: prefixes whose cluster-wide hit count crossed
    the threshold go to replicas that lack them, each pair at most
    once."""
    idx = PrefixIndex()
    idx.update_replica("r1", ["hot", "cold"], {"hot": 10, "cold": 1})
    idx.update_replica("r2", [], {})
    promos = idx.promotions(["r1", "r2"], threshold=3)
    assert ("hot", "r1", "r2") in promos
    assert all(p[0] != "cold" for p in promos)
    assert idx.promotions(["r1", "r2"], threshold=3) == []
    idx.update_replica("r3", [], {})
    promos3 = idx.promotions(["r1", "r2", "r3"], threshold=3)
    assert ("hot", "r1", "r3") in promos3
