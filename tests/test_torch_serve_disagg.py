"""The disaggregated serving plane on the port's replica processes, the
mirror of tests/test_serve_disagg.py's first three cases: the prefill
pool -> K/V handoff -> decode splice against the JAX package's greedy
generation, the decode replica's prefix cache, the ``RTPU_SERVE_DISAGG=0``
collapse, and the ingress's replay across a decode replica's SIGKILL
(every token exactly once).

Deployments and params come from test_torch_serve.py (a replica imports
these modules again, so neither imports jax at the top).
"""
import os
import signal
import time

import pytest

import test_torch_serve as base
from ray_tpu_torch import serve
from ray_tpu_torch.serve import controller
from ray_tpu_torch.serve.prefix_cache import prefix_key


@pytest.fixture(scope="module")
def serve_instance():
    yield
    serve.shutdown()
    assert base.no_children_left()


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return base.JaxReference(tmp_path_factory.mktemp("serve_params"))


def _disagg(jref, **kw):
    from ray_tpu_torch.serve.disagg import build_disagg_llm_deployment

    return build_disagg_llm_deployment(base.port_cfg(), jref.factory,
                                       num_gpus=0, **kw)


def _decode_reps(name):
    return controller._local.get_replicas(f"{name}-decode")[1]


def _call(rep, method, *args):
    return rep.handle_request(method, args, timeout=30)


def _tokens(handle, prompt):
    return [c["token"] for c in
            handle.options(stream=True).remote({"tokens": prompt})]


def _delete(name):
    for n in (name, f"{name}-decode", f"{name}-prefill"):
        serve.delete(n)


def test_disagg_matches_unified_and_caches_prefix(serve_instance, jref):
    """Tokens through the disaggregated plane (prefill pool -> K/V handoff
    -> decode splice) are exactly the JAX package's greedy generation; a
    repeat of the same prompt is a prefix-cache hit that skips prefill.
    The ingress runs on the CPU without starting CUDA."""
    handle = serve.run(_disagg(jref, name="dsg", num_prefill_replicas=1,
                               num_decode_replicas=1, num_slots=2,
                               max_prompt_len=16, max_new_tokens=4))
    try:
        for prompt in ([3, 1, 4, 1], [5, 9], [2, 6, 5, 3, 5, 8, 9]):
            assert _tokens(handle, prompt) == jref.tokens(prompt, 4), prompt
        rep = _decode_reps("dsg")[0]
        st0 = _call(rep, "cache_stats")
        assert st0["entries"] == 3 and st0["misses"] == 3
        handoff = rep.call("stats")["serve"]["handoff"]
        assert handoff["n"] == 3
        # Served from the resident K/V, no new prefill.
        prompt = [3, 1, 4, 1]
        assert _tokens(handle, prompt) == jref.tokens(prompt, 4)
        st1 = _call(rep, "cache_stats")
        assert st1["hits"] == st0["hits"] + 1
        assert st1["misses"] == st0["misses"]
        assert _call(rep, "has_prefix", prefix_key(prompt))
        assert rep.call("stats")["serve"]["handoff"]["n"] == 3
        ingress = controller._local.get_replicas("dsg")[1][0]
        info = ingress.call("stats")["process"]
        assert info["cuda_initialized"] is False
    finally:
        _delete("dsg")


def test_disagg_disabled_collapses_to_unified(serve_instance, jref,
                                              monkeypatch):
    """RTPU_SERVE_DISAGG=0: the builder returns the single-pool streaming
    deployment under the same name and request contract."""
    monkeypatch.setenv("RTPU_SERVE_DISAGG", "0")
    handle = serve.run(_disagg(jref, name="uni", num_decode_replicas=1,
                               num_slots=2, max_prompt_len=16,
                               max_new_tokens=4))
    try:
        prompt = [3, 1, 4, 1]
        assert _tokens(handle, prompt) == jref.tokens(prompt, 4)
        st = serve.status()
        assert "uni" in st and "uni-decode" not in st \
            and "uni-prefill" not in st
    finally:
        serve.delete("uni")


N_CHAOS = 96  # long enough that the kill lands mid-stream


def test_decode_replica_sigkill_mid_stream(serve_instance, jref):
    """SIGKILL the decode replica serving a stream. The ingress re-routes
    to the surviving replica, reusing its cached prefix K/V when present
    and re-prefilling through the pool otherwise, and the client sees
    every token exactly once (no duplicate, no loss)."""
    handle = serve.run(_disagg(jref, name="chs", num_prefill_replicas=1,
                               num_decode_replicas=2, num_slots=2,
                               max_prompt_len=16, max_new_tokens=N_CHAOS))
    try:
        # ---- variant A: the survivor already holds the prefix
        prompt = [3, 1, 4, 1, 5]
        exp = jref.tokens(prompt, N_CHAOS)
        assert _tokens(handle, prompt) == exp
        h = prefix_key(prompt)
        reps = _decode_reps("chs")
        held = [_call(r, "has_prefix", h) for r in reps]
        assert held.count(True) == 1
        victim = reps[held.index(True)]
        survivor = reps[held.index(False)]
        # Pre-position the blob on the survivor (the promotion pull path).
        assert _call(survivor, "pull_prefix", h, victim)
        sv0 = _call(survivor, "cache_stats")
        victim_pid = _call(victim, "pid")

        it = iter(handle.options(stream=True).remote({"tokens": prompt}))
        got = [next(it)["token"] for _ in range(2)]
        os.kill(victim_pid, signal.SIGKILL)
        got += [c["token"] for c in it]
        assert got == exp, ("tokens duplicated or lost across re-route",
                            got, exp)
        sv1 = _call(survivor, "cache_stats")
        assert sv1["hits"] > sv0["hits"], \
            "survivor should have served the replay from its prefix cache"

        # ---- variant B: the survivor does NOT hold the prefix
        # (re-prefill). Wait for the controller to restore the replica.
        deadline = time.time() + 60
        while time.time() < deadline:
            reps = _decode_reps("chs")
            if len(reps) == 2 and victim_pid not in [r.pid for r in reps]:
                break
            time.sleep(0.2)
        reps = _decode_reps("chs")
        assert len(reps) == 2
        prompt2 = [7, 1, 3, 3, 8]
        exp2 = jref.tokens(prompt2, N_CHAOS)
        assert _tokens(handle, prompt2) == exp2
        h2 = prefix_key(prompt2)
        held = [_call(r, "has_prefix", h2) for r in reps]
        assert held.count(True) == 1
        victim = reps[held.index(True)]
        survivor = reps[held.index(False)]
        sv0 = _call(survivor, "cache_stats")
        victim_pid = _call(victim, "pid")

        it = iter(handle.options(stream=True).remote({"tokens": prompt2}))
        got = [next(it)["token"] for _ in range(2)]
        os.kill(victim_pid, signal.SIGKILL)
        got += [c["token"] for c in it]
        assert got == exp2, ("tokens duplicated or lost across re-route",
                             got, exp2)
        # The replay re-prefilled h2 on a live replica: the survivor, or
        # the restored one where the controller was that quick.
        holders = [r for r in _decode_reps("chs")
                   if _call(r, "has_prefix", h2)]
        assert holders, "replay should have left h2 resident on a replica"
        if any(r.replica_id == survivor.replica_id for r in holders):
            assert _call(survivor, "cache_stats")["misses"] > sv0["misses"]
        else:
            assert _call(holders[0], "cache_stats")["misses"] >= 1
        assert controller._local.get_replicas("chs")[1][0].call(
            "stats")["serve"]["reroutes"] == 2
    finally:
        _delete("chs")
