"""``@serve.multiplexed`` and affinity routing on the port's replica
processes: the mirror of tests/test_serve.py::test_model_multiplexing; a
multiplexed LLM (``llama_tiny`` in f32) whose loader keeps two models a
replica, token-exact against the JAX package's ``generate`` and the
port's in-process one; and the controller's prefix promotion end to end
on a disaggregated deployment with two decode replicas, held to the JAX
package's on the same scenario (run meanwhile in a process of its own),
with the router's ``prefix_routes`` steering a request to the replica
that holds its prefix.

Deployments are module-level (a replica imports this module again to
find them), so the module imports neither jax nor the JAX package at the
top.
"""
import gc
import hashlib
import json
import pathlib
import subprocess
import sys
import time
import weakref

import pytest

import test_torch_serve as base
from ray_tpu_torch import serve
from ray_tpu_torch.serve import controller
from ray_tpu_torch.serve.prefix_cache import prefix_key

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def serve_instance():
    yield
    serve.shutdown()
    assert base.no_children_left()


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return base.JaxReference(tmp_path_factory.mktemp("serve_params"))


@serve.deployment(num_replicas=2)
class MultiModel:
    def __init__(self):
        self.loads = []

    @serve.multiplexed(max_num_models_per_replica=2)
    def get_model(self, model_id: str):
        self.loads.append(model_id)
        return {"id": model_id, "scale": int(model_id.split("-")[1])}

    def __call__(self, x):
        mid = serve.get_multiplexed_model_id()
        model = self.get_model(mid)
        return {"model": model["id"], "y": x * model["scale"],
                "loads": len(self.loads)}


def test_model_multiplexing(serve_instance):
    """@serve.multiplexed LRU-caches models per replica; requests carry
    the model id and route with per-model affinity."""
    handle = serve.run(MultiModel.bind(), route_prefix="/multi")
    try:
        r1 = handle.options(multiplexed_model_id="m-3").remote(10).result(
            timeout=30)
        assert r1 == {"model": "m-3", "y": 30, "loads": 1}
        # The same model again: a cache hit on the SAME replica.
        r2 = handle.options(multiplexed_model_id="m-3").remote(7).result(
            timeout=30)
        assert r2["model"] == "m-3" and r2["y"] == 21
        assert r2["loads"] == 1, "model reloaded despite LRU + affinity"
        r3 = handle.options(multiplexed_model_id="m-5").remote(2).result(
            timeout=30)
        assert r3["model"] == "m-5" and r3["y"] == 10
        # No model id: the loader refuses, naming the option.
        with pytest.raises(Exception, match="multiplexed_model_id"):
            handle.remote(1).result(timeout=30)
    finally:
        serve.delete("MultiModel")


def greedy(params, prompt, n):
    """The multiplexed LLM's generation: the port's greedy ``generate``."""
    import torch

    from ray_tpu_torch.models.generate import generate

    out = generate(params, torch.tensor([prompt]), base.port_cfg(), n)
    return out[0, len(prompt):].tolist()


def seeded_params(seed):
    import torch

    from ray_tpu_torch.models.transformer import init_params

    return init_params(base.port_cfg(), torch.Generator().manual_seed(seed),
                       "cpu")


@serve.deployment(name="mux-llm")
class MuxLLM:
    """Model "jax" is the JAX package's llama_tiny (its .npz), "seed-N"
    the port's init from seed N; two stay loaded."""

    def __init__(self, npz_path, n):
        self.npz_path = npz_path
        self.n = n
        self.loads = []
        self.refs = {}

    @serve.multiplexed(max_num_models_per_replica=2)
    def get_model(self, model_id: str):
        if model_id == "jax":
            params = base.NpzParams(self.npz_path)()
        else:
            params = seeded_params(int(model_id.split("-")[1]))
        self.loads.append(model_id)
        self.refs[model_id] = weakref.ref(params["embed"])
        return params

    def __call__(self, prompt):
        params = self.get_model(serve.get_multiplexed_model_id())
        return {"tokens": greedy(params, prompt, self.n),
                "loads": list(self.loads)}

    def resident(self):
        """Which loaded models' weights are still alive."""
        gc.collect()
        return {m: r() is not None for m, r in self.refs.items()}


def test_multiplexed_llm_loads_and_evicts(serve_instance, jref):
    """Ids A (the JAX params), B, A, C with two models a replica: A's
    tokens are the JAX package's greedy generation, C's the port's
    in-process run from the same seed; four calls make three loads (the
    second A is not reloaded), and C's load evicts B, whose weights are
    then freed."""
    n, prompt = 6, [3, 1, 4, 1, 5]
    handle = serve.run(MuxLLM.bind(jref.path, n))
    try:
        outs = [handle.options(multiplexed_model_id=m).remote(prompt)
                .result(timeout=120)
                for m in ("jax", "seed-1", "jax", "seed-2")]
        assert outs[0]["tokens"] == jref.tokens(prompt, n)
        assert outs[2]["tokens"] == outs[0]["tokens"]
        assert outs[1]["tokens"] == greedy(seeded_params(1), prompt, n)
        assert outs[3]["tokens"] == greedy(seeded_params(2), prompt, n)
        assert outs[-1]["loads"] == ["jax", "seed-1", "seed-2"]
        assert handle.resident.remote().result(timeout=30) == {
            "jax": True, "seed-1": False, "seed-2": True}
    finally:
        serve.delete("mux-llm")


def test_router_prefers_prefix_holders():
    """With a prefix-routes entry the affine pick runs over the holders
    alone (where one is live), else over every replica."""
    from ray_tpu_torch.serve.handle import Router
    from ray_tpu_torch.serve.replica import ReplicaClient

    router = Router("r")
    router._replicas = [ReplicaClient(f"r#{i}", "", "r") for i in range(3)]
    key = "some-prefix"
    free = router._pick_affine(key).replica_id
    other = next(r.replica_id for r in router._replicas
                 if r.replica_id != free)
    router._prefix_routes = {key: [other]}
    assert router._pick_affine(key).replica_id == other
    router._prefix_routes = {key: ["gone#9"]}
    assert router._pick_affine(key).replica_id == free


# ----------------------------------------------------- prefix promotion

PROMPT = [3, 1, 4, 1]
REPEATS = 4  # one miss, then RTPU_PREFIX_CACHE_PROMOTE_HITS (3) hits

# The JAX package's side of the scenario, run as a script of its own
# (its cluster, its replicas) while the port's runs here.
_JAX_SCENARIO = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
import jax
import ray_tpu
from ray_tpu import serve
from ray_tpu.models import transformer as tfm
from ray_tpu.models.configs import llama_tiny
from ray_tpu.serve.disagg import build_disagg_llm_deployment

CFG = llama_tiny(remat=False)


def factory():
    return tfm.init_params(jax.random.key(0), CFG)


if __name__ == "__main__":
    ray_tpu.init(num_cpus=4)
    try:
        app = build_disagg_llm_deployment(
            CFG, factory, name="pp", num_prefill_replicas=1,
            num_decode_replicas=2, num_slots=2, max_prompt_len=16,
            max_new_tokens=2)
        handle = serve.run(app, route_prefix="/pp")
        tokens = [[c["token"] for c in handle.options(stream=True).remote(
            {{"tokens": {prompt!r}}})] for _ in range({repeats})]
        ctrl = ray_tpu.get_actor("SERVE_CONTROLLER")
        _, reps = ray_tpu.get(ctrl.get_replicas.remote("pp-decode"))

        def stats():
            return [ray_tpu.get(r.handle_request.remote(
                "cache_stats", (), {{}}), timeout=30) for r in reps]

        deadline = time.time() + 60
        while time.time() < deadline and not all(
                s["entries"] for s in stats()):
            time.sleep(0.5)
        time.sleep(2.5)  # a poll or two more: no second promotion
        routes = ray_tpu.get(ctrl.get_routing_config.remote(
            "pp-decode"))["prefix_routes"]
        print("JAX", json.dumps({{
            "tokens": tokens,
            "stats": sorted([s["hits"], s["misses"], s["entries"]]
                            for s in stats()),
            "routes": {{h: len(v) for h, v in routes.items()}}}}))
    finally:
        serve.shutdown()
        ray_tpu.shutdown()
"""


def _cache_stats(reps):
    return [r.handle_request("cache_stats", timeout=30) for r in reps]


def _affine(replica_ids, key):
    return max(replica_ids, key=lambda rid: hashlib.md5(
        f"{key}|{rid}".encode()).digest())


def test_prefix_promotion_and_routing(serve_instance, jref, tmp_path):
    """Two decode replicas: a prefix hit RTPU_PREFIX_CACHE_PROMOTE_HITS
    times on one is pulled by the other (once), with the hits, misses,
    entries and routes of the JAX package's run of the same scenario;
    then a prefix held by one replica only is routed there by the
    ingress's router although the plain affinity hash picks the other."""
    script = tmp_path / "jax_prefix_scenario.py"
    script.write_text(_JAX_SCENARIO.format(repo=str(REPO), prompt=PROMPT,
                                           repeats=REPEATS))
    jax_side = subprocess.Popen([sys.executable, str(script)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                cwd=str(tmp_path))
    try:
        tokens, stats = _port_scenario(jref)
    except BaseException:
        jax_side.kill()
        jax_side.communicate()
        raise
    out, err = jax_side.communicate(timeout=240)
    assert jax_side.returncode == 0, err[-3000:]
    (line,) = [ln for ln in out.splitlines() if ln.startswith("JAX ")]
    ref = json.loads(line[4:])
    assert ref["tokens"] == tokens
    assert ref["stats"] == stats
    assert ref["routes"] == {prefix_key(PROMPT): 2}


def _port_scenario(jref):
    from ray_tpu_torch.serve.disagg import build_disagg_llm_deployment

    try:
        handle = serve.run(build_disagg_llm_deployment(
            base.port_cfg(), jref.factory, name="pp", num_prefill_replicas=1,
            num_decode_replicas=2, num_slots=2, max_prompt_len=16,
            max_new_tokens=2, num_gpus=0), route_prefix="/pp")
        ctrl = controller._local

        def stream(h, prompt, model_id=None):
            if model_id is not None:
                h = h.options(multiplexed_model_id=model_id)
            return [c["token"] for c in
                    h.options(stream=True).remote({"tokens": prompt})]

        tokens = [stream(handle, PROMPT) for _ in range(REPEATS)]
        assert tokens == [jref.tokens(PROMPT, 2)] * REPEATS
        reps = ctrl.get_replicas("pp-decode")[1]
        deadline = time.time() + 30
        while time.time() < deadline and not all(
                s["entries"] for s in _cache_stats(reps)):
            time.sleep(0.2)
        time.sleep(2.5)  # a poll or two more: no second promotion
        stats = sorted([s["hits"], s["misses"], s["entries"]]
                       for s in _cache_stats(reps))
        routes = ctrl.get_routing_config("pp-decode")["prefix_routes"]
        assert stats == [[0, 0, 1], [3, 1, 1]], stats
        assert routes == {prefix_key(PROMPT): sorted(
            r.replica_id for r in reps)}
        assert ctrl.get_serve_stats()["pp-decode"]["promotions"] == 1

        # Steering: a prompt whose plain hash picks one replica, held by
        # the other alone (sent there through the decode deployment's own
        # handle, under a routing key that hashes to it).
        ids = [r.replica_id for r in reps]
        q = next([7, k, 2] for k in range(100)
                 if _affine(ids, prefix_key([7, k, 2])) == ids[1])
        key = next(f"k{i}" for i in range(100)
                   if _affine(ids, f"k{i}") == ids[0])
        decode = serve.get_deployment_handle("pp-decode")
        assert stream(decode, q, key) == jref.tokens(q, 2)
        before = {r.replica_id: s for r, s in zip(reps, _cache_stats(reps))}
        hq = prefix_key(q)
        deadline = time.time() + 30
        while (ctrl.get_routing_config("pp-decode")["prefix_routes"]
               .get(hq) != [ids[0]]) and time.time() < deadline:
            time.sleep(0.2)
        time.sleep(3.5)  # the ingress's router refreshes its routes
        assert stream(handle, q) == jref.tokens(q, 2)
        after = {r.replica_id: s for r, s in zip(reps, _cache_stats(reps))}
        assert after[ids[0]]["hits"] == before[ids[0]]["hits"] + 1
        assert after[ids[1]]["misses"] == before[ids[1]]["misses"]
    finally:
        for n in ("pp", "pp-decode", "pp-prefill"):
            serve.delete(n)
    return tokens, stats
