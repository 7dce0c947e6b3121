"""The port's Serve layer (``ray_tpu_torch.serve``) on spawned replica
processes, the mirror of tests/test_serve.py: deployments and handles,
replicas, composition, ``@serve.batch``, replica recovery, streaming, and
the LLM deployments token-exact against the JAX package (``llama_tiny``
in f32 on both sides, the JAX params carried across through numpy).

A replica process imports this module again to find its deployment, so
the module imports neither jax nor the JAX package at the top: the
reference side imports them inside its functions. Params reach replicas
as an ``.npz`` file that :class:`NpzParams` (module-level) loads. One
serve instance serves the module; each test deletes its deployments, and
the instance's shutdown must leave no child process. The other
``test_torch_serve_*.py`` modules share these helpers.
"""
import multiprocessing
import os
import time

import numpy as np
import pytest

from ray_tpu_torch import serve


def port_cfg():
    """llama_tiny in f32, as the JAX reference. (torch is imported here,
    not at the top: a replica of a plain deployment, which imports this
    module again, never loads it.)"""
    import torch

    from ray_tpu_torch.models.configs import llama_tiny

    return llama_tiny(dtype=torch.float32)


class NpzParams:
    """Params factory for replicas: the JAX package's llama_tiny params,
    written by :class:`JaxReference`, loaded onto the CPU."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self):
        from ray_tpu_torch import convert

        tree = {"layers": {}}
        with np.load(self.path) as z:
            for k in z.files:
                if k.startswith("layers/"):
                    tree["layers"][k[len("layers/"):]] = z[k]
                else:
                    tree[k] = z[k]
        return convert.params_from_numpy(tree, port_cfg(), "cpu")


class JaxReference:
    """The JAX package's llama_tiny (f32, key 0) and its greedy
    ``generate`` per prompt (memoized)."""

    def __init__(self, directory):
        import jax
        import jax.numpy as jnp

        from ray_tpu.models import transformer as jtfm
        from ray_tpu.models.configs import llama_tiny

        self.cfg = llama_tiny(remat=False, dtype=jnp.float32)
        self.params = jtfm.init_params(jax.random.key(0), self.cfg)
        flat = {}
        for k, v in jax.tree.map(np.asarray, self.params).items():
            if k == "layers":
                flat.update({f"layers/{n}": a for n, a in v.items()})
            else:
                flat[k] = v
        self.path = os.path.join(str(directory), "llama_tiny.npz")
        np.savez(self.path, **flat)
        self.factory = NpzParams(self.path)
        self._memo = {}

    def tokens(self, prompt, n):
        key = (tuple(prompt), n)
        if key not in self._memo:
            import jax.numpy as jnp

            from ray_tpu.models import generate as gen_fn

            out = gen_fn(self.params, jnp.asarray([prompt], jnp.int32),
                         self.cfg, max_new_tokens=n)
            self._memo[key] = np.asarray(out)[0, len(prompt):].tolist()
        return self._memo[key]


def no_children_left(timeout: float = 10.0) -> bool:
    deadline = time.time() + timeout
    while multiprocessing.active_children():
        if time.time() > deadline:
            return False
        time.sleep(0.1)
    return True


@pytest.fixture(scope="module")
def serve_instance():
    yield
    serve.shutdown()
    assert no_children_left(), multiprocessing.active_children()


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return JaxReference(tmp_path_factory.mktemp("serve_params"))


# ------------------------------------------- deployments (module level)


@serve.deployment
def doubler(x):
    return x * 2


@serve.deployment(num_replicas=2)
class Counter:
    def __init__(self, start):
        self.start = start

    def __call__(self, x):
        return self.start + x

    def which(self):
        return os.getpid()


@serve.deployment
class Preprocess:
    def __call__(self, x):
        return x + 1


@serve.deployment
class Ensemble:
    def __init__(self, pre_handle):
        self.pre = pre_handle

    def __call__(self, x):
        y = self.pre.remote(x).result(timeout=30)
        return y * 10


@serve.deployment(max_ongoing_requests=16)
class BatchModel:
    def __init__(self):
        self.batch_sizes = []

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=1.5)
    def handle_batch(self, items):
        self.batch_sizes.append(len(items))
        return [i * 3 for i in items]

    def __call__(self, x):
        return self.handle_batch(x)

    def seen_batches(self):
        return self.batch_sizes


@serve.deployment(num_replicas=1)
def stable(x):
    return x


@serve.deployment(stream=True)
def ticker(n):
    for i in range(int(n)):
        yield {"tick": i}
        time.sleep(0.25)


# ------------------------------------------------------------- the runtime


def test_function_deployment_and_handle(serve_instance):
    handle = serve.run(doubler.bind(), route_prefix="/doubler")
    try:
        assert handle.remote(21).result(timeout=30) == 42
        resps = [handle.remote(i) for i in range(8)]
        assert [r.result(timeout=30) for r in resps] == [i * 2
                                                         for i in range(8)]
    finally:
        serve.delete("doubler")


def test_shutdown_stops_fork_server(serve_instance):
    """Replicas fork from multiprocessing's fork server, which is no child
    that ``active_children()`` lists: shutdown stops it too."""
    from multiprocessing import forkserver

    assert serve.run(doubler.bind()).remote(4).result(timeout=60) == 8
    pid = forkserver._forkserver._forkserver_pid
    assert pid is not None
    os.kill(pid, 0)  # alive while serve runs
    serve.shutdown()
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"fork server {pid} outlived serve.shutdown()")
    assert no_children_left(), multiprocessing.active_children()


def test_class_deployment_with_replicas(serve_instance):
    handle = serve.run(Counter.bind(100), route_prefix="/counter")
    try:
        assert handle.remote(5).result(timeout=30) == 105
        # two replicas -> requests spread over two processes
        pids = {handle.which.remote().result(timeout=30) for _ in range(20)}
        assert len(pids) == 2
        assert serve.status()["Counter"]["num_replicas"] == 2
    finally:
        serve.delete("Counter")


def test_model_composition(serve_instance):
    """The child's handle goes to the parent's replica process by pickle
    and asks the controller, over its address, for the child's
    replicas."""
    handle = serve.run(Ensemble.bind(Preprocess.bind()),
                       route_prefix="/ensemble")
    try:
        assert handle.remote(4).result(timeout=60) == 50
    finally:
        serve.delete("Ensemble")
        serve.delete("Preprocess")


def test_batching(serve_instance):
    handle = serve.run(BatchModel.bind(), route_prefix="/batch")
    try:
        resps = [handle.remote(i) for i in range(8)]
        assert [r.result(timeout=30) for r in resps] == [i * 3
                                                         for i in range(8)]
        sizes = handle.seen_batches.remote().result(timeout=30)
        assert max(sizes) > 1, f"batching never coalesced: {sizes}"
    finally:
        serve.delete("BatchModel")


def test_replica_recovery(serve_instance):
    from ray_tpu_torch.serve import controller

    handle = serve.run(stable.bind(), route_prefix="/stable")
    try:
        assert handle.remote(1).result(timeout=30) == 1
        # Kill the replica out from under the controller: its sentinel
        # reports the death and a replacement is spawned; requests retry.
        _, reps = controller._local.get_replicas("stable")
        os.kill(reps[0].pid, 9)
        deadline = time.time() + 30
        ok = False
        while time.time() < deadline:
            try:
                if handle.remote(2).result(timeout=10) == 2:
                    ok = True
                    break
            except Exception:
                time.sleep(0.5)
        assert ok, "deployment did not recover after replica kill"
        _, reps2 = controller._local.get_replicas("stable")
        assert [r.pid for r in reps2] != [r.pid for r in reps]
    finally:
        serve.delete("stable")


def test_streaming_handle(serve_instance):
    """Handle stream=True yields items while the replica is still
    producing."""
    handle = serve.run(ticker.bind(), route_prefix="/ticker")
    try:
        t0 = time.perf_counter()
        it = iter(handle.options(stream=True).remote(4))
        first = next(it)
        t_first = time.perf_counter() - t0
        assert first == {"tick": 0}
        rest = list(it)
        t_all = time.perf_counter() - t0
        assert rest == [{"tick": i} for i in range(1, 4)]
        # Relative timing: buffered-then-returned delivery would put
        # t_first ~= t_all.
        assert t_first < t_all - 0.4, (t_first, t_all)
    finally:
        serve.delete("ticker")


# ------------------------------------------------------------------ LLMs


@pytest.fixture(scope="module")
def tiny_llm(serve_instance, jref):
    """One batched LLM deployment for the three cases below (each of
    tests/test_serve.py's deploys its own): batches of up to 3, prompts
    truncated to 8, at most 4 new tokens."""
    from ray_tpu_torch.serve.llm import build_llm_deployment

    LLM = build_llm_deployment(
        port_cfg(), jref.factory, name="tiny-llm", max_batch_size=3,
        max_prompt_len=8, max_new_tokens=4, batch_wait_timeout_s=0.2,
        num_gpus=0)
    yield serve.run(LLM.bind())
    serve.delete("tiny-llm")


def test_llm_deployment_serves_generation(tiny_llm, jref):
    """build_llm_deployment: batched generation behind Serve; greedy
    results equal the JAX package's generate() for each prompt."""
    prompts = [[5, 9, 2], [7, 1, 3], [4, 4, 8, 8, 1]]  # two lengths
    refs = [tiny_llm.remote({"tokens": p}) for p in prompts]
    outs = [r.result(timeout=120) for r in refs]
    for p, out in zip(prompts, outs):
        assert out["tokens"] == jref.tokens(p, 4), (p, out)


def test_llm_deployment_error_isolation_and_cap(tiny_llm, jref):
    """A malformed request answers with its own error without poisoning
    the batch; oversized max_new_tokens is capped with a signal."""
    refs = [tiny_llm.remote({"tokens": [1, 2, 3]}),
            tiny_llm.remote({"tokens": []}),
            tiny_llm.remote({"tokens": [4, 5], "max_new_tokens": 99})]
    good, bad, capped = [r.result(timeout=120) for r in refs]
    assert good["tokens"] == jref.tokens([1, 2, 3], 4)
    assert "error" in bad
    assert capped["max_new_tokens_capped"] == 4
    assert capped["tokens"] == jref.tokens([4, 5], 4)


def test_llm_bad_max_new_tokens_and_prompt_truncation(tiny_llm, jref):
    refs = [tiny_llm.remote({"tokens": [1, 2], "max_new_tokens": "lots"}),
            tiny_llm.remote({"tokens": [3, 4], "max_new_tokens": 2}),
            tiny_llm.remote({"tokens": [9, 8, 7, 6, 5, 4, 3, 2, 1, 9]})]
    bad, good, trunc = [r.result(timeout=120) for r in refs]
    assert "error" in bad  # its own error, batch not poisoned:
    assert good["tokens"] == jref.tokens([3, 4], 4)[:2]
    assert trunc["prompt_truncated_to"] == 8
    assert trunc["tokens"] == jref.tokens([7, 6, 5, 4, 3, 2, 1, 9], 4)
    sizes = serve.get_app_handle("tiny-llm").options(
        method_name="serve_stats").remote().result(timeout=30)
    assert sizes["batches"] >= 1 and max(sizes["batch_sizes"]) <= 3


def test_streaming_llm_tokens_arrive_incrementally(serve_instance, jref):
    """Streaming LLM deployment: per-token chunks equal the JAX package's
    greedy generation, the first token arrives before the rest are done,
    and eos stops early."""
    from ray_tpu_torch.serve.llm import build_streaming_llm_deployment

    n = 24
    LLM = build_streaming_llm_deployment(
        port_cfg(), jref.factory, name="stream-llm", max_prompt_len=8,
        max_new_tokens=n, num_gpus=0)
    handle = serve.run(LLM.bind())
    try:
        prompt = [3, 1, 4, 1, 5]
        exp = jref.tokens(prompt, n)
        t0 = time.perf_counter()
        it = iter(handle.options(stream=True).remote({"tokens": prompt}))
        first = next(it)
        t_first = time.perf_counter() - t0
        rest = list(it)
        t_all = time.perf_counter() - t0
        assert [first["token"]] + [c["token"] for c in rest] == exp
        assert t_first < t_all * 0.8, (t_first, t_all)
        out2 = list(handle.options(stream=True).remote(
            {"tokens": prompt, "eos_id": exp[1]}))
        assert [c["token"] for c in out2] == exp[:2]
    finally:
        serve.delete("stream-llm")


def test_streaming_llm_continuous_batching(serve_instance, jref):
    """continuous_batching=True: concurrent streams share one decode tick
    in the replica process and each still equals isolated greedy
    generation by the JAX package."""
    from ray_tpu_torch.serve.llm import build_streaming_llm_deployment

    LLM = build_streaming_llm_deployment(
        port_cfg(), jref.factory, name="cb-llm", max_prompt_len=16,
        max_new_tokens=4, continuous_batching=True, num_slots=2,
        num_gpus=0)
    handle = serve.run(LLM.bind())
    try:
        prompts = [[3, 1, 4, 1], [5, 9], [2, 6, 5, 3, 5]]
        streams = [handle.options(stream=True).remote({"tokens": p})
                   for p in prompts]
        for p, st in zip(prompts, streams):
            assert [c["token"] for c in st] == jref.tokens(p, 4), p
    finally:
        serve.delete("cb-llm")


def test_replica_and_controller_survive_a_failed_handshake(serve_instance):
    """A caller that connects and leaves before the authentication
    handshake ends (its accept() raises an OSError) costs the replica and
    the controller that one connection: both go on accepting."""
    import socket
    import threading

    from ray_tpu_torch.serve import controller

    handle = serve.run(doubler.bind(), route_prefix="/doubler")
    try:
        (rep,) = controller._local.get_replicas("doubler")[1]
        for address in (rep.address, controller._local.address) * 3:
            s = socket.socket(socket.AF_UNIX)
            s.connect(address)
            s.close()
        out = []

        def calls():
            out.append(handle.remote(4).result(timeout=10))
            client = controller.ControllerClient(controller._local.address)
            out.append(client.get_deployment_names())

        t = threading.Thread(target=calls, daemon=True)
        t.start()
        t.join(30)
        assert not t.is_alive(), "a call hung after the failed handshakes"
        assert out[0] == 8 and "doubler" in out[1], out
    finally:
        serve.delete("doubler")


def test_connect_retries_a_full_queue(monkeypatch):
    """A listener whose queue is full answers a connect with EAGAIN on
    some kernels (a busy replica, not a dead one): ``connect`` retries it
    for a while before it raises."""
    import multiprocessing.connection as mpc

    from ray_tpu_torch.serve import replica

    calls = []

    def client(address, family=None, authkey=None):
        calls.append(address)
        if len(calls) < 3:
            raise BlockingIOError(11, "Resource temporarily unavailable")
        return "conn"

    monkeypatch.setattr(mpc, "Client", client)
    assert replica.connect("addr") == "conn" and len(calls) == 3
    monkeypatch.setattr(replica, "_CONNECT_RETRY_S", 0.0)
    calls.clear()
    with pytest.raises(BlockingIOError):
        replica.connect("addr")
