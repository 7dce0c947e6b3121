"""The port's ingresses (``ray_tpu_torch/serve/proxy.py``,
``grpc_proxy.py``) on its replica processes, the mirror of
tests/test_serve.py's HTTP and gRPC cases and
tests/test_serve_overload.py's 503/504 case, and the streaming LLM
deployment over HTTP token-exact against the JAX package's ``generate``
(``llama_tiny`` in f32 on both sides), with a client that disconnects
mid-stream freeing its engine slot.

The proxies listen on port 0 (a free port, read back from the proxy):
the tests run beside others that bind fixed ports. Deployments are
module-level (a replica imports this module again to find them); the LLM
side reuses test_torch_serve.py's params factory and JAX reference.
"""
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid

import pytest

import test_torch_serve as base
from ray_tpu_torch import serve
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve import controller


@pytest.fixture(scope="module")
def serve_instance():
    yield
    serve.shutdown()
    assert base.no_children_left()


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return base.JaxReference(tmp_path_factory.mktemp("serve_params"))


def _url(path):
    return f"http://127.0.0.1:{serve_api._proxy.port}{path}"


def _post(path, payload, headers=None, timeout=30):
    req = urllib.request.Request(
        _url(path), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


@serve.deployment
def echo(payload):
    return {"got": payload}


@serve.deployment(stream=True)
def sse(payload):
    for i in range(3):
        yield f"chunk{i}\n"


@serve.deployment(name="hold-http", max_ongoing_requests=1,
                  max_queued_requests=1)
class Hold:
    def __init__(self, gate):
        self.gate = gate

    def __call__(self, payload):
        while not os.path.exists(self.gate):
            time.sleep(0.02)
        return {"ok": True}


@serve.deployment(name="slow-http")
class SlowH:
    def __call__(self, payload):
        time.sleep(3.0)
        return {"ok": True}


@serve.deployment
def griddle(x):
    return {"doubled": (x or 0) * 2,
            "model": serve.get_multiplexed_model_id()}


@serve.deployment(stream=True)
def gstream(n):
    for i in range(int(n or 0)):
        yield {"i": i}


def test_http_proxy(serve_instance):
    serve.run(echo.bind(), route_prefix="/echo", _http=True, http_port=0)
    try:
        with _post("/echo", {"a": 1},
                   headers={"X-Request-Id": "rid-1"}) as resp:
            body = json.loads(resp.read())
            assert resp.headers["X-Request-Id"] == "rid-1"
        assert body == {"result": {"got": {"a": 1}}}
        # A minted request id is echoed too.
        with _post("/echo", "text") as resp:
            assert json.loads(resp.read()) == {"result": {"got": "text"}}
            assert len(resp.headers["X-Request-Id"]) == 16
        # 404 for an unknown route.
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(_url("/nope"), timeout=30)
        assert ei.value.code == 404
    finally:
        serve.delete("echo")


def test_streaming_http_chunked(serve_instance):
    """The HTTP proxy writes a chunked body fed item by item by the
    replica."""
    serve.run(sse.bind(), route_prefix="/sse", _http=True, http_port=0)
    try:
        req = urllib.request.Request(_url("/sse"), data=b"{}",
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers["Transfer-Encoding"] == "chunked"
            body = resp.read().decode()
        assert body == "chunk0\nchunk1\nchunk2\n"
    finally:
        serve.delete("sse")


def test_http_503_retry_after_and_504_deadline(serve_instance):
    """The proxy maps BackPressureError to 503 + Retry-After and a blown
    per-request budget (X-Request-Timeout-S) to 504."""
    gate = os.path.join(tempfile.gettempdir(), f"gate_{uuid.uuid4().hex}")
    serve.run(Hold.bind(gate), route_prefix="/hold-http", _http=True,
              http_port=0)
    codes, retry_after = [], []
    lock = threading.Lock()

    def post():
        try:
            with _post("/hold-http", {}, timeout=60) as resp:
                with lock:
                    codes.append(resp.status)
        except urllib.error.HTTPError as e:
            with lock:
                codes.append(e.code)
                if e.code == 503:
                    retry_after.append(e.headers.get("Retry-After"))

    threads = []
    try:
        for _ in range(6):
            t = threading.Thread(target=post)
            t.start()
            threads.append(t)
            time.sleep(0.15)
        deadline = time.time() + 20
        while len(codes) < 4 and time.time() < deadline:
            time.sleep(0.1)
    finally:
        with open(gate, "w"):
            pass
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    os.unlink(gate)
    assert codes.count(503) == 4, codes
    assert codes.count(200) == 2, codes
    assert retry_after and all(
        ra is not None and float(ra) >= 1 for ra in retry_after), retry_after
    serve.delete("hold-http")

    # 504: the request's own budget expires while the replica works.
    serve.run(SlowH.bind(), route_prefix="/slow-http", _http=True,
              http_port=0)
    try:
        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post("/slow-http", {}, headers={"X-Request-Timeout-S": "0.5"})
        assert ei.value.code == 504
        assert time.time() - t0 < 2.5
    finally:
        serve.delete("slow-http")


def test_grpc_ingress(serve_instance):
    """The gRPC ingress (a generic JSON-envelope service): a unary call,
    with the model id and request id from the envelope, and server
    streaming."""
    grpc = pytest.importorskip("grpc")
    serve.run(griddle.bind(), route_prefix="/g", _grpc=True, grpc_port=0)
    serve.run(gstream.bind(), route_prefix="/gs")
    ch = grpc.insecure_channel(f"127.0.0.1:{serve_api._grpc_proxy.port}")
    try:
        call = ch.unary_unary(
            "/rtpu.serve/Call",
            request_serializer=lambda o: json.dumps(o).encode(),
            response_deserializer=lambda b: json.loads(b.decode()))
        out, rpc = call.with_call({"route": "/g", "input": 21,
                                   "request_id": "grpc-rid",
                                   "multiplexed_model_id": "m-7"},
                                  timeout=30)
        assert out == {"result": {"doubled": 42, "model": "m-7"}}
        assert ("x-request-id", "grpc-rid") in rpc.initial_metadata()
        stream = ch.unary_stream(
            "/rtpu.serve/CallStream",
            request_serializer=lambda o: json.dumps(o).encode(),
            response_deserializer=lambda b: json.loads(b.decode()))
        items = [m["item"] for m in stream({"route": "/gs", "input": 3},
                                           timeout=30)]
        assert items == [{"i": 0}, {"i": 1}, {"i": 2}]
        with pytest.raises(grpc.RpcError) as ei:
            call({"route": "/none", "input": 1}, timeout=30)
        assert ei.value.code() == grpc.StatusCode.INTERNAL
    finally:
        ch.close()
        serve.delete("griddle")
        serve.delete("gstream")


def test_grpc_without_the_package_names_it(serve_instance, monkeypatch):
    """Without grpcio, serve.run(_grpc=True) raises an ImportError naming
    the package, before any replica is spawned."""
    import sys

    monkeypatch.setitem(sys.modules, "grpc", None)
    monkeypatch.setattr(serve_api, "_grpc_proxy", None)
    names = controller._local.get_deployment_names() \
        if controller._local else []
    with pytest.raises(ImportError, match="grpcio"):
        serve.run(griddle.bind(), route_prefix="/g", _grpc=True)
    after = controller._local.get_deployment_names() \
        if controller._local else []
    assert after == names


# ------------------------------------------------------------------ LLMs


def _http_stream(prompt, n, close_after=None):
    """One stream over HTTP, read line by line: its tokens, each token's
    seconds since the request, and the seconds to the end."""
    t0 = time.perf_counter()
    toks, stamps = [], []
    resp = _post("/llm", {"tokens": prompt, "max_new_tokens": n},
                 timeout=120)
    try:
        while True:
            line = resp.readline()
            if not line:
                break
            chunk = json.loads(line)
            assert "token" in chunk, chunk
            toks.append(chunk["token"])
            stamps.append(time.perf_counter() - t0)
            if close_after is not None and len(toks) == close_after:
                break
    finally:
        resp.close()
    return toks, stamps


def test_streaming_llm_over_http_matches_jax(serve_instance, jref):
    """The streaming LLM deployment (continuous batching, 2 slots) behind
    the HTTP proxy: three concurrent streams read chunk by chunk, each
    token for token the JAX package's greedy generation, the first token
    before the last; then a client that disconnects after 3 tokens frees
    its slot within one decode step, and the next stream still matches."""
    from ray_tpu_torch.serve.llm import build_streaming_llm_deployment

    n = 12
    LLM = build_streaming_llm_deployment(
        base.port_cfg(), jref.factory, name="http-llm", max_prompt_len=16,
        max_new_tokens=100, continuous_batching=True, num_slots=2,
        num_gpus=0)
    serve.run(LLM.bind(), route_prefix="/llm", _http=True, http_port=0)
    try:
        prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]
        out = [None] * len(prompts)

        def run(i):
            out[i] = _http_stream(prompts[i], n)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        for p, (toks, stamps) in zip(prompts, out):
            assert toks == jref.tokens(p, n), p
            assert stamps[0] < stamps[-1]
        (rep,) = controller._local.get_replicas("http-llm")[1]
        toks, _ = _http_stream(prompts[0], 100, close_after=3)
        assert toks == jref.tokens(prompts[0], 3)
        deadline = time.time() + 30
        while time.time() < deadline:
            st = rep.call("stats")["serve"]
            if st["cancels"] and st["slots_busy"] == 0:
                break
            time.sleep(0.05)
        assert len(st["cancels"]) == 1, st
        assert st["cancels"][0]["ticks_until_free"] <= 1, st
        assert st["slots_busy"] == 0, st
        assert _http_stream(prompts[1], n)[0] == jref.tokens(prompts[1], n)
    finally:
        serve.delete("http-llm")
