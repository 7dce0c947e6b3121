"""The port's per-request serving trace plane (``serve/trace.py``, the
serve controller's request ledger, ``util/state.py``), the mirror of
tests/test_serve_trace.py: nested handle composition and the
disaggregated prefill -> decode handoff share ONE trace id whose per-hop
exclusive dwells sum to the end-to-end wall; a SIGKILLed decode replica
leaves a row linking both attempts; gRPC mints and honours request ids;
SLO rows outlive LRU eviction; RTPU_SERVE_TRACE=0 leaves no span and no
row; the stream-stall detector fires exactly once; RTPU_TRACING off adds
no tracing span (the mirror of tests/test_tracing.py:65), and on it
returns the ledger row's spans from every process through
``util.tracing.get_cluster_spans``. Beyond the JAX file:
a stream through the HTTP proxy roots a ``serve.http`` trace and echoes
its ``X-Request-Id``; and for the nested scenario and one streamed LLM
request, the waterfall's multiset of (span name, depth) and the row's
status, proto, deployment and tokens equal the JAX package's run of the
same scenario (run meanwhile in a process of its own).

Deployments are module-level (a replica imports this module again), so
the module imports neither jax nor the JAX package at the top.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

import test_torch_serve as base
from ray_tpu_torch import serve
from ray_tpu_torch.serve import controller

REPO = pathlib.Path(__file__).resolve().parent.parent
ROW_FIELDS = ("status", "proto", "deployment", "tokens")
LLM_PROMPT = [5, 9, 2, 7]
LLM_NEW = 6


@pytest.fixture(scope="module")
def serve_instance():
    yield
    serve.shutdown()
    assert base.no_children_left()


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return base.JaxReference(tmp_path_factory.mktemp("serve_params"))


# The JAX package's side of the nested and streamed-LLM scenarios, run as
# a script of its own (its cluster, its replicas) while the port's runs
# here: per scenario the waterfall's (name, depth) pairs and row fields.
_JAX_SCENARIOS = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
import jax
import ray_tpu
from ray_tpu import serve
from ray_tpu.models import transformer as tfm
from ray_tpu.models.configs import llama_tiny
from ray_tpu.serve import trace
from ray_tpu.serve.llm import build_streaming_llm_deployment
from ray_tpu.util import state

CFG = llama_tiny(remat=False)


def factory():
    return tfm.init_params(jax.random.key(0), CFG)


@serve.deployment
class TraceInner:
    def __call__(self, x):
        time.sleep(0.3)
        return x + 1


@serve.deployment
class TraceOuter:
    def __init__(self, inner):
        self.inner = inner

    def __call__(self, x):
        time.sleep(0.1)
        return self.inner.remote(x).result(timeout=30) * 10


def row_of(rid, pred):
    deadline = time.time() + 60
    while time.time() < deadline:
        trace.flush_serve_trace()
        try:
            row = state.serve_trace(rid)
            if pred(row):
                return row
        except KeyError:
            pass
        time.sleep(0.25)
    raise AssertionError(rid)


def summary(row):
    return {{"pairs": sorted([w["name"], w["depth"]]
                             for w in row["waterfall"]),
             "fields": {{k: row.get(k) for k in {fields!r}}}}}


if __name__ == "__main__":
    ray_tpu.init(num_cpus=4)
    try:
        out = {{}}
        h = serve.run(TraceOuter.bind(TraceInner.bind()),
                      route_prefix="/trace-outer")
        assert h.options(request_id="jax-nested").remote(4).result(
            timeout=60) == 50
        out["nested"] = summary(row_of("jax-nested", lambda r: (
            r["status"] == "ok" and [s["name"] for s in r["spans"]].count(
                "serve.replica") >= 2)))
        app = build_streaming_llm_deployment(
            CFG, factory, name="trace-llm", max_prompt_len=16,
            max_new_tokens={new}, continuous_batching=True, num_slots=2)
        h = serve.run(app.bind(), route_prefix="/trace-llm")
        warm = list(h.options(stream=True).remote({{"tokens": [1, 2, 3]}}))
        toks = [c["token"] for c in h.options(
            stream=True, request_id="jax-llm").remote(
                {{"tokens": {prompt!r}}})]
        out["llm"] = summary(row_of("jax-llm", lambda r: (
            r["status"] == "ok" and r.get("tokens") is not None)))
        out["llm_tokens"] = toks
        print("JAX", json.dumps(out))
    finally:
        serve.shutdown()
        ray_tpu.shutdown()
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX scenarios' process, started at the module's first use and
    read once."""
    d = tmp_path_factory.mktemp("jax_trace")
    script = d / "jax_trace_scenarios.py"
    script.write_text(_JAX_SCENARIOS.format(
        repo=str(REPO), fields=ROW_FIELDS, prompt=LLM_PROMPT, new=LLM_NEW))
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(d))
    result = {}

    def read():
        if not result:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            (line,) = [ln for ln in out.splitlines()
                       if ln.startswith("JAX ")]
            result.update(json.loads(line[4:]))
        return result

    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _trace_row(request_id, pred=None, timeout=30.0):
    """Poll the ledger until the request's row (with its waterfall)
    satisfies ``pred``: replica-side spans arrive on the shipper's 0.5 s
    cadence, the driver's buffer is flushed here."""
    from ray_tpu_torch.serve import trace as serve_trace
    from ray_tpu_torch.util import state

    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        serve_trace.flush_serve_trace()
        try:
            last = state.serve_trace(request_id)
            if pred is None or pred(last):
                return last
        except KeyError:
            pass
        time.sleep(0.2)
    raise AssertionError(
        f"ledger row for {request_id!r} never satisfied predicate: {last}")


def _names(row):
    return [s["name"] for s in row.get("spans", ())]


def _summary(row):
    return {"pairs": sorted([w["name"], w["depth"]]
                            for w in row["waterfall"]),
            "fields": {k: row.get(k) for k in ROW_FIELDS}}


def _check_attribution(row, rel_tol, abs_tol):
    """The waterfall's exclusive times sum to the measured wall: one root,
    every other span under it, no child dwell exceeding its parent's."""
    wf = row["waterfall"]
    roots = [s for s in wf if s["depth"] == 0]
    assert len(roots) == 1, [f"{s['name']}@{s['depth']}" for s in wf]
    wall = row["wall_s"]
    attributed = sum(s["self_s"] for s in wf)
    assert abs(attributed - wall) <= rel_tol * wall + abs_tol, \
        (attributed, wall, [(s["name"], s["depth"], s["self_s"])
                            for s in wf])


# --------------------------------------------------- nested composition


@serve.deployment
class TraceInner:
    def __call__(self, x):
        time.sleep(0.3)
        return x + 1


@serve.deployment
class TraceOuter:
    def __init__(self, inner):
        self.inner = inner

    def __call__(self, x):
        time.sleep(0.1)
        return self.inner.remote(x).result(timeout=30) * 10


def test_nested_composition_one_trace_sums_to_wall(serve_instance,
                                                   jax_side):
    """A driver-side handle call into a deployment that calls a second
    one: every hop (driver root + assign, outer replica, nested assign,
    inner replica) lands in ONE row under one trace id, the exclusive
    dwells sum to the wall within rel 0.05 + 0.05 s, and the waterfall's
    (name, depth) pairs and the row's fields equal the JAX run's."""
    handle = serve.run(TraceOuter.bind(TraceInner.bind()),
                       route_prefix="/trace-outer")
    try:
        rid = "trace-nested-0001"
        assert handle.options(request_id=rid).remote(4).result(
            timeout=60) == 50
        row = _trace_row(rid, pred=lambda r: (
            r["status"] == "ok" and _names(r).count("serve.replica") >= 2))
    finally:
        serve.delete("TraceOuter")
        serve.delete("TraceInner")
    assert row["proto"] == "python"
    assert row["deployment"] == "TraceOuter"
    assert row["trace_id"]
    assert {s["trace_id"] for s in row["spans"]} == {row["trace_id"]}
    names = _names(row)
    assert names.count("serve.assign") == 2, names  # driver + nested
    assert names.count("serve.replica") == 2, names
    assert "serve.python" in names  # the driver-owned root span
    assert row["wall_s"] >= 0.4
    _check_attribution(row, rel_tol=0.05, abs_tol=0.05)
    assert _summary(row) == jax_side()["nested"]


# ------------------------------------------------ one streamed LLM request


def test_streamed_llm_request_matches_jax_trace(serve_instance, jref,
                                                jax_side):
    """One request streamed through the handle into a continuous-batching
    LLM replica: the root, assign, replica, stream, prefill and attach
    hops at the JAX run's depths, the row's fields (tokens included) the
    JAX row's, and the tokens the JAX stream's."""
    from ray_tpu_torch.serve.llm import build_streaming_llm_deployment

    app = build_streaming_llm_deployment(
        base.port_cfg(), jref.factory, name="trace-llm", max_prompt_len=16,
        max_new_tokens=LLM_NEW, continuous_batching=True, num_slots=2,
        num_gpus=0)
    handle = serve.run(app.bind(), route_prefix="/trace-llm")
    try:
        rid = "trace-llm-0001"
        toks = [c["token"] for c in handle.options(
            stream=True, request_id=rid).remote({"tokens": LLM_PROMPT})]
        row = _trace_row(rid, pred=lambda r: (
            r["status"] == "ok" and r.get("tokens") is not None))
    finally:
        serve.delete("trace-llm")
    assert toks == jref.tokens(LLM_PROMPT, LLM_NEW)
    assert row["tokens"] == LLM_NEW and row["ttft_s"] > 0
    assert {"serve.python", "serve.assign", "serve.replica",
            "serve.stream", "serve.prefill",
            "serve.engine_attach"} == set(_names(row))
    _check_attribution(row, rel_tol=0.15, abs_tol=0.1)
    ref = jax_side()
    assert ref["llm_tokens"] == toks
    assert _summary(row) == ref["llm"]


# ------------------------------------------------------- HTTP ingress


def test_http_stream_roots_a_trace_and_echoes_its_id(serve_instance,
                                                     jref):
    """A stream through the HTTP proxy: the row's root is ``serve.http``
    (the proxy owns the record: proto http, method POST), the client's
    X-Request-Id is echoed and names the row, and the exclusive dwells
    sum to the proxy's wall."""
    import urllib.request

    from ray_tpu_torch.serve import api
    from ray_tpu_torch.serve.llm import build_streaming_llm_deployment

    app = build_streaming_llm_deployment(
        base.port_cfg(), jref.factory, name="trace-http",
        max_prompt_len=16, max_new_tokens=LLM_NEW, continuous_batching=True,
        num_slots=2, num_gpus=0)
    serve.run(app.bind(), route_prefix="/trace-http", _http=True,
              http_port=0)
    try:
        rid = "trace-http-0001"
        req = urllib.request.Request(
            f"http://127.0.0.1:{api._proxy.port}/trace-http",
            data=json.dumps({"tokens": LLM_PROMPT}).encode(),
            headers={"X-Request-Id": rid})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.headers["X-Request-Id"] == rid
            toks = [json.loads(line)["token"] for line in resp]
        row = _trace_row(rid, pred=lambda r: (
            r["status"] == "ok" and r.get("tokens") is not None))
    finally:
        serve.delete("trace-http")
    assert toks == jref.tokens(LLM_PROMPT, LLM_NEW)
    assert row["proto"] == "http" and row["method"] == "POST"
    wf = row["waterfall"]
    assert wf[0]["name"] == "serve.http" and wf[0]["depth"] == 0
    assert wf[0]["attributes"]["items"] == LLM_NEW
    assert {"serve.assign", "serve.replica", "serve.stream",
            "serve.prefill", "serve.engine_attach"} <= set(_names(row))
    _check_attribution(row, rel_tol=0.15, abs_tol=0.1)


# ----------------------------------------------------- disagg tracing


@pytest.fixture(scope="module")
def disagg_handle(serve_instance, jref):
    from ray_tpu_torch.serve.disagg import build_disagg_llm_deployment

    app = build_disagg_llm_deployment(
        base.port_cfg(), jref.factory, name="trc", num_prefill_replicas=1,
        num_decode_replicas=2, num_slots=2, max_prompt_len=16,
        max_new_tokens=24, num_gpus=0)
    handle = serve.run(app, route_prefix="/trc")
    assert len(list(handle.options(stream=True).remote(
        {"tokens": [1, 2, 3]}))) == 24
    yield handle
    for n in ("trc", "trc-decode", "trc-prefill"):
        serve.delete(n)


def test_disagg_handoff_shares_trace_and_sums_to_wall(disagg_handle,
                                                      jref):
    """One stream through the disaggregated plane: ingress, decode
    attempt, stream, KV handoff (or a local prefill) and engine attach
    share the root's trace id; the stream span folds its token stats
    into the row; the exclusive dwells sum to the wall within rel 0.15 +
    0.1 s; the tokens are the JAX package's."""
    prompt = [2, 7, 1, 8]
    rid = "trace-disagg-0001"
    toks = [c["token"] for c in disagg_handle.options(
        stream=True, request_id=rid).remote({"tokens": prompt})]
    assert toks == jref.tokens(prompt, 24)
    row = _trace_row(rid, pred=lambda r: (
        r["status"] == "ok" and "serve.stream" in _names(r)
        and r.get("tokens") is not None))
    names = set(_names(row))
    assert {"serve.assign", "serve.replica", "serve.decode_attempt",
            "serve.stream", "serve.engine_attach"} <= names, names
    assert "serve.kv_handoff" in names or "serve.prefill" in names, names
    assert {s["trace_id"] for s in row["spans"]} == {row["trace_id"]}
    assert row["tokens"] == 24
    assert row["ttft_s"] > 0
    assert row["itl_p99_s"] is not None and row["itl_p99_s"] >= 0
    streams = [s for s in row["spans"] if s["name"] == "serve.stream"]
    assert any(s["attributes"].get("sent") == 24 for s in streams)
    handoffs = [s for s in row["spans"] if s["name"] == "serve.kv_handoff"]
    assert all(s["attributes"].get("bytes", 0) > 0
               or s["attributes"].get("error") for s in handoffs)
    _check_attribution(row, rel_tol=0.15, abs_tol=0.1)


@pytest.mark.chaos
def test_decode_sigkill_ledger_links_both_attempts(disagg_handle, jref):
    """Chaos: SIGKILL the decode replica mid-stream. The client still
    sees every token exactly once, and the row (fed by the surviving
    ingress replica's per-attempt spans) links the failed attempt (error
    attr) and the replay (attempt 2) under one trace id with terminal
    status ok."""
    from ray_tpu_torch.serve.prefix_cache import prefix_key

    def decode_reps():
        return controller._local.get_replicas("trc-decode")[1]

    def call(rep, method, *args):
        return rep.handle_request(method, args, timeout=30)

    prompt = [3, 1, 4, 1, 5]
    exp = jref.tokens(prompt, 24)
    warm = [c["token"] for c in disagg_handle.options(
        stream=True).remote({"tokens": prompt})]
    assert warm == exp
    h = prefix_key(prompt)
    reps = decode_reps()
    held = [call(r, "has_prefix", h) for r in reps]
    assert held.count(True) == 1
    victim = reps[held.index(True)]
    survivor = reps[held.index(False)]
    assert call(survivor, "pull_prefix", h, victim)
    victim_pid = call(victim, "pid")

    rid = "trace-chaos-0001"
    it = iter(disagg_handle.options(
        stream=True, request_id=rid).remote({"tokens": prompt}))
    got = [next(it)["token"] for _ in range(2)]
    os.kill(victim_pid, signal.SIGKILL)
    got += [c["token"] for c in it]
    assert got == exp, ("tokens duplicated or lost across re-route",
                        got, exp)
    row = _trace_row(rid, pred=lambda r: (
        r["status"] == "ok"
        and _names(r).count("serve.decode_attempt") >= 2))
    attempts = sorted(
        (s for s in row["spans"] if s["name"] == "serve.decode_attempt"),
        key=lambda s: s["attributes"].get("attempt", 0))
    assert attempts[0]["attributes"].get("error"), attempts[0]
    assert attempts[-1]["attributes"].get("attempt", 0) >= 2
    assert {s["trace_id"] for s in attempts} == {row["trace_id"]}
    # The controller restores the killed replica before the next test.
    deadline = time.time() + 60
    while time.time() < deadline:
        reps = decode_reps()
        if len(reps) == 2 and victim_pid not in [r.pid for r in reps]:
            break
        time.sleep(0.2)


# ------------------------------------------------------- gRPC ingress


@serve.deployment
def gecho(x):
    return {"ok": x}


def test_grpc_request_id_minted_and_ledgered(serve_instance):
    """A gRPC request WITHOUT a request_id gets one stamped at ingress,
    echoed in the initial metadata and naming the row, with the response
    envelope unchanged; a client-supplied id is honoured verbatim."""
    import grpc

    from ray_tpu_torch.serve import api

    serve.run(gecho.bind(), route_prefix="/gecho", _grpc=True, grpc_port=0)
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{api._grpc_proxy.port}")
        call = ch.unary_unary(
            "/rtpu.serve/Call",
            request_serializer=lambda o: json.dumps(o).encode(),
            response_deserializer=lambda b: json.loads(b.decode()))
        out, info = call.with_call({"route": "/gecho", "input": 5},
                                   timeout=30)
        assert out == {"result": {"ok": 5}}
        rid = dict(info.initial_metadata()).get("x-request-id")
        assert rid, "ingress did not mint a request id"
        row = _trace_row(rid, pred=lambda r: r["status"] == "ok")
        assert row["proto"] == "grpc" and row["method"] == "Call"
        assert row["trace_id"]
        out2, info2 = call.with_call(
            {"route": "/gecho", "input": 1, "request_id": "my-grpc-rid-1"},
            timeout=30)
        assert out2 == {"result": {"ok": 1}}
        assert dict(info2.initial_metadata())["x-request-id"] == \
            "my-grpc-rid-1"
        row2 = _trace_row("my-grpc-rid-1",
                          pred=lambda r: r["status"] == "ok")
        assert row2["request_id"] == "my-grpc-rid-1"
        ch.close()
    finally:
        serve.delete("gecho")


# -------------------------------------------------- stall + token stats


def test_stream_stall_detector_fires_exactly_once(monkeypatch):
    """No token for RTPU_SERVE_STALL_S while the slot is live: peek()
    emits ONE STREAM_STALLED event carrying a stack capture; repeated
    polls never fire it again; the final stats are clean, and an abort
    records its cause."""
    import torch

    from ray_tpu_torch.core import events
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.serve.llm_engine import ContinuousBatchingEngine

    cfg = base.port_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ContinuousBatchingEngine(cfg, params, num_slots=1,
                                   max_prompt_len=16, max_new_tokens=4,
                                   model="stall-test", device="cpu")
    fired = []
    monkeypatch.setattr(
        events, "emit",
        lambda sev, kind, msg, **kw: fired.append((sev, kind, msg, kw)))
    # The JAX test's threshold is 0.15 s; 1 s keeps a loaded test host's
    # submit-to-peek interval well below it.
    monkeypatch.setenv("RTPU_SERVE_STALL_S", "1.0")
    r = eng.submit([5, 9, 2])
    eng.peek(r)  # a fresh token stamp from attach: below the threshold
    assert not fired
    time.sleep(1.3)  # no ticker running: a stall
    eng.peek(r)
    eng.peek(r)
    eng.peek(r)
    assert len(fired) == 1, fired
    sev, kind, msg, kw = fired[0]
    assert sev == "WARNING" and kind == "STREAM_STALLED"
    data = kw["data"]
    assert data["engine_req"] == r and data["age_s"] >= 1.0
    assert "thread" in data["stack"], "stall event lost its stack capture"
    while eng.tick():
        pass
    assert len(eng.result(r, timeout=60)) == 4
    st = eng.token_stats(r)
    assert st["tokens"] == 4 and st["abort_cause"] == ""
    assert st["ttft_s"] is not None and st["itl_max_s"] >= 0
    r2 = eng.submit([5, 9, 2])
    eng.tick()
    live = eng.token_stats(r2)
    assert live and live["tokens"] >= 1
    eng.abort(r2)
    assert eng.token_stats(r2)["abort_cause"] == "aborted"


# ---------------------------------------------------- ledger retention


def test_ledger_retains_slo_rows_ahead_of_lru(serve_instance):
    """Rows flagged slo_miss (or shed / deadline) survive eviction while
    older ok rows are LRU'd out, and the ledger never exceeds
    RTPU_SERVE_LEDGER_MAX; the status and model filters narrow the
    listing."""
    from ray_tpu_torch import flags
    from ray_tpu_torch.serve import api
    from ray_tpu_torch.util import state

    api._get_or_create_controller()
    cap = int(flags.get("RTPU_SERVE_LEDGER_MAX"))

    def rec(rid, status="ok", slo=False, ts=1000.0):
        return {"request_id": rid, "trace_id": "t" * 32,
                "deployment": "synthetic", "method": "__call__",
                "proto": "python", "status": status, "error": "",
                "start_ts": ts, "wall_s": 0.5, "slo_miss": slo}

    records = [rec("keep-slo-row", slo=True),
               rec("keep-shed-row", status="shed")]
    records += [rec(f"evict-{i:05d}", ts=1001.0 + i)
                for i in range(cap + 50)]
    controller._local.serve_request_events([], records)
    assert state.serve_trace("keep-slo-row")["slo_miss"] is True
    assert state.serve_trace("keep-shed-row")["status"] == "shed"
    with pytest.raises(KeyError):
        state.serve_trace("evict-00000")
    rows = state.list_serve_requests(limit=cap + 200)
    assert len(rows) <= cap
    shed = state.list_serve_requests(status="shed", limit=10)
    assert any(r["request_id"] == "keep-shed-row" for r in shed)
    assert all(r["status"] == "shed" for r in shed)
    synth = state.list_serve_requests(model="synthetic", limit=5)
    assert synth and all(r["deployment"].startswith("synthetic")
                         for r in synth)


# ------------------------------------------------------- disabled path


@serve.deployment
def quiet(x):
    return x + 1


def test_disabled_path_no_spans_no_ledger(serve_instance, monkeypatch):
    """RTPU_SERVE_TRACE=0: hops cost one flag check and return None, no
    trace is rooted, and a served request leaves NO ledger row, from the
    driver or its replica."""
    from ray_tpu_torch.serve import trace as serve_trace
    from ray_tpu_torch.util import state

    monkeypatch.setenv("RTPU_SERVE_TRACE", "0")
    assert serve_trace.enabled() is False
    assert serve_trace.start_hop("serve.anything") is None
    assert serve_trace.start_request(deployment="d") is None
    assert serve_trace.current_trace_ctx() is None
    handle = serve.run(quiet.bind(), route_prefix="/quiet")
    try:
        rid = "disabled-path-0001"
        assert handle.options(request_id=rid).remote(1).result(
            timeout=30) == 2
        time.sleep(1.2)  # past the replica's shipper cadence
        serve_trace.flush_serve_trace()
        with pytest.raises(KeyError):
            state.serve_trace(rid)
    finally:
        serve.delete("quiet")


# ------------------------------------------------ the generic tracing plane


@serve.deployment
def traced(x):
    return x * 3


def _served_row(rid):
    handle = serve.run(traced.bind(), route_prefix="/traced")
    try:
        assert handle.options(request_id=rid).remote(2).result(
            timeout=30) == 6
        return _trace_row(rid, pred=lambda r: (
            r["status"] == "ok" and "serve.replica" in _names(r)))
    finally:
        serve.delete("traced")


def test_tracing_off_adds_nothing(serve_instance, monkeypatch):
    """The mirror of tests/test_tracing.py:65 on a serve request (the
    port has no tasks): with RTPU_TRACING unset the request is served
    and its ledger row written, and no tracing span exists for its
    trace, in the driver's record or in the sink, and no span context
    is left current."""
    from ray_tpu_torch.util import tracing

    monkeypatch.delenv("RTPU_TRACING", raising=False)
    row = _served_row("tracing-off-0001")
    time.sleep(0.7)  # past the replica's shipper cadence
    tracing.flush_spans()
    assert tracing.current_span_context() is None
    assert tracing.get_cluster_spans(row["trace_id"]) == []


def test_tracing_on_cluster_spans_match_the_ledger(serve_instance,
                                                   monkeypatch):
    """With RTPU_TRACING=1 (set before the deployment, so its replica
    inherits it) every hop of a request also lands in the tracing plane:
    ``get_cluster_spans(trace_id)`` returns the driver's root and assign
    spans and the replica's ``serve.replica`` span, which are the ledger
    row's spans: the same ids, names, kinds, parents, starts and
    dwells."""
    from ray_tpu_torch.util import tracing

    monkeypatch.setenv("RTPU_TRACING", "1")
    row = _served_row("tracing-on-0001")
    want = {s["span_id"] for s in row["spans"]}
    deadline = time.time() + 30
    while time.time() < deadline:
        tracing.flush_spans()
        spans = tracing.get_cluster_spans(row["trace_id"])
        if {d["span_id"] for d in spans} >= want:
            break
        time.sleep(0.2)
    assert sorted(d["name"] for d in spans) == sorted(_names(row))
    assert {"serve.python", "serve.assign", "serve.replica"} <= set(
        _names(row))
    by_id = {d["span_id"]: d for d in spans}
    for s in row["spans"]:
        d = by_id[s["span_id"]]
        assert (d["name"], d["kind"], d["trace_id"], d["parent_span_id"]) \
            == (s["name"], s["kind"], s["trace_id"],
                s["parent_span_id"] or "")
        assert d["start_time"] == s["start_ts"]
        assert d["end_time"] - d["start_time"] == pytest.approx(
            s["dwell_s"], abs=1e-6)
