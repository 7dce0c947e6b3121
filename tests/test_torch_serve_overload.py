"""Overload-safe serving on the port's replica processes, the mirror of
tests/test_serve_overload.py: admission control (the bounded queue, the
circuit breakers), end-to-end deadlines, the ``@serve.batch`` seal, and
the cancel that frees an engine slot when a stream is closed mid-way.

The HTTP cases (503 + Retry-After, 504) are in
test_torch_serve_ingress.py. Deployments are module-level (a replica imports this module
again to find them); the LLM side reuses test_torch_serve.py's params
factory and JAX reference.
"""
import os
import tempfile
import threading
import time
import uuid

import pytest

import test_torch_serve as base
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_instance():
    yield
    serve.shutdown()
    assert base.no_children_left()


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return base.JaxReference(tmp_path_factory.mktemp("serve_params"))


def _gate_path():
    return os.path.join(tempfile.gettempdir(), f"gate_{uuid.uuid4().hex}")


@serve.deployment(max_ongoing_requests=1, max_queued_requests=1)
class Hold:
    def __call__(self, path):
        while not os.path.exists(path):
            time.sleep(0.02)
        return "ok"


@serve.deployment(max_ongoing_requests=1)
class Slow:
    def __call__(self, sec, mark=None):
        if mark:
            with open(mark, "w"):
                pass
        time.sleep(sec)
        return sec


@serve.deployment
def noop(x):
    return x


@serve.deployment
class Faulty:
    def __call__(self, flag):
        if os.path.exists(flag):
            raise RuntimeError("replica fault")
        return "healed"


@serve.deployment(num_replicas=2)
class Flaky:
    def __init__(self, claim_path):
        self.bad = False
        try:
            fd = os.open(claim_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            self.bad = True  # first replica up claims the bad role
        except FileExistsError:
            pass

    def __call__(self, x):
        if self.bad:
            raise RuntimeError("bad replica")
        return x


# ------------------------------------------------------------ admission


def test_queue_full_sheds_with_backpressure(serve_instance):
    """Beyond num_replicas*max_ongoing + max_queued in-flight requests the
    handle sheds synchronously with BackPressureError carrying a
    retry-after hint; admitted requests are untouched."""
    gate = _gate_path()
    handle = serve.run(Hold.options(name="hold").bind())
    admitted, shed = [], []
    try:
        for _ in range(6):
            try:
                admitted.append(handle.remote(gate))
            except serve.BackPressureError as e:
                assert e.retry_after_s > 0
                shed.append(e)
            time.sleep(0.1)
        # capacity = 1 replica x 1 ongoing + 1 queued = 2
        assert len(admitted) == 2, (len(admitted), len(shed))
        assert len(shed) == 4
    finally:
        with open(gate, "w"):
            pass
    assert [r.result(timeout=30) for r in admitted] == ["ok", "ok"]
    os.unlink(gate)
    serve.delete("hold")


def test_admission_disabled_never_sheds(serve_instance, monkeypatch):
    """RTPU_SERVE_ADMISSION=0 turns the whole admission plane off: the
    same flood that sheds above is accepted in full."""
    monkeypatch.setenv("RTPU_SERVE_ADMISSION", "0")
    gate = _gate_path()
    handle = serve.run(Hold.options(name="hold-off").bind())
    try:
        resps = [handle.remote(gate) for _ in range(6)]
    finally:
        with open(gate, "w"):
            pass
    assert [r.result(timeout=60) for r in resps] == ["ok"] * 6
    os.unlink(gate)
    serve.delete("hold-off")


# ------------------------------------------------------------- deadlines


def test_deadline_expires_while_queued(serve_instance):
    """A deadlined call stuck behind a slow one in the replica's queue
    surfaces DeadlineExceededError at its budget, NOT after the slow call
    finishes, and it never executes on the replica."""
    ran = os.path.join(tempfile.gettempdir(), f"ran_{uuid.uuid4().hex}")
    handle = serve.run(Slow.options(name="slowq").bind())
    r1 = handle.remote(3.0)
    time.sleep(0.3)  # r1 executing; the next call queues behind it
    r2 = handle.options(deadline_s=0.5).remote(0.0, ran)
    t0 = time.time()
    with pytest.raises(serve.DeadlineExceededError):
        r2.result()
    took = time.time() - t0
    assert took < 2.0, f"deadline surfaced only after {took:.1f}s"
    assert r1.result(timeout=30) == 3.0
    time.sleep(0.2)
    assert not os.path.exists(ran), "expired request still executed"
    serve.delete("slowq")


def test_deadline_preexpired_never_assigned(serve_instance):
    handle = serve.run(noop.options(name="noop-dl").bind())
    assert handle.remote(1).result(timeout=30) == 1
    with pytest.raises(serve.DeadlineExceededError):
        handle.options(deadline_s=-0.1).remote(1)
    serve.delete("noop-dl")


# ------------------------------------------------------- circuit breaker


def test_breaker_trips_after_consecutive_failures(serve_instance,
                                                  monkeypatch):
    """Consecutive replica faults open the per-replica breaker; with every
    replica tripped the router sheds instead of queueing doomed work, and
    the half-open probe readmits traffic after the cooldown."""
    monkeypatch.setenv("RTPU_SERVE_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("RTPU_SERVE_BREAKER_COOLDOWN_S", "1.0")
    fail_flag = _gate_path()
    with open(fail_flag, "w"):
        pass
    handle = serve.run(Faulty.options(name="faulty").bind())
    for _ in range(3):
        with pytest.raises(Exception):
            handle.remote(fail_flag).result(timeout=30)
    with pytest.raises(serve.BackPressureError):
        handle.remote(fail_flag).result(timeout=30)
    os.unlink(fail_flag)
    deadline = time.time() + 15
    while True:
        try:
            assert handle.remote(fail_flag).result(timeout=30) == "healed"
            break
        except serve.BackPressureError:
            assert time.time() < deadline, "breaker never half-opened"
            time.sleep(0.3)
    serve.delete("faulty")


def test_breaker_routes_around_failing_replica(serve_instance,
                                               monkeypatch):
    """With one of two replicas persistently failing, its breaker opens
    and the power-of-two pick stops offering it."""
    monkeypatch.setenv("RTPU_SERVE_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("RTPU_SERVE_BREAKER_COOLDOWN_S", "30.0")
    claim = _gate_path()
    handle = serve.run(Flaky.options(name="flaky2").bind(claim))
    failures = 0
    streak = 0
    for i in range(80):
        try:
            assert handle.remote(i).result(timeout=30) == i
            streak += 1
        except Exception:
            failures += 1
            streak = 0
        if streak >= 12:
            break
    os.unlink(claim)
    serve.delete("flaky2")
    assert failures > 0, "bad replica never hit — claim file logic broken"
    assert streak >= 12, (
        f"router kept sending to the tripped replica "
        f"({failures} failures, best streak {streak})")


# ------------------------------------------------------- batch coalescer


def test_batch_seal_drops_expired_items():
    """@serve.batch seal-time sweep: an item whose request deadline passed
    while coalescing gets DeadlineExceededError; live items run without
    it ever reaching the batch fn."""
    from ray_tpu_torch.serve import batching
    from ray_tpu_torch.serve import context as serve_context

    seen = []

    @batching.batch(max_batch_size=4, batch_wait_timeout_s=0.4)
    def fn(items):
        seen.append(sorted(items))
        return [i * 10 for i in items]

    results = {}

    def call(val, deadline_s):
        tok = None
        if deadline_s is not None:
            tok = serve_context.set_request_context(
                deadline_ts=time.time() + deadline_s)
        try:
            results[val] = fn(val)
        except Exception as e:
            results[val] = e
        finally:
            if tok is not None:
                serve_context.reset_request_context(tok)

    t1 = threading.Thread(target=call, args=(1, 0.05))  # expires in-queue
    t2 = threading.Thread(target=call, args=(2, None))
    t1.start()
    t2.start()
    t1.join(10)
    t2.join(10)
    assert isinstance(results[1], serve.DeadlineExceededError), results[1]
    assert results[2] == 20
    assert seen == [[2]], f"expired item reached the batch fn: {seen}"


# ------------------------------------------- streaming cancel / abort


def test_mid_stream_disconnect_frees_engine_slot(serve_instance, jref):
    """num_slots=1 continuous batching: closing stream A mid-decode
    cancels its engine request in the replica process (the cancel frees
    the slot at once; the closed generator's finally aborts too), so
    stream B gets the KV slot and completes correctly instead of queueing
    behind A's full generation."""
    from ray_tpu_torch.serve.llm import build_streaming_llm_deployment

    LLM = build_streaming_llm_deployment(
        base.port_cfg(), jref.factory, name="disc-llm", max_prompt_len=8,
        max_new_tokens=48, continuous_batching=True, num_slots=1,
        num_gpus=0)
    handle = serve.run(LLM.bind())
    try:
        prompt = [3, 1, 4, 1, 5]
        # Stream A: long generation, abandoned after the first token.
        a = handle.options(stream=True).remote({"tokens": prompt})
        first = next(iter(a))
        assert "token" in first, first
        a.close()
        # Stream B: must get the (only) slot promptly and match greedy.
        b = handle.options(stream=True, deadline_s=60).remote(
            {"tokens": prompt, "max_new_tokens": 4})
        toks = [c["token"] for c in b]
        assert toks == jref.tokens(prompt, 4), toks
        stats = handle.options(method_name="serve_stats",
                               stream=False).remote().result(timeout=30)
        assert stats["slots_busy"] == 0.0
        cancels = stats["cancels"]
        assert len(cancels) == 1 and cancels[0]["ticks_until_free"] <= 1, \
            cancels
    finally:
        serve.delete("disc-llm")
