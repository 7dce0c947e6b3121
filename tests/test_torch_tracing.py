"""The port's ``util/tracing.py`` held to the JAX package's on the same
inputs: the W3C ``traceparent`` round trip (the mirror of
tests/test_tracing.py:83), the built-in tracer's span tree (nesting,
kinds, attributes, the error attribute, the restored context),
``setup_tracing``'s switch, and, with tracing on and no serve controller,
``get_cluster_spans`` reading back what this process shipped to its own
sink. The serve cases (tracing off adds nothing, the mirror of
tests/test_tracing.py:65; tracing on returns every process's hops of a
request) are in test_torch_serve_trace.py. Task spans: the mirrors of
tests/test_tracing.py:12 (a task's CONSUMER span shares the driver's
trace, and the driver records the PRODUCER span of its submission, each
held to the JAX package's on the same scenario) and :44 (an actor call's
span shares the trace), an actor's constructor in a span of its
creation's trace, and with tracing off a submission that carries
nothing.

Task workers and actors import this module again, so its top loads
neither torch nor jax."""
import os

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import sink as psink
from ray_tpu_torch.util import tracing as ptracing


@rt.remote
def traced_work():
    """The consumer span is active around the task: its trace id is the
    driver's."""
    from ray_tpu_torch.util import tracing as t

    ctx = t.current_span_context()
    return (ctx.trace_id if ctx else "", bool(ctx and ctx.is_valid))


@rt.remote
class Probe:
    def __init__(self):
        from ray_tpu_torch.util import tracing as t

        self.born_in = t.current_trace_id()

    def trace_id(self):
        from ray_tpu_torch.util import tracing as t

        return t.current_trace_id()

    def birth_trace(self):
        return self.born_in


def _jtracing():
    from ray_tpu.util import tracing

    return tracing


@pytest.mark.parametrize("trace_id,span_id", [
    ("ab" * 16, "cd" * 8),
    ("0" * 31 + "1", "f" * 16),
    ("4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"),
])
def test_traceparent_roundtrip(trace_id, span_id):
    """The mirror of tests/test_tracing.py:83, with the wire string and
    validity equal to the JAX package's."""
    jt = _jtracing()
    outs = []
    for mod in (ptracing, jt):
        ctx = mod.SpanContext(trace_id=trace_id, span_id=span_id)
        back = mod.SpanContext.from_traceparent(ctx.to_traceparent())
        assert back == ctx
        assert mod.SpanContext.from_traceparent("garbage") is None
        outs.append((ctx.to_traceparent(), ctx.is_valid))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("tp", [
    "", "garbage", "00-ab-cd-01", "00-" + "ab" * 16 + "-" + "cd" * 8,
    "00-" + "ab" * 16 + "-" + "cd" * 7 + "-01",
    "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-00",
])
def test_from_traceparent_equals_jax(tp):
    port, jax_ = (mod.SpanContext.from_traceparent(tp)
                  for mod in (ptracing, _jtracing()))
    assert (port and (port.trace_id, port.span_id)) == \
        (jax_ and (jax_.trace_id, jax_.span_id))


def _span_tree(mod):
    """One scenario of nested spans on ``mod``'s built-in tracer: each
    recorded span as (name, kind, attributes, parent's name), the number
    of trace ids, and the context left behind."""
    mod.drain_finished_spans()
    with mod.start_span("root", kind="server", attributes={"route": "/a"}):
        with mod.start_span("child", attributes={"n": 1}):
            with mod.start_span("grandchild", kind="client"):
                pass
        try:
            with mod.start_span("boom"):
                raise ValueError("bad input")
        except ValueError:
            pass
    with mod.start_span("second-root"):
        pass
    spans = mod.drain_finished_spans()
    by_id = {s.context.span_id: s.name for s in spans}
    for s in spans:
        assert s.end_time >= s.start_time
    return ([(s.name, s.kind, s.attributes, by_id.get(s.parent_span_id))
             for s in spans],
            len({s.context.trace_id for s in spans}),
            mod.current_span_context(), mod.get_finished_spans())


def test_span_tree_equals_jax(monkeypatch):
    monkeypatch.delenv("RTPU_TRACING", raising=False)
    port, jax_ = _span_tree(ptracing), _span_tree(_jtracing())
    assert port == jax_
    assert port[1] == 2 and port[2] is None and port[3] == []


def test_setup_tracing_turns_it_on(monkeypatch):
    """``setup_tracing`` sets RTPU_TRACING in the environment (processes
    started afterwards inherit it), as the JAX package's does."""
    jt = _jtracing()
    for mod in (ptracing, jt):
        monkeypatch.delenv("RTPU_TRACING", raising=False)
        assert mod.enabled() is False
        mod.setup_tracing()
        assert mod.enabled() is True
        monkeypatch.delenv("RTPU_TRACING", raising=False)


def test_cluster_spans_from_this_process_sink(monkeypatch):
    """With tracing on and no serve controller, finished spans are
    shipped to this process's own sink: after the local record is
    drained, ``get_cluster_spans(trace_id)`` still returns the trace's
    spans (sorted by start) from the sink, and nothing of other traces.
    With tracing off nothing is shipped."""
    sink = psink.MetricsSink()
    monkeypatch.setattr(psink, "_local_sink", sink)
    monkeypatch.setattr(psink, "_route_obj", None)
    monkeypatch.setattr(psink, "_route_address", None)
    monkeypatch.setenv("RTPU_TRACING", "1")
    psink.flush()
    with ptracing.start_span("outer") as outer:
        with ptracing.start_span("inner"):
            pass
    with ptracing.start_span("other"):
        pass
    ptracing.drain_finished_spans()
    assert ptracing.flush_spans() is True
    got = ptracing.get_cluster_spans(outer.context.trace_id)
    assert [d["name"] for d in got] == ["outer", "inner"]
    assert got[1]["parent_span_id"] == got[0]["span_id"]
    assert {d["trace_id"] for d in got} == {outer.context.trace_id}
    monkeypatch.delenv("RTPU_TRACING")
    with ptracing.start_span("unshipped") as quiet:
        pass
    ptracing.drain_finished_spans()
    assert ptracing.flush_spans() is True
    assert ptracing.get_cluster_spans(quiet.context.trace_id) == []


def _task_span_scenario(mod, remote, get, init, shutdown, work):
    """tests/test_tracing.py:12 on one package: (the worker's trace is
    the driver's, the span inside is valid, the submit span's name and
    kind and whether its trace is the driver's, its end after start)."""
    mod.setup_tracing()
    try:
        init(num_cpus=2)
        with mod.start_span("driver-root") as root:
            driver_trace = root.context.trace_id
            worker_trace, valid = get(remote(work).remote(), timeout=60)
        submits = [sp for sp in mod.get_finished_spans()
                   if sp.name.startswith("submit traced")]
        return (worker_trace == driver_trace, valid, submits[0].name,
                submits[0].kind, submits[0].context.trace_id == driver_trace,
                submits[0].end_time >= submits[0].start_time)
    finally:
        os.environ.pop("RTPU_TRACING", None)
        shutdown()


def _jax_traced_work():
    from ray_tpu.util import tracing as t

    ctx = t.current_span_context()
    return (ctx.trace_id if ctx else "", bool(ctx and ctx.is_valid))


def test_trace_context_propagates_to_worker():
    """The mirror of tests/test_tracing.py:12, held to the JAX package's
    outcome on the same scenario."""
    import ray_tpu

    port = _task_span_scenario(ptracing, rt.remote, rt.get, rt.init,
                               rt.shutdown, traced_work.__rtpu_target__)
    traced = _jax_traced_work
    traced.__name__ = traced.__qualname__ = "traced_work"
    jax_ = _task_span_scenario(_jtracing(), ray_tpu.remote, ray_tpu.get,
                               ray_tpu.init, ray_tpu.shutdown, traced)
    assert port == jax_
    assert port == (True, True, "submit traced_work", "producer", True,
                    True)


def test_actor_call_spans_share_trace():
    """The mirror of tests/test_tracing.py:44; the constructor runs in a
    span of its creation's trace too."""
    ptracing.setup_tracing()
    try:
        rt.init(num_cpus=2)
        with ptracing.start_span("actor-root") as root:
            p = Probe.remote()
            inside = rt.get(p.trace_id.remote(), timeout=60)
        assert inside == root.context.trace_id
        assert rt.get(p.birth_trace.remote(), timeout=60) == \
            root.context.trace_id
        assert rt.get(p.trace_id.remote(), timeout=60) != inside
    finally:
        os.environ.pop("RTPU_TRACING", None)
        rt.shutdown()


def test_tracing_off_submission_carries_nothing(monkeypatch):
    monkeypatch.delenv("RTPU_TRACING", raising=False)
    rt.init(num_cpus=1)
    try:
        from ray_tpu_torch.core import api

        before = len(ptracing.get_finished_spans())
        ref = traced_work.remote()
        assert rt.get(ref, timeout=60) == ("", False)
        assert "trace_ctx" not in api.runtime().producers.get(
            ref.object_id).wire
        assert len(ptracing.get_finished_spans()) == before
        assert ptracing.current_span_context() is None
    finally:
        rt.shutdown()
