"""The port's ``util/tracing.py`` held to the JAX package's on the same
inputs: the W3C ``traceparent`` round trip (the mirror of
tests/test_tracing.py:83), the built-in tracer's span tree (nesting,
kinds, attributes, the error attribute, the restored context),
``setup_tracing``'s switch, and, with tracing on and no serve controller,
``get_cluster_spans`` reading back what this process shipped to its own
sink. The serve cases (tracing off adds nothing, the mirror of
tests/test_tracing.py:65; tracing on returns every process's hops of a
request) are in test_torch_serve_trace.py. The port has no tasks, so
tests/test_tracing.py:12 and :44 have no counterpart."""
import pytest

from ray_tpu_torch.core import sink as psink
from ray_tpu_torch.util import tracing as ptracing


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
