"""The port's metrics, event and telemetry planes held to the JAX
package's on the same inputs: ``util/metrics.py`` (tags, histogram merge,
boundary refusal, the one flusher, the atexit flush, re-buffering only
what never left, at most once where the answer came late),
``core/events.py`` (the mirrors of tests/test_events.py's EventLog and
util.metrics cases), ``core/telemetry.py``'s TSDB (the mirrors of
tests/test_telemetry.py's cases, each query equal to JAX's), the sink
(``core/sink.py``: the metric ingest against the JAX controller's
``_h_metric_update``, the Prometheus text byte for byte against its
``_metrics_text``, the ``/metrics`` responder), the request ledger against
``_h_serve_request_events``/``_h_serve_requests``, and the waterfall
against ``ray_tpu.util.state.serve_trace``. Nothing of the JAX package
changes: its controller methods run on stubs that hold only what they
read."""
import asyncio
import collections
import copy
import os
import pickle
import threading
import time
import urllib.request

import numpy as np
import pytest

from ray_tpu_torch.core import events as pevents
from ray_tpu_torch.core import sink as psink
from ray_tpu_torch.core import telemetry as ptelemetry
from ray_tpu_torch.serve.controller import RequestLedger
from ray_tpu_torch.util import metrics as pmetrics
from ray_tpu_torch.util import state as pstate


def _jax_controller():
    from ray_tpu.core.controller import Controller

    return Controller


# ------------------------------------------------------------ EventLog


def _event_script(log_cls, make, path):
    """tests/test_events.py:70's scenario on one EventLog class; every
    query's result, the ring and the counts."""
    out = {}
    log = log_cls(maxlen=16, persist_path=path)
    for i in range(4):
        log.append(make("INFO", "controller", "NODE_ADDED", f"node {i}",
                        node_id=f"node{i}aaaa", ts=100.0 + i))
    log.append(make("ERROR", "controller", "TASK_HUNG", "stuck",
                    task_id="tid123456", worker_id="w1",
                    data={"stack": "frame"}, ts=104.0))
    log.append(make("WARNING", "agent", "NODE_DRAINING", "bye",
                    node_id="node2bbbb", ts=105.0))
    out["warning"] = log.query(severity="WARNING")
    out["hung"] = log.query(kinds=["TASK_HUNG"])
    out["task_prefix"] = log.query(task_id="tid1")
    out["node_prefix"] = log.query(node_id="node2")
    seq = out["hung"][0]["seq"]
    out["after"] = log.query(after_seq=seq)
    out["since"] = log.query(since=103.5)
    for i in range(40):
        log.append(make("DEBUG", "controller", "FILLER", str(i),
                        ts=200.0 + i))
    out["ring"] = list(log.ring)
    out["counts"] = dict(log.counts)
    old_seq = log.seq
    log2 = log_cls(maxlen=16, persist_path=path)
    out["restored_seq"] = (log2.seq, old_seq)
    out["restored_ring"] = list(log2.ring)
    out["post"] = log2.append(make("INFO", "controller", "POST", "after",
                                   ts=300.0))
    out["post_query"] = log2.query(kinds=["POST"])
    out["limit"] = log2.query(limit=3)
    return out


def test_event_log_ring_filters_and_persistence(tmp_path):
    """The mirror of tests/test_events.py:70: ring bound, severity and
    kind and entity-prefix filters, the follow cursor, JSONL restore with
    the seq continuing; every result equal to the JAX EventLog's."""
    from ray_tpu.core import events as jevents

    got = _event_script(pevents.EventLog, pevents.make_event,
                        str(tmp_path / "port.jsonl"))
    want = _event_script(jevents.EventLog, jevents.make_event,
                         str(tmp_path / "jax.jsonl"))
    assert got == want
    assert {e["kind"] for e in got["warning"]} == {"TASK_HUNG",
                                                   "NODE_DRAINING"}
    assert len(got["ring"]) == 16
    assert got["counts"][("controller", "INFO")] == 4
    assert got["restored_seq"][0] == got["restored_seq"][1]
    assert got["post"]["seq"] == got["restored_seq"][1] + 1


def test_event_log_disabled_emits_nothing(monkeypatch):
    """The mirror of tests/test_events.py:112."""
    from ray_tpu.core import events as jevents

    rings = []
    for mod in (pevents, jevents):
        monkeypatch.setenv("RTPU_EVENTS", "0")
        log = mod.EventLog(maxlen=8)
        log.emit("ERROR", "TASK_HUNG", "nope")
        assert not log.ring
        monkeypatch.setenv("RTPU_EVENTS", "1")
        log.emit("ERROR", "TASK_HUNG", "yep", task_id="t1")
        assert len(log.ring) == 1
        rings.append([{k: v for k, v in e.items() if k != "ts"}
                      for e in log.ring])
    assert rings[0] == rings[1]


def test_event_emit_ships_to_the_sink(monkeypatch):
    """``emit`` buffers; a flush delivers the batch to this process's
    sink (no serve controller here); a failed delivery puts it back."""
    sink = psink.MetricsSink()
    monkeypatch.setattr(psink, "_local_sink", sink)
    pevents.emit("WARNING", "STREAM_STALLED", "silent", source="serve",
                 data={"age_s": 1.0})
    monkeypatch.setattr(psink, "deliver", lambda *a, **k: False)
    assert pevents.flush_events() is False
    monkeypatch.undo()
    monkeypatch.setattr(psink, "_local_sink", sink)
    assert pevents.flush_events() is True
    (ev,) = sink.get_events(kinds=["STREAM_STALLED"])
    assert ev["source"] == "serve" and ev["data"] == {"age_s": 1.0}
    assert ev["seq"] == 1


# --------------------------------------------------- util/metrics units


@pytest.mark.parametrize("tags", [None, {}, {"b": "2", "a": "1"},
                                  {"a": "1", "b": "2"}, {"model": "m"}])
def test_metrics_tags_tuple_normalization(tags):
    """The mirror of tests/test_events.py:125: the same tags always make
    the same series key, as the JAX function makes it."""
    from ray_tpu.util import metrics as jmetrics

    assert pmetrics._tags_tuple(tags) == jmetrics._tags_tuple(tags)
    if tags:
        assert pmetrics._tags_tuple(tags) == tuple(sorted(tags.items()))


def test_metrics_hist_merge():
    """The mirror of tests/test_events.py:136, against the JAX merge."""
    from ray_tpu.util import metrics as jmetrics

    for mod in (pmetrics, jmetrics):
        dst = mod._hist_state([0.1, 1.0])
        mod._hist_merge(dst, {"buckets": [1, 2, 3], "sum": 4.5,
                              "count": 6})
        assert dst == {"buckets": [1, 2, 3], "sum": 4.5, "count": 6}
        with pytest.raises(ValueError, match="bucket count"):
            mod._hist_merge(dst, {"buckets": [1] * 5, "sum": 5.0,
                                  "count": 5})
        assert dst == {"buckets": [1, 2, 3], "sum": 4.5, "count": 6}


def test_metrics_atexit_flush_registered():
    """The mirror of tests/test_events.py:153: the module registers an
    atexit flush (the flusher is a daemon thread), callable here."""
    import atexit

    assert hasattr(pmetrics, "_atexit_flush")
    atexit.unregister(pmetrics._atexit_flush)
    atexit.register(pmetrics._atexit_flush)
    pmetrics._atexit_flush()


def test_histogram_boundary_mismatch_rejected():
    """The mirror of tests/test_telemetry.py:327."""
    h1 = pmetrics.Histogram("torch_telem_lint_lat", boundaries=[0.1, 1.0])
    h1.observe(0.5)
    h2 = pmetrics.Histogram("torch_telem_lint_lat",
                            boundaries=[0.2, 2.0, 20.0])
    with pytest.raises(ValueError, match="different.*boundaries"):
        h2.observe(0.5)
    pmetrics.Histogram("torch_telem_lint_lat",
                       boundaries=[0.1, 1.0]).observe(0.7)


def test_metrics_flusher_single_thread_under_race():
    """The mirror of tests/test_telemetry.py:344: first records racing
    from 8 threads start one flusher."""
    barrier = threading.Barrier(8)

    def hammer(i):
        barrier.wait()
        pmetrics.Counter(f"torch_telem_race_{i}").inc(1.0)

    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    flushers = [t for t in threading.enumerate()
                if t.name == "rtpu-torch-metrics-flush" and t.is_alive()]
    assert len(flushers) == 1


def _record_sequence(mod, prefix):
    """Counters, gauges and histograms recorded through ``mod``'s
    instruments: the pending buffer they leave."""
    rng = np.random.default_rng(3)
    c = mod.Counter(prefix + "c", description="c", tag_keys=("k",))
    g = mod.Gauge(prefix + "g", description="g")
    h = mod.Histogram(prefix + "h", description="h",
                      boundaries=[0.01, 0.1, 1.0], tag_keys=("k",))
    for i in range(50):
        c.inc(float(i % 3), tags={"k": "ab"[i % 2]})
        g.set(float(i))
        h.observe(float(rng.exponential(0.3)), tags={"k": "ab"[i % 2]})
    return {n[len(prefix):]: m for n, m in mod._aggregator.pending.items()
            if n.startswith(prefix)}


def test_aggregator_buffer_equals_jax(monkeypatch):
    """The same records leave the same pending buffer (bucket counts,
    sums, last gauge) in the port's aggregator and the JAX package's."""
    from ray_tpu.util import metrics as jmetrics

    for mod in (pmetrics, jmetrics):
        monkeypatch.setattr(mod._aggregator, "_ensure_flusher_locked",
                            lambda: None)
    got = _record_sequence(pmetrics, "torch_agg_")
    want = _record_sequence(jmetrics, "torch_agg_")
    assert got == want
    for mod in (pmetrics, jmetrics):
        for n in [n for n in mod._aggregator.pending
                  if n.startswith("torch_agg_")]:
            del mod._aggregator.pending[n]


def test_failed_flush_rebuffers_merged(monkeypatch):
    """A delivery that fails puts the deltas back, merged with what was
    recorded meanwhile; the next flush delivers the sum once."""
    sink = psink.MetricsSink()
    monkeypatch.setattr(psink, "_local_sink", sink)
    monkeypatch.setattr(pmetrics._aggregator, "_ensure_flusher_locked",
                        lambda: None)
    pmetrics.flush_metrics()
    c = pmetrics.Counter("torch_rebuf_c")
    h = pmetrics.Histogram("torch_rebuf_h", boundaries=[1.0])
    c.inc(2.0)
    h.observe(0.5)
    sent = []

    def failing(method, *args, timeout):
        sent.append(args)
        return False

    monkeypatch.setattr(psink, "deliver", failing)
    assert pmetrics.flush_metrics() is False
    c.inc(3.0)
    h.observe(5.0)
    monkeypatch.undo()
    monkeypatch.setattr(psink, "_local_sink", sink)
    assert pmetrics.flush_metrics() is True
    fams = sink.families()
    assert fams["torch_rebuf_c"]["data"] == {(): 5.0}
    assert fams["torch_rebuf_h"]["data"] == {
        (): {"buckets": [1, 1], "sum": 5.5, "count": 2}}
    assert len(sent) == 1


def test_fork_child_starts_empty():
    """After a fork the child's aggregator and shipper are empty, with
    fresh locks and no flusher thread, and its sink route keeps only the
    owner's address."""
    pmetrics.Counter("torch_fork_c").inc(1.0)
    psink._shipper.add("serve_spans", {"name": "x"})
    owner = object()
    psink.set_route(owner, "\0rtpu-test-owner")
    try:
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:  # the child
            ok = (not pmetrics._aggregator.pending
                  and pmetrics._aggregator._thread is None
                  and pmetrics._aggregator.lock.acquire(blocking=False)
                  and psink._shipper.buffers == {}
                  and psink._shipper._thread is None
                  and psink._shipper.lock.acquire(blocking=False)
                  and psink._route_obj is None
                  and psink._route_address == "\0rtpu-test-owner")
            os.write(w, b"1" if ok else b"0")
            os._exit(0)
    finally:
        psink.set_route()
        with psink._shipper.lock:
            psink._shipper.buffers.pop("serve_spans", None)
    os.close(w)
    got = os.read(r, 1)
    os.close(r)
    os.waitpid(pid, 0)
    assert got == b"1"


class _SlowOwner:
    """A sink's owner on an abstract AF_UNIX address that answers each
    call ``delay_s`` after it arrived, keeping every (method, args) it
    received."""

    def __init__(self, delay_s: float) -> None:
        import multiprocessing
        import multiprocessing.connection as mpc

        self.address = f"\0rtpu-test-slow-owner-{os.getpid()}"
        self.delay_s = delay_s
        self.got = []
        self._listener = mpc.Listener(
            self.address, family="AF_UNIX",
            authkey=bytes(multiprocessing.current_process().authkey))
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._answer, args=(conn,),
                             daemon=True).start()

    def _answer(self, conn) -> None:
        while True:
            try:
                self.got.append(pickle.loads(conn.recv_bytes()))
            except (EOFError, OSError):
                return
            time.sleep(self.delay_s)
            try:
                conn.send_bytes(pickle.dumps(("ok", None)))
            except OSError:
                return

    def close(self) -> None:
        import multiprocessing
        import multiprocessing.connection as mpc

        self._stop.set()
        try:  # wake the accept loop, which then sees the stop
            mpc.Client(self.address, family="AF_UNIX",
                       authkey=bytes(
                           multiprocessing.current_process().authkey)).close()
        except OSError:
            pass
        self._listener.close()


def test_answer_after_the_timeout_is_not_sent_again(monkeypatch):
    """An owner that answers after the caller's timeout got each batch
    once: the metric deltas and the shipper's events are not buffered
    again, and later flushes send nothing (at most once, as the JAX
    package's flushers)."""
    monkeypatch.setattr(psink, "_local_sink", psink.MetricsSink())
    monkeypatch.setattr(pmetrics._aggregator, "_ensure_flusher_locked",
                        lambda: None)
    pmetrics.flush_metrics()
    psink.flush()
    owner = _SlowOwner(delay_s=0.6)
    try:
        monkeypatch.setattr(psink, "_route_address", owner.address)
        monkeypatch.setattr(pmetrics, "FLUSH_TIMEOUT_S", 0.2)
        pmetrics.Counter("torch_slow_owner_c").inc(4.0)
        t0 = time.monotonic()
        assert pmetrics.flush_metrics() is True
        assert time.monotonic() - t0 < 0.5  # gave up at its timeout
        assert not pmetrics._aggregator.pending
        pevents.emit("WARNING", "STREAM_STALLED", "late owner",
                     source="serve")
        assert psink.flush(timeout=0.2) is True
        time.sleep(1.4)  # past the owner's answers and the shipper's turn
        assert pmetrics.flush_metrics() is True
        assert psink.flush(timeout=0.2) is True
        time.sleep(0.3)
    finally:
        owner.close()
    methods = [m for m, _ in owner.got]
    assert methods.count("metric_update") == 1, methods
    assert methods.count("cluster_events") == 1, methods
    (wire,) = [a[0] for m, a in owner.got if m == "metric_update"]
    (fam,) = [f for f in wire if f["name"] == "torch_slow_owner_c"]
    assert fam["data"] == [([], 4.0)]


def test_batch_that_never_left_is_buffered_again(monkeypatch):
    """Where the owner's address has no listener the batch never left:
    the deltas and events stay buffered and reach the sink once a route
    to one exists."""
    sink = psink.MetricsSink()
    monkeypatch.setattr(psink, "_local_sink", sink)
    monkeypatch.setattr(pmetrics._aggregator, "_ensure_flusher_locked",
                        lambda: None)
    pmetrics.flush_metrics()
    psink.flush()
    monkeypatch.setattr(psink, "_route_address",
                        f"\0rtpu-test-no-owner-{os.getpid()}")
    pmetrics.Counter("torch_no_owner_c").inc(2.0)
    pevents.emit("WARNING", "STREAM_STALLED", "no owner", source="serve")
    assert pmetrics.flush_metrics() is False
    assert psink.flush(timeout=0.2) is False
    pmetrics.Counter("torch_no_owner_c").inc(1.0)
    monkeypatch.setattr(psink, "_route_address", None)
    assert pmetrics.flush_metrics() is True
    assert psink.flush() is True
    assert sink.families()["torch_no_owner_c"]["data"] == {(): 3.0}
    (ev,) = sink.get_events(kinds=["STREAM_STALLED"])
    assert ev["message"] == "no owner"


# ------------------------------------------------------------------ TSDB


def _both_tsdbs(**kw):
    from ray_tpu.core.telemetry import MetricsTSDB

    return ptelemetry.MetricsTSDB(**kw), MetricsTSDB(**kw)


def _gauge_fam(value, name="g"):
    return {name: {"type": "gauge", "help": "", "boundaries": [],
                   "data": {(): value}}}


def test_tsdb_gauge_history_and_retention():
    """The mirror of tests/test_telemetry.py:55; every query equal to
    JAX's."""
    port, ref = _both_tsdbs(step_s=1.0, retain=5)
    for db in (port, ref):
        for i in range(8):
            db.sample(100.0 + i, _gauge_fam(float(i)))
    for q in ({"name": "g"}, {"name": "g", "since": 106.0}):
        assert port.query(**q) == ref.query(**q)
    ser = port.query(name="g")[0]
    assert ser["type"] == "gauge" and ser["stat"] == "value"
    assert [v for _, v in ser["points"]] == [3.0, 4.0, 5.0, 6.0, 7.0]
    assert [v for _, v in port.query(name="g", since=106.0)[0]["points"]] \
        == [6.0, 7.0]


def test_tsdb_counter_rate_and_reset_clamp():
    """The mirror of tests/test_telemetry.py:70."""
    port, ref = _both_tsdbs(step_s=1.0, retain=100)

    def fam(v):
        return {"c": {"type": "counter", "help": "", "boundaries": [],
                      "data": {(("k", "a"),): v}}}

    for db in (port, ref):
        for t, v in ((10.0, 0.0), (12.0, 6.0), (13.0, 8.0), (14.0, 1.0)):
            db.sample(t, fam(v))
    assert port.query(name="c") == ref.query(name="c")
    ser = port.query(name="c")[0]
    assert ser["stat"] == "rate" and ser["tags"] == {"k": "a"}
    assert ser["total"] == 1.0
    assert [v for _, v in ser["points"]] == [3.0, 2.0, 0.0]


@pytest.mark.parametrize("stat,window_s", [(None, 60.0), ("p50", 0.5),
                                           ("p99", 0.5), ("mean", 0.5),
                                           ("rate", 0.5), ("rate", 60.0)])
def test_tsdb_histogram_windowed_quantiles(stat, window_s):
    """The mirror of tests/test_telemetry.py:99, each stat and window
    equal to JAX's."""
    bounds = [0.1, 1.0, 10.0]
    port, ref = _both_tsdbs(step_s=1.0, retain=100)

    def fam(buckets, total, s):
        return {"h": {"type": "histogram", "help": "", "boundaries": bounds,
                      "data": {(): {"buckets": buckets, "sum": s,
                                    "count": total}}}}

    for db in (port, ref):
        db.sample(100.0, fam([10, 0, 0, 0], 10, 0.5))
        db.sample(101.0, fam([10, 10, 0, 0], 20, 8.5))
    kw = {"name": "h", "window_s": window_s}
    if stat:
        kw["stat"] = stat
    assert port.query(**kw) == ref.query(**kw)
    if stat is None:
        p99 = next(s for s in port.query(name="h") if s["stat"] == "p99")
        t, v = p99["points"][-1]
        assert t == 101.0 and 0.1 < v <= 1.0
    elif stat == "mean":
        assert port.query(**kw)[0]["points"][-1][1] == pytest.approx(0.8)


def test_tsdb_latest_and_filters():
    """The mirror of tests/test_telemetry.py's filters case."""
    port, ref = _both_tsdbs(step_s=1.0, retain=10)
    fams = {
        "m_one": {"type": "gauge", "help": "", "boundaries": [],
                  "data": {(("node", "a"),): 1.0, (("node", "b"),): 2.0}},
        "m_two": {"type": "gauge", "help": "", "boundaries": [],
                  "data": {(): 9.0}},
    }
    for db in (port, ref):
        db.sample(1.0, fams)
    assert port.query(prefix="m_") == ref.query(prefix="m_")
    assert len(port.query(prefix="m_")) == 3
    assert port.query(name="m_one", tags={"node": "b"}) == ref.query(
        name="m_one", tags={"node": "b"})
    assert port.latest("m_two") == ref.latest("m_two")


# ----------------------------------------------------- the sink, /metrics


def _wire(rng, n_flushes=4):
    """Metric flushes as util/metrics.py sends them: counters, gauges and
    pre-aggregated histograms over a few tag sets."""
    flushes = []
    bounds = [0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0]
    for _ in range(n_flushes):
        hdata = []
        for model in ("m-a", 'm"b'):
            buckets = [int(x) for x in rng.integers(0, 4, len(bounds) + 1)]
            hdata.append(([["model", model]],
                          {"buckets": buckets,
                           "sum": float(rng.random() * 10),
                           "count": sum(buckets)}))
        flushes.append([
            {"name": "rtpu_serve_ttft_s", "type": "histogram",
             "help": "TTFT", "boundaries": bounds, "data": hdata},
            {"name": "rtpu_serve_decode_tokens_total", "type": "counter",
             "help": "tokens",
             "data": [([["model", "m-a"]], float(rng.integers(1, 9))),
                      ([["model", 'm"b']], float(rng.integers(1, 9)))]},
            {"name": "rtpu_serve_slots_busy", "type": "gauge",
             "help": "", "data": [([["model", "m-a"]],
                                   float(rng.integers(0, 4)))]},
            {"name": "app_untagged", "type": "counter", "help": "x\ny",
             "data": [([], 1.0)]},
        ])
    return flushes


def test_sink_ingest_and_exposition_equal_jax():
    """The sink's ingest of the same flushes gives the JAX controller's
    ``_h_metric_update`` state, and its Prometheus text is byte for byte
    ``Controller._metrics_text`` on a stub whose ``_metrics_families``
    returns the same families."""
    Controller = _jax_controller()
    flushes = _wire(np.random.default_rng(0))
    sink = psink.MetricsSink()

    class MetricStub:
        app_metrics = {}

    stub = MetricStub()
    stub.app_metrics = {}
    for wire in flushes:
        sink.metric_update(copy.deepcopy(wire))
        asyncio.run(Controller._h_metric_update(
            stub, None, {"metrics": copy.deepcopy(wire)}))
    fams = sink.families()
    assert fams == dict(sorted(stub.app_metrics.items()))

    class TextStub:
        def _metrics_families(self):
            return fams

    text = psink.metrics_text(fams)
    assert text == Controller._metrics_text(TextStub())
    assert 'rtpu_serve_ttft_s_bucket{model="m\\"b",le="+Inf"}' in text


def test_sink_serves_metrics_and_frees_the_port():
    """``start`` serves ``GET /metrics`` on an ephemeral port (404
    elsewhere) and samples the TSDB; ``stop`` frees the port."""
    import socket

    sink = psink.MetricsSink()
    sink.metric_update(_wire(np.random.default_rng(1), 1)[0])
    sink.start()
    try:
        host, port = sink.address.split(":")
        with urllib.request.urlopen(f"http://{sink.address}/metrics",
                                    timeout=10) as resp:
            body = resp.read().decode()
            assert resp.headers["Content-Type"].startswith("text/plain")
        assert body == psink.metrics_text(sink.families())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{sink.address}/other",
                                   timeout=10)
        sink.sample(now=1.0)
        sink.sample(now=2.0)
        res = sink.query_metrics(name="rtpu_serve_ttft_s", stat="p99")
        assert res["enabled"] and len(res["series"]) == 2
    finally:
        sink.stop()
    assert not [t for t in threading.enumerate()
                if t.name in ("rtpu-metrics-http", "rtpu-metrics-tsdb")]
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, int(port)))


# ------------------------------------------------------------ the ledger


def _ledger_batches(rng, n=30):
    """Shipped batches of spans and records for ``n`` requests, in an
    order where spans arrive before and after their records."""
    batches = []
    for i in range(n):
        rid = f"req-{i:04d}"
        tid = f"{i:032x}"
        spans = [{"name": name, "kind": "x", "trace_id": tid,
                  "span_id": f"{i:08x}{j:08x}", "parent_span_id": "",
                  "request_id": rid, "deployment": "dep",
                  "start_ts": 1000.0 + i, "dwell_s": float(rng.random()),
                  "attributes": ({"tokens": 8, "ttft_s": 0.1,
                                  "itl_p99_s": 0.02, "sent": 8,
                                  "abort_cause": ""}
                                 if name == "serve.stream" else {})}
                 for j, name in enumerate(("serve.assign", "serve.replica",
                                           "serve.stream"))]
        status = ["ok", "ok", "ok", "shed", "deadline", "error"][i % 6]
        record = {"request_id": rid, "trace_id": tid,
                  "deployment": "synthetic" if i % 4 else "other",
                  "method": "__call__", "proto": "python",
                  "status": status, "error": "", "start_ts": 1000.0 + i,
                  "wall_s": float(rng.random()), "slo_miss": i % 7 == 0}
        if i % 2:
            batches.append((spans, [record]))
        else:
            batches.append((spans[:1], []))
            batches.append((spans[1:], [record]))
    batches.append(([{"request_id": ""}], [{"request_id": ""}]))
    return batches


def test_ledger_ingest_and_query_equal_jax(monkeypatch):
    """The port's ledger, fed the same batches, holds the rows the JAX
    controller's ``_h_serve_request_events`` builds (LRU that keeps SLO,
    shed and deadline rows, at a cap of 16), and answers every query as
    its ``_h_serve_requests`` does."""
    Controller = _jax_controller()
    monkeypatch.setenv("RTPU_SERVE_LEDGER_MAX", "16")

    class LedgerStub:
        _serve_ledger_row = Controller._serve_ledger_row
        _serve_ledger_evict = Controller._serve_ledger_evict

        def __init__(self):
            self.serve_ledger = collections.OrderedDict()

    stub, ledger = LedgerStub(), RequestLedger()
    for spans, records in _ledger_batches(np.random.default_rng(2)):
        ledger.ingest(copy.deepcopy(spans), copy.deepcopy(records))
        asyncio.run(Controller._h_serve_request_events(
            stub, None, {"spans": copy.deepcopy(spans),
                         "records": copy.deepcopy(records)}))
    assert list(ledger.serve_ledger.items()) == list(
        stub.serve_ledger.items())
    assert len(ledger.serve_ledger) == 16
    assert not any(r["request_id"] == "req-0001"
                   for r in ledger.serve_ledger.values())
    assert any(r["retained"] for r in ledger.serve_ledger.values())
    for q in ({}, {"limit": 5}, {"model": "synthetic"}, {"status": "shed"},
              {"min_latency_s": 0.5}, {"since": 1050.0},
              {"request_id": "req-005"}, {"with_spans": True, "limit": 3},
              {"status": "inflight"}):
        got = ledger.query(**q)
        want = asyncio.run(Controller._h_serve_requests(stub, None, q))
        assert got == want, q


def _span_tree(rng, n=14):
    spans = [{"name": "serve.http", "kind": "ingress", "span_id": "s0",
              "parent_span_id": "", "deployment": "d", "start_ts": 10.0,
              "dwell_s": 5.0, "attributes": {"a": 1}}]
    for i in range(1, n):
        parent = spans[int(rng.integers(0, i))]
        spans.append({"name": f"serve.hop{i % 4}", "kind": "x",
                      "span_id": f"s{i}",
                      "parent_span_id": parent["span_id"],
                      "deployment": "d",
                      "start_ts": parent["start_ts"] + float(rng.random()),
                      "dwell_s": parent["dwell_s"] * float(rng.random())
                      / 2, "attributes": {}})
    spans.append({"name": "orphan", "span_id": "sx",
                  "parent_span_id": "gone", "start_ts": 11.0,
                  "dwell_s": 0.1})
    order = rng.permutation(len(spans))
    return [spans[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_waterfall_equals_jax(seed, monkeypatch):
    """``serve_trace``'s waterfall (depth-first, ``depth``, ``self_s``)
    equals ``ray_tpu.util.state.serve_trace``'s with ``_req`` answering
    the same row, an orphaned span a root of its own."""
    from ray_tpu.util import state as jstate

    row = {"request_id": "r1", "trace_id": "t", "status": "ok",
           "wall_s": 5.0, "spans": _span_tree(np.random.default_rng(seed))}
    monkeypatch.setattr(jstate, "_req", lambda msg: [copy.deepcopy(row)])
    monkeypatch.setattr(pstate, "_req",
                        lambda method, **kw: [copy.deepcopy(row)])
    got = pstate.serve_trace("r1")
    assert got == jstate.serve_trace("r1")
    wf = got["waterfall"]
    assert [w["name"] for w in wf if w["depth"] == 0] == ["serve.http",
                                                           "orphan"]
    monkeypatch.setattr(pstate, "_req", lambda method, **kw: [])
    with pytest.raises(KeyError):
        pstate.serve_trace("nope")


def test_ledger_never_evicts_the_row_it_fills(monkeypatch):
    """A divergence by design: where every other row is retained, a new
    unflagged row evicts the oldest retained row, never itself (the JAX
    controller's ingest raised a KeyError there); the ledger keeps its
    bound."""
    monkeypatch.setenv("RTPU_SERVE_LEDGER_MAX", "16")
    ledger = RequestLedger()
    ledger.ingest([], [{"request_id": f"shed-{i:02d}", "status": "shed"}
                       for i in range(16)])
    ledger.ingest([{"request_id": "fresh", "name": "serve.assign"}],
                  [{"request_id": "fresh", "status": "ok"}])
    rows = ledger.query(limit=100)
    assert len(rows) == 16
    assert rows[0]["request_id"] == "fresh" and rows[0]["status"] == "ok"
    assert "shed-00" not in {r["request_id"] for r in rows}


_TTFT_BOUNDS = [0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0]


@pytest.mark.parametrize("counts, q", [
    # chip_smoke's serve_trace buckets: 16 TTFTs, the p99 near the 0.25
    # edge, on either side of it.
    ([0, 0, 0, 15, 1, 0, 0, 0, 0, 0], 0.99),
    ([0, 0, 0, 16, 0, 0, 0, 0, 0, 0], 0.99),
    ([0, 0, 4, 12, 0, 0, 0, 0, 0, 0], 0.99),
    # A quantile that lands exactly on an edge (cum == target).
    ([0, 0, 50, 50, 0, 0, 0, 0, 0, 0], 0.5),
    ([2, 0, 0, 0, 0, 0, 0, 0, 0, 2], 0.5),
    # Empty buckets between, the first bucket, and past the last bound.
    ([0, 3, 0, 0, 0, 0, 1, 0, 0, 0], 0.9),
    ([5, 0, 0, 0, 0, 0, 0, 0, 0, 0], 0.01),
    ([1, 0, 0, 0, 0, 0, 0, 0, 0, 0], 1.0),
    ([0, 0, 0, 0, 0, 0, 0, 0, 0, 0], 0.99),
])
def test_hist_quantile_equals_jax(counts, q):
    """The controller's TTFT p99 (``_hist_quantile``) against the JAX
    package's on the same bucket counts, edges included; the +Inf bucket
    (counted, past the bounds) gives the last bound."""
    from ray_tpu.core import telemetry as jtelemetry

    over = 3 if counts[-1] else 0
    h = {"buckets": list(counts) + [over], "count": sum(counts) + over,
         "sum": 0.0}
    got = ptelemetry._hist_quantile(_TTFT_BOUNDS, h, q)
    assert got == jtelemetry._hist_quantile(_TTFT_BOUNDS, h, q)
