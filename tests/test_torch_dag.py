"""The port's DAG layer on one host (``ray_tpu_torch.dag``): ``.bind()``
graphs, compiled DAGs on shared-memory channels, the channel meter and
in-place recovery, case for case with the JAX package's
tests/test_dag_workflow.py (:30-106, :258),
tests/test_compiled_dag_channels.py (:65-251, :327), tests/test_dag_meter.py
(:33-153) and tests/test_dag_recovery.py (:109, :371, :418, the last on
local edges); the JAX tests' nested classes and closure factories are
module-level here. One case runs the three-stage, diamond and
multi-output graphs through the JAX package's compiled DAG and the
port's and holds them equal.

Actor processes import this module again to find its classes, so its top
loads neither torch nor jax.
"""
import glob
import multiprocessing
import os
import signal
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import flags
from ray_tpu_torch.core.object_store import (CHANNEL_PREFIX,
                                             channel_segment_stats)
from ray_tpu_torch.dag import (DAGTeardownError, InputNode, MultiOutputNode,
                               meter)


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def double(x):
    return 2 * x


@rt.remote
def tag(x):
    return (x, time.time_ns())


class PlainCounter:
    """Stateful stage: the same instance serves every seq."""

    def __init__(self, k):
        self.k = k
        self.calls = 0

    def step(self, x):
        self.calls += 1
        return x + self.k

    def step_with_calls(self, x):
        self.calls += 1
        return (x, self.calls)


class PlainFan:
    def src(self, x):
        return x * 2

    def left(self, x):
        return x + 1

    def right(self, x):
        return x + 100

    def join(self, a, b):
        return (a, b)


Counter = rt.remote(PlainCounter)
Fan = rt.remote(PlainFan)


@rt.remote
class Accum:
    def __init__(self, start):
        self.v = start

    def incr(self, by):
        self.v += by
        return self.v


@rt.remote
class Stage:
    def __init__(self):
        self.calls = 0

    def work(self, x):
        self.calls += 1
        return x + self.calls


@rt.remote
class Slow:
    def __init__(self, delay_s=0.2):
        self.delay_s = delay_s

    def work(self, x):
        time.sleep(self.delay_s)
        return x

    def step(self, x):
        time.sleep(self.delay_s)
        return x + 1


@rt.remote
class Flaky:
    def step(self, x):
        if x == 3:
            raise ValueError("boom-on-3")
        return x + 10


@rt.remote
class Echo:
    def step(self, x):
        return x


@rt.remote
class SlowEcho:
    def step(self, x):
        time.sleep(0.02)
        return x


class MarkingStage:
    """A stateful, checkpointable stage step: it marks every microbatch it
    applied in a file (the exactly-once subject) and counts them in its
    own state (the checkpoint's subject)."""

    def __init__(self, idx, marker):
        self.idx = idx
        self.marker = marker
        self.applied = 0

    def __call__(self, x):
        self.applied += 1
        if self.marker:
            with open(self.marker, "a") as f:
                f.write(f"{x}\n")
                f.flush()
        return x + 10 ** self.idx

    def __getstate__(self):
        return {"applied": self.applied}

    def __setstate__(self, state):
        self.applied = state["applied"]


class MarkingFactory:
    """Stage 1 marks its inputs in ``marker``."""

    def __init__(self, marker):
        self.marker = marker

    def __call__(self, idx, n, mesh):
        return MarkingStage(idx, self.marker if idx == 1 else None)


class DelayFactory:
    """Stage ``slow`` sleeps ``delay_s`` a microbatch."""

    def __init__(self, slow, delay_s):
        self.slow, self.delay_s = slow, delay_s

    def __call__(self, idx, n, mesh):
        return DelayStep(self.delay_s if idx == self.slow else 0.0)


class DelayStep:
    def __init__(self, delay_s):
        self.delay_s = delay_s

    def __call__(self, x):
        if self.delay_s:
            time.sleep(self.delay_s)
        return x + 1


def _shm_leftovers(dag_id):
    return glob.glob(f"/dev/shm/{CHANNEL_PREFIX}{dag_id[:12]}*")


def _wait_no_leftovers(dag_id, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _shm_leftovers(dag_id):
            return []
        time.sleep(0.1)
    return _shm_leftovers(dag_id)


def _pid(handle):
    from ray_tpu_torch.core import api

    return api.runtime().actor_info(handle._actor_id)["pid"]


def _stage_pid(compiled, ep):
    return compiled._plan["endpoints"][ep]["pid"]


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    os.environ["RTPU_CHECKPOINT_DIR"] = str(
        tmp_path_factory.mktemp("dag-ckpt"))
    os.environ["RTPU_DAG_STALL_S"] = "0.5"
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()
        for k in ("RTPU_CHECKPOINT_DIR", "RTPU_DAG_STALL_S"):
            os.environ.pop(k, None)
    assert [p for p in multiprocessing.active_children()
            if p.name.startswith(("rtpt-task", "rtpt-actor"))] == []


# --------------------------------------------------------- DAG basics


def test_bind_execute_diamond(core):
    """A diamond's shared parent runs once an execute()."""
    base = tag.bind(1)
    left = double.bind(base)
    right = double.bind(base)
    out = rt.get(add.bind(left, right).execute())
    assert out[0] == out[2] and out[1] == out[3]


def test_input_node_and_multi_output(core):
    with InputNode() as inp:
        a = double.bind(inp)
        b = add.bind(inp, 10)
        dag = MultiOutputNode([a, b])
    assert rt.get(dag.execute(7)) == [14, 17]


def test_input_attribute_selection(core):
    with InputNode() as inp:
        dag = add.bind(inp["x"], inp["y"])
    assert rt.get(dag.execute(x=3, y=4)) == 7


def test_actor_dag_nodes(core):
    c = Accum.bind(100)
    dag = c.incr.bind(5)
    assert rt.get(dag.execute()) == 105
    # Plain execute() makes a fresh actor each time.
    assert rt.get(dag.execute()) == 105


def test_input_node_mixed_args_kwargs_raises(core):
    with InputNode() as inp:
        dag = double.bind(inp)
    with pytest.raises(Exception, match="positional and keyword"):
        rt.get(dag.execute(1, y=2))


# ------------------------------------------------------- compiled DAGs


def test_compiled_dag_persistent_actors(core):
    with InputNode() as inp:
        s = Stage.bind()
        dag = s.work.bind(inp)
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(0).get() == 1
        assert compiled.execute(0).get() == 2
        assert compiled.execute(0).get() == 3
    finally:
        compiled.teardown()


def test_compiled_dag_pipeline_overlaps(core):
    """Two 0.2 s stages, 4 items: the pipelined wall beats the serial
    4 x 0.4 s."""
    with InputNode() as inp:
        a = Slow.bind()
        b = Slow.bind()
        dag = b.work.bind(a.work.bind(inp))
    compiled = dag.experimental_compile()
    try:
        compiled.execute(-1).get()
        t0 = time.perf_counter()
        refs = [compiled.execute(i) for i in range(4)]
        vals = [r.get() for r in refs]
        wall = time.perf_counter() - t0
        assert vals == [0, 1, 2, 3]
        assert wall < 1.45, f"no pipeline overlap: {wall:.2f}s"
    finally:
        compiled.teardown()


def test_three_stage_channel_pipeline(core):
    a, b, c = Counter.bind(1), Counter.bind(10), Counter.bind(100)
    with InputNode() as inp:
        dag = c.step.bind(b.step.bind(a.step.bind(inp)))
    compiled = dag.experimental_compile(max_in_flight=8)
    try:
        assert compiled._mode == "channels"
        refs = [compiled.execute(i) for i in range(50)]
        assert [r.get(timeout=30) for r in refs] == [
            i + 111 for i in range(50)]
    finally:
        compiled.teardown()


def test_statefulness_across_executions(core):
    s = Counter.bind(0)
    with InputNode() as inp:
        dag = s.step_with_calls.bind(inp)
    compiled = dag.experimental_compile(max_in_flight=4)
    try:
        assert compiled._mode == "channels"
        out = [compiled.execute(i).get(timeout=30) for i in range(5)]
        assert out == [(i, i + 1) for i in range(5)]
    finally:
        compiled.teardown()


def test_diamond_shares_one_ring(core):
    """One producer, two consumers: one ring with two read cursors."""
    s, l, r, j = Fan.bind(), Fan.bind(), Fan.bind(), Fan.bind()
    with InputNode() as inp:
        mid = s.src.bind(inp)
        dag = j.join.bind(l.left.bind(mid), r.right.bind(mid))
    compiled = dag.experimental_compile(max_in_flight=4)
    try:
        assert compiled._mode == "channels"
        src_edge = next(e for e in compiled._plan["edges"].values()
                        if e["producer"] == "s0")
        assert src_edge["ring"]["n_readers"] == 2
        refs = [compiled.execute(i) for i in range(20)]
        assert [x.get(timeout=30) for x in refs] == [
            (2 * i + 1, 2 * i + 100) for i in range(20)]
    finally:
        compiled.teardown()


def test_input_attribute_fanout(core):
    """inp['x'] / inp['y'] send the input once; the selectors apply at
    the consumers."""
    l, r = Fan.bind(), Fan.bind()
    with InputNode() as inp:
        dag = MultiOutputNode([l.left.bind(inp["x"]),
                               r.right.bind(inp["y"])])
    compiled = dag.experimental_compile(max_in_flight=4)
    try:
        assert compiled._mode == "channels"
        assert compiled.execute({"x": 5, "y": 7}).get(timeout=30) == [6, 107]
        assert compiled.execute({"x": -1, "y": 0}).get(timeout=30) == [0, 100]
    finally:
        compiled.teardown()


def test_multi_output_terminal(core):
    a, b = Counter.bind(1), Counter.bind(2)
    with InputNode() as inp:
        dag = MultiOutputNode([a.step.bind(inp), b.step.bind(inp)])
    compiled = dag.experimental_compile(max_in_flight=4)
    try:
        assert compiled._mode == "channels"
        refs = [compiled.execute(i) for i in range(10)]
        assert [x.get(timeout=30) for x in refs] == [
            [i + 1, i + 2] for i in range(10)]
    finally:
        compiled.teardown()


def test_max_in_flight_one(core):
    a, b = Counter.bind(1), Counter.bind(10)
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.experimental_compile(max_in_flight=1)
    try:
        assert compiled._mode == "channels"
        for i in range(10):
            assert compiled.execute(i).get(timeout=30) == i + 11
    finally:
        compiled.teardown()


def test_error_propagates_pipeline_survives(core):
    """A stage's exception is a value of that seq: the poisoned ref raises
    the original error, later seqs keep flowing."""
    a, f, c = Counter.bind(0), Flaky.bind(), Counter.bind(100)
    with InputNode() as inp:
        dag = c.step.bind(f.step.bind(a.step.bind(inp)))
    compiled = dag.experimental_compile(max_in_flight=4)
    try:
        assert compiled._mode == "channels"
        refs = [compiled.execute(i) for i in range(8)]
        for i, r in enumerate(refs):
            if i == 3:
                with pytest.raises(ValueError, match="boom-on-3"):
                    r.get(timeout=30)
            else:
                assert r.get(timeout=30) == i + 110
    finally:
        compiled.teardown()


def test_teardown_releases_channels(core):
    before = channel_segment_stats()
    a, b = Counter.bind(1), Counter.bind(10)
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.experimental_compile(max_in_flight=4)
    assert compiled._mode == "channels"
    dag_id = compiled.dag_id
    [r.get(timeout=30) for r in [compiled.execute(i) for i in range(10)]]
    assert channel_segment_stats()["segments"] > before["segments"]
    compiled.teardown()
    assert channel_segment_stats() == before
    assert _wait_no_leftovers(dag_id) == []
    with pytest.raises(DAGTeardownError):
        compiled.execute(0)


def test_oversize_values_spill_and_reap(core):
    """Payloads larger than a slot go through per-seq sidecar segments,
    reaped as the window advances and all gone at teardown."""
    a, b = Echo.bind(), Echo.bind()
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    before = channel_segment_stats()
    compiled = dag.experimental_compile(max_in_flight=2)
    try:
        assert compiled._mode == "channels"
        big = bytes(2 * int(flags.get("RTPU_DAG_SLOT_BYTES")))
        for _ in range(6):
            assert len(compiled.execute(big).get(timeout=30)) == len(big)
    finally:
        dag_id = compiled.dag_id
        compiled.teardown()
    assert channel_segment_stats() == before
    assert _wait_no_leftovers(dag_id) == []


def test_flag_disabled_falls_back_to_submit(core, monkeypatch):
    monkeypatch.setenv("RTPU_DAG_CHANNELS", "0")
    a, b = Counter.bind(1), Counter.bind(10)
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.experimental_compile(max_in_flight=4)
    try:
        assert compiled._mode == "submit"
        refs = [compiled.execute(i) for i in range(10)]
        assert [r.get(timeout=30) for r in refs] == [
            i + 11 for i in range(10)]
    finally:
        compiled.teardown()


def test_ordinary_calls_wait_behind_the_resident_loop(core):
    """Installing the plan hands the actor's one call thread to its
    resident loop: an ordinary call made meanwhile runs after teardown,
    in order, on the same instance."""
    h = Counter.remote(1)
    with InputNode() as inp:
        dag = h.step.bind(inp)
    compiled = dag.experimental_compile(max_in_flight=2)
    try:
        assert compiled.execute(5).get(timeout=30) == 6
        ref = h.step_with_calls.remote(0)
        assert rt.wait([ref], timeout=0.5)[0] == []  # parked behind
        assert compiled.execute(6).get(timeout=30) == 7
    finally:
        compiled.teardown(kill_actors=False)
    assert rt.get(ref, timeout=30) == (0, 3)
    rt.kill(h)


def test_worker_death_tears_down_typed(core):
    """SIGKILL the middle stage's process (no restarts) mid-stream: every
    outstanding execute resolves with DAGTeardownError or its value (no
    hang), and no channel segment is left."""
    before = channel_segment_stats()
    a, b, c = Counter.bind(0), Slow.bind(0.05), Counter.bind(0)
    with InputNode() as inp:
        dag = c.step.bind(b.step.bind(a.step.bind(inp)))
    compiled = dag.experimental_compile(max_in_flight=8)
    assert compiled._mode == "channels"
    dag_id = compiled.dag_id
    refs = [compiled.execute(i) for i in range(8)]
    os.kill(_stage_pid(compiled, "s1"), signal.SIGKILL)
    outcomes = []
    for r in refs:
        try:
            outcomes.append(("ok", r.get(timeout=30)))
        except DAGTeardownError as e:
            outcomes.append(("torn", str(e)))
    assert any(kind == "torn" for kind, _ in outcomes), outcomes
    with pytest.raises(DAGTeardownError):
        compiled.execute(99)
    compiled.teardown()
    assert channel_segment_stats() == before
    assert _wait_no_leftovers(dag_id) == []


# -------------------------------------------------- against the JAX DAG


def _graphs(Cnt, FanCls, get, Input, Multi):
    """The three graphs on live actors, each warmed by one call (so a
    fresh JAX cluster's actors are alive before its compile resolves
    them); the multi-output graph reads the warm-up in its counts."""
    hs = {k: Cnt.remote(v) for k, v in (("a", 1), ("b", 10), ("c", 100),
                                         ("x", 1), ("y", 2))}
    fs = [FanCls.remote() for _ in range(4)]
    get([h.step.remote(0) for h in hs.values()]
        + [f.src.remote(0) for f in fs], timeout=120)
    with Input() as inp:
        three = hs["c"].step.bind(hs["b"].step.bind(hs["a"].step.bind(inp)))
    s, l, r, j = fs
    with Input() as inp:
        mid = s.src.bind(inp)
        diamond = j.join.bind(l.left.bind(mid), r.right.bind(mid))
    with Input() as inp:
        multi = Multi([hs["x"].step_with_calls.bind(inp),
                       hs["y"].step.bind(inp)])
    return ({"three": three, "diamond": diamond, "multi": multi},
            list(hs.values()) + fs)


def _run_graphs(graphs, n=12):
    out = {}
    for name, dag in graphs.items():
        compiled = dag.experimental_compile(max_in_flight=4)
        try:
            assert compiled._mode == "channels", name
            refs = [compiled.execute(i) for i in range(n)]
            out[name] = [r.get(timeout=60) for r in refs]
        finally:
            compiled.teardown(kill_actors=False)
    return out


def test_graphs_equal_the_jax_compiled_dag(core):
    """The three-stage, diamond and multi-output graphs give exactly the
    JAX package's compiled DAG's outputs (``ray_tpu.init(num_cpus=4)``
    on the CPU)."""
    import ray_tpu
    from ray_tpu.dag import InputNode as JInput
    from ray_tpu.dag import MultiOutputNode as JMulti

    graphs, handles = _graphs(Counter, Fan, rt.get, InputNode,
                              MultiOutputNode)
    port = _run_graphs(graphs)
    for h in handles:
        rt.kill(h)
    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    try:
        ref = _run_graphs(_graphs(ray_tpu.remote(PlainCounter),
                                  ray_tpu.remote(PlainFan), ray_tpu.get,
                                  JInput, JMulti)[0])
    finally:
        ray_tpu.shutdown()
    assert port == ref
    assert port["three"] == [i + 111 for i in range(12)]
    assert port["multi"][0] == [(0, 2), 2]


# ------------------------------------------------------------- meter


def test_attribute_bottleneck_names_max_compute_send():
    busy = {
        "s0": {"recv": 0.0, "compute": 0.05, "send": 0.01},
        "s1": {"recv": 0.01, "compute": 0.80, "send": 0.05},
        "s2": {"recv": 0.85, "compute": 0.04, "send": 0.01},
    }
    assert meter.attribute_bottleneck(busy) == "s1"


def test_attribute_bottleneck_excludes_recv():
    busy = {
        "s0": {"recv": 0.0, "compute": 0.30, "send": 0.02},
        "s1": {"recv": 0.95, "compute": 0.01, "send": 0.01},
    }
    assert meter.attribute_bottleneck(busy) == "s0"


def test_attribute_bottleneck_tie_breaks_earliest():
    busy = {
        "s2": {"compute": 0.40, "send": 0.00},
        "s0": {"compute": 0.40, "send": 0.00},
        "s1": {"compute": 0.10, "send": 0.00},
    }
    assert meter.attribute_bottleneck(busy) == "s0"


def test_attribute_bottleneck_empty_is_none():
    assert meter.attribute_bottleneck({}) is None


def test_attribute_bottleneck_equals_the_jax_rule():
    """The port's rule against the JAX package's on the same inputs."""
    import random

    from ray_tpu.dag import meter as jmeter

    rng = random.Random(0)
    for _ in range(200):
        busy = {f"s{i}": {p: rng.choice([0.0, 0.1, 0.25, rng.random()])
                          for p in ("recv", "compute", "send")}
                for i in rng.sample(range(6), rng.randint(0, 6))}
        assert meter.attribute_bottleneck(busy) == \
            jmeter.attribute_bottleneck(busy)


class _StubCounter:
    def __init__(self):
        self.calls = []

    def inc(self, value, tags=None):
        self.calls.append((value, dict(tags or {})))

    def total(self):
        return sum(v for v, _ in self.calls)


class _StubGauge:
    def __init__(self):
        self.calls = []

    def set(self, value, tags=None):
        self.calls.append((value, dict(tags or {})))


class _FakeRing:
    """Counters shaped like SlotRing.counters()."""

    def __init__(self):
        self.state = {"epoch": 0, "write_seq": 0, "occupancy": 0,
                      "depth": 8, "items": 0, "bytes": 0, "blocked_ns": 0,
                      "readers": []}

    def counters(self):
        c = dict(self.state)
        c["readers"] = [dict(r) for r in self.state["readers"]]
        return c


class _FakeSource:
    dag_id = "feedfacefeedface"

    def __init__(self, ring):
        self.rings = {"e0": ring}
        self.stage_ns = {}


def _stub(module, monkeypatch):
    stubs = {"items": _StubCounter(), "bytes": _StubCounter(),
             "occ": _StubGauge(), "lag": _StubGauge(),
             "blocked": _StubGauge(), "busy": _StubGauge(),
             "steps": _StubCounter()}
    for attr, key in (("_EDGE_ITEMS", "items"), ("_EDGE_BYTES", "bytes"),
                      ("_EDGE_OCC", "occ"), ("_EDGE_LAG", "lag"),
                      ("_EDGE_BLOCKED", "blocked"),
                      ("_STAGE_BUSY", "busy"), ("_STAGE_STEPS", "steps")):
        monkeypatch.setattr(module, attr, stubs[key])
    monkeypatch.setattr(module, "_edge_base", {})
    monkeypatch.setattr(module, "_stage_base", {})
    return stubs


@pytest.fixture
def stub_meter(monkeypatch):
    return _stub(meter, monkeypatch)


def test_sampler_epoch_rebaseline_no_negative_no_double_count(stub_meter):
    """A recovery bumps the ring's epoch and zeroes its counters: the
    sampler emits no negative delta across it and counts pre-kill items
    once, post-recovery items once, replays never."""
    ring = _FakeRing()
    src = _FakeSource(ring)
    ring.state.update(items=100, bytes=5000)
    meter._sample_source(src, now=1.0)
    ring.state.update(items=150, bytes=7500)
    meter._sample_source(src, now=2.0)
    assert stub_meter["items"].total() == 150
    ring.state.update(epoch=1, items=7, bytes=350)
    meter._sample_source(src, now=3.0)
    assert all(v >= 0 for v, _ in stub_meter["items"].calls)
    assert stub_meter["items"].total() == 157
    assert stub_meter["bytes"].total() == 7850


def test_sampler_stage_busy_fractions_bounded(stub_meter):
    src = _FakeSource(_FakeRing())
    src.stage_ns = {1: {"recv": 0, "compute": 0, "send": 0,
                        "blocked": 0, "steps": 0}}
    meter._sample_source(src, now=10.0)
    src.stage_ns = {1: {"recv": 2_000_000_000, "compute": 400_000_000,
                        "send": 50_000_000, "blocked": 0, "steps": 12}}
    meter._sample_source(src, now=10.5)
    assert stub_meter["steps"].total() == 12
    fracs = {c[1]["phase"]: c[0] for c in stub_meter["busy"].calls}
    assert set(fracs) == {"recv", "compute", "send"}
    assert all(0.0 <= v <= 1.0 for v in fracs.values())
    assert fracs["compute"] == pytest.approx(0.8, rel=0.01)
    assert fracs["recv"] == 1.0


def test_sampler_busy_fractions_equal_the_jax_sampler(monkeypatch):
    """The port's sampler and the JAX package's on the same counter
    sequence emit the same busy fractions, steps and edge deltas."""
    from ray_tpu.dag import meter as jmeter

    port, ref = _stub(meter, monkeypatch), _stub(jmeter, monkeypatch)
    seq = [(1.0, 10, 0, 0, 0, 0), (1.7, 40, 300_000_000, 100_000_000,
                                   20_000_000, 9),
           (2.9, 90, 900_000_000, 700_000_000, 30_000_000, 20)]
    ring_p, ring_j = _FakeRing(), _FakeRing()
    src_p, src_j = _FakeSource(ring_p), _FakeSource(ring_j)
    for now, items, recv, comp, send, steps in seq:
        for ring, src in ((ring_p, src_p), (ring_j, src_j)):
            ring.state.update(items=items, bytes=items * 8)
            src.stage_ns = {0: {"recv": recv, "compute": comp,
                                "send": send, "blocked": 0,
                                "steps": steps}}
        meter._sample_source(src_p, now)
        jmeter._sample_source(src_j, now)
    for key in ("items", "bytes", "steps"):
        assert port[key].calls == ref[key].calls, key
    assert port["busy"].calls == ref["busy"].calls


def test_slow_stage_named_by_the_meter(core):
    """A 3-stage pipeline with a slow middle stage: the meter's row and
    the run's window both name s1."""
    from ray_tpu_torch.parallel import MPMDPipeline
    from ray_tpu_torch.util import state

    p = MPMDPipeline([DelayFactory(1, 0.02)] * 3, max_in_flight=4,
                     recovery=False)
    try:
        assert p.mode == "channels"
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.5:
            p.run(list(range(16)))
        stats = p.gap_stats()
        assert stats["bottleneck"] == "s1", stats
        assert stats["stage_busy"]["s1"]["compute"] > \
            stats["stage_busy"]["s0"]["compute"]
        assert stats["stage_ms"]["s1"]["compute"] >= 15.0
        row = next(d for d in state.list_compiled_dags()
                   if d["dag_id"] == p._compiled.dag_id)
        assert row["edge_stats"] and all(
            e["items"] > 0 for e in row["edge_stats"].values())
    finally:
        p.teardown()


# ----------------------------------------------------------- recovery


def _event_kinds(kinds):
    from ray_tpu_torch.core import events, sink

    events.flush_events()
    return [e["kind"] for e in sink.local_sink().events.query(kinds=kinds)]


def test_stage_sigkill_heals_exactly_once(core, tmp_path):
    """SIGKILL the middle stage's process mid-stream: the DAG recovers in
    place, every result arrives once, stage 1's side effects land once,
    DAG_RECOVERED is emitted and the row counts the recovery."""
    from ray_tpu_torch.parallel import MPMDPipeline
    from ray_tpu_torch.util import state

    marker = str(tmp_path / "markers.txt")
    p = MPMDPipeline([MarkingFactory(marker)] * 3, max_in_flight=4,
                     stage_options=[{"checkpoint_every_n": 1}] * 3)
    try:
        assert p.mode == "channels"
        victim = _stage_pid(p._compiled, "s1")
        n = 24
        refs = []
        for i in range(n):
            refs.append(p.submit(i))
            time.sleep(0.03)
            if i == 7:
                os.kill(victim, signal.SIGKILL)
        outs = [r.get(timeout=120) for r in refs]
        assert outs == [i + 111 for i in range(n)]
        lines = open(marker).read().split()
        assert sorted(lines, key=int) == [str(i + 1) for i in range(n)], \
            f"stage-1 side effects must land exactly once, got {lines}"
        assert p.recoveries >= 1
        assert _stage_pid(p._compiled, "s1") != victim
        kinds = _event_kinds(["DAG_PARTICIPANT_DIED", "DAG_RECOVERING",
                              "DAG_RECOVERED"])
        assert "DAG_PARTICIPANT_DIED" in kinds
        assert "DAG_RECOVERED" in kinds
        row = next(d for d in state.list_compiled_dags()
                   if d["dag_id"] == p._compiled.dag_id)
        assert row["recoveries"] >= 1
        assert row["last_cause"] == "worker_killed"
        assert row["last_recovery_s"] > 0
        # The restored stage kept its state (its __getstate__) and gives
        # the same outputs.
        assert p.run([100, 101]) == [211, 212]
    finally:
        dag_id = p._compiled.dag_id
        p.teardown()
    assert _wait_no_leftovers(dag_id) == []


def test_recovery_disabled_keeps_failfast_teardown(core, monkeypatch):
    """RTPU_DAG_RECOVERY=0: a dead participant tears the whole DAG down
    with DAGTeardownError, even with restarts and checkpoints left."""
    monkeypatch.setenv("RTPU_DAG_RECOVERY", "0")
    stages = [Slow.options(max_restarts=4, max_task_retries=1,
                           checkpoint_every_n=1).bind(0.05)
              for _ in range(3)]
    with InputNode() as inp:
        dag = stages[2].step.bind(
            stages[1].step.bind(stages[0].step.bind(inp)))
    compiled = dag.experimental_compile(max_in_flight=8)
    assert compiled._mode == "channels"
    dag_id = compiled.dag_id
    refs = [compiled.execute(i) for i in range(8)]
    os.kill(_stage_pid(compiled, "s1"), signal.SIGKILL)
    outcomes = []
    for r in refs:
        try:
            outcomes.append(("ok", r.get(timeout=30)))
        except DAGTeardownError as e:
            outcomes.append(("torn", str(e)))
    assert any(kind == "torn" for kind, _ in outcomes), outcomes
    with pytest.raises(DAGTeardownError):
        compiled.execute(99)
    compiled.teardown()
    assert _wait_no_leftovers(dag_id) == []


def test_teardown_reaps_sidecars_after_peer_kill(core, monkeypatch):
    """Teardown after the middle stage was SIGKILLed with oversize
    payloads in flight (fail-fast, for determinism): every per-seq
    sidecar, also the dead process's, is reaped: the segment accounting
    is back where it was and /dev/shm holds nothing under the DAG's
    prefix."""
    monkeypatch.setenv("RTPU_DAG_RECOVERY", "0")
    before = channel_segment_stats()
    a, b, c = SlowEcho.remote(), SlowEcho.remote(), SlowEcho.remote()
    rt.get([h.step.remote(0) for h in (a, b, c)], timeout=60)
    with InputNode() as inp:
        dag = c.step.bind(b.step.bind(a.step.bind(inp)))
    compiled = dag.experimental_compile(max_in_flight=4)
    assert compiled._mode == "channels"
    dag_id = compiled.dag_id
    big = bytes(2 * int(flags.get("RTPU_DAG_SLOT_BYTES")))
    refs = [compiled.execute(big) for _ in range(6)]
    os.kill(_pid(b), signal.SIGKILL)
    for r in refs:
        try:
            r.get(timeout=30)
        except DAGTeardownError:
            pass
    compiled.teardown()
    assert channel_segment_stats() == before
    assert _wait_no_leftovers(dag_id) == []
    for h in (a, c):
        rt.kill(h)
