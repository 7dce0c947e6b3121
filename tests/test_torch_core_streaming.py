"""Streaming generators and async actors in the port's core
(``ray_tpu_torch.core``), case for case with the JAX package's
tests/test_streaming.py: each of its 9 cases runs through both packages,
and the port's outcome (the items, the errors' classes, causes and
messages) is held equal to the JAX package's, as are the TypeErrors of
``ray_tpu/core/worker.py:1365-1421``; the port's own timings stand as the
JAX tests hold them. Then what the port adds:
``@method(num_returns="streaming")``, a sync generator on an async actor,
an item that travels as a file, a stream handed to a task, a stream's
window against its reader, and the objects a closed stream lets go.

Divergence by design: the JAX tests' nested ``@remote`` functions and
classes are module-level plain functions and classes here, wrapped by
each package's ``remote`` where used (the port sends them by name). Task
workers and actor processes of both packages import this module again,
so its top loads neither torch nor jax.
"""
import asyncio
import os
import re
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import serialization

PKGS = ("jax", "port")


def api_of(pkg):
    """The JAX package ("jax") or the port."""
    if pkg == "jax":
        import ray_tpu

        return ray_tpu
    return rt


def produce_slowly():
    for i in range(5):
        yield i
        time.sleep(0.3)


def produce_stamps():
    for _ in range(20):
        yield time.time()


def boom_mid_stream():
    yield 1
    raise ValueError("mid-stream failure")


def not_a_gen():
    return 42


class Producer:
    def stream(self, n):
        for i in range(n):
            yield i * 10


class MethodProducer(Producer):
    @rt.method(num_returns="streaming")
    def squares(self, n):
        for i in range(n):
            yield i * i


class AsyncWorker:
    async def slow(self, i):
        await asyncio.sleep(0.4)
        return i


class Accum:
    def __init__(self):
        self.total = 0

    async def add(self, x):
        self.total += x
        await asyncio.sleep(0.01)
        return self.total

    def read(self):
        return self.total


class Tracker:
    def __init__(self):
        self.stopped = False

    def mark(self):
        self.stopped = True

    def check(self):
        return self.stopped


def produce_until_closed(tracker):
    try:
        for i in range(1000):
            yield i
    finally:
        tracker.mark.remote()


class AsyncProducer:
    async def stream(self, n):
        for i in range(n):
            await asyncio.sleep(0.05)
            yield i * 2

    def sync_stream(self, n):
        """A sync generator of an async actor: it runs off the loop."""
        for i in range(n):
            try:
                asyncio.get_running_loop()
                on_loop = True
            except RuntimeError:
                on_loop = False
            yield i, on_loop

    async def plain(self):
        return 1

    async def agen(self):
        yield 1


async def async_gen_task():
    yield 1


def big_items(n):
    for i in range(n):
        yield np.full(serialization.SPILL_BYTES // 8 + 1, float(i))


def consume(gen):
    """A task that reads a stream handed to it."""
    return [rt.get(r) for r in gen]


class Counted:
    """A stream whose producer counts the items whose report the driver
    answered (two threads: ``read`` runs beside the stream)."""

    def __init__(self):
        self.acked = 0

    def stream(self, n):
        for i in range(n):
            yield i
            self.acked += 1

    def read(self):
        return self.acked


def _warm():
    return None


@pytest.fixture(scope="module")
def core():
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def jax_core():
    import ray_tpu

    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    try:
        yield
    finally:
        ray_tpu.shutdown()


@pytest.fixture
def both(core, jax_core):
    return PKGS


def _runtime():
    from ray_tpu_torch.core import api

    return api.runtime()


def shape(e):
    """An error as the two packages' can be compared: its classes' names,
    its message's first line with object ids masked, and its cause's
    shape (a TaskError's message names the task and holds a traceback:
    its cause stands for it)."""
    if e is None:
        return None
    cause = getattr(e, "cause", None)
    msg = None if cause is not None else re.sub(
        r"[0-9a-f]{8,}", "<id>", str(e).splitlines()[0] if str(e) else "")
    return {"classes": [c.__name__ for c in type(e).__mro__],
            "message": msg,
            "cause": None if cause is None else shape(cause)}


def drain(api, gen):
    """A stream's items, read to its end, and the shape of the error that
    ended it (from ``next`` or from ``get``), None where none did."""
    items = []
    try:
        for r in gen:
            items.append(api.get(r, timeout=30))
    except Exception as e:  # noqa: BLE001 — the outcome compared
        return items, shape(e)
    return items, None


def through_both(scenario):
    """``scenario(pkg)`` for each package: (outcome, what the port's own
    checks read). The outcomes are held equal; the port's returned."""
    out = {pkg: scenario(pkg) for pkg in PKGS}
    assert out["port"][0] == out["jax"][0], {k: v[0] for k, v in out.items()}
    return out["port"]


# -------------------------------------- tests/test_streaming.py, case for case


def _incrementally(pkg):
    api = api_of(pkg)
    api.get(api.remote(_warm).remote())  # a task worker is up
    gen = api.remote(num_returns="streaming")(produce_slowly).remote()
    t0 = time.perf_counter()
    first = api.get(next(gen))
    t_first = time.perf_counter() - t0
    return {"first": first, "rest": drain(api, gen)}, t_first


def test_generator_streams_incrementally(both):
    """Item 0 arrives while the producer still yields."""
    out, t_first = through_both(_incrementally)
    assert out == {"first": 0, "rest": ([1, 2, 3, 4], None)}
    assert t_first < 1.2, f"first item took {t_first:.2f}s — not streaming"


def _backpressure(pkg):
    api = api_of(pkg)
    gen = api.remote(num_returns="streaming",
                     _generator_backpressure_num_objects=2)(
        produce_stamps).remote()
    refs = [next(gen) for _ in range(3)]
    time.sleep(1.0)  # the producer would run ahead here if unthrottled
    stamps = [api.get(r) for r in refs] + [api.get(r) for r in gen]
    return {"items": len(stamps)}, stamps


def test_generator_backpressure_window(both):
    """The producer runs at most `window` items ahead of the consumer."""
    out, stamps = through_both(_backpressure)
    assert out == {"items": 20}
    assert stamps[-1] - stamps[0] > 0.8, (
        "producer ran unthrottled past the window")


def _error_mid_stream(pkg):
    api = api_of(pkg)
    gen = api.remote(num_returns="streaming")(boom_mid_stream).remote()
    return drain(api, gen), None


def test_generator_error_propagates(both):
    (items, err), _ = through_both(_error_mid_stream)
    assert items == [1]
    assert err["cause"]["message"] == "mid-stream failure"


def _not_a_generator(pkg):
    api = api_of(pkg)
    return drain(api, api.remote(num_returns="streaming")(
        not_a_gen).remote()), None


def test_non_generator_with_streaming_errors(both):
    (items, err), _ = through_both(_not_a_generator)
    assert items == []
    assert "requires a generator function" in err["cause"]["message"]


def _actor_stream(pkg):
    api = api_of(pkg)
    p = api.remote(Producer).remote()
    out = drain(api, p.stream.options(num_returns="streaming").remote(4))
    api.kill(p)
    return out, None


def test_actor_streaming_method(both):
    assert through_both(_actor_stream)[0] == ([0, 10, 20, 30], None)


def _interleave(pkg):
    api = api_of(pkg)
    a = api.remote(AsyncWorker).remote()
    api.get(a.slow.remote(-1))  # warm
    t0 = time.perf_counter()
    out = api.get([a.slow.remote(i) for i in range(10)])
    dt = time.perf_counter() - t0
    api.kill(a)
    return out, dt


def test_async_actor_calls_interleave(both):
    """10 concurrent 0.4 s awaits overlap (wall well under 4 s)."""
    out, dt = through_both(_interleave)
    assert out == list(range(10))
    assert dt < 2 * 0.4 + 0.8, f"10 async calls took {dt:.2f}s — serialized"


def _shared_state(pkg):
    api = api_of(pkg)
    a = api.remote(Accum).remote()
    api.get([a.add.remote(1) for _ in range(20)])
    out = api.get(a.read.remote())
    api.kill(a)
    return out, None


def test_async_actor_state_is_shared(both):
    assert through_both(_shared_state)[0] == 20


def _abandoned(pkg):
    api = api_of(pkg)
    tracker = api.remote(Tracker).remote()
    gen = api.remote(num_returns="streaming",
                     _generator_backpressure_num_objects=2)(
        produce_until_closed).remote(tracker)
    first = api.get(next(gen))
    gen.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if api.get(tracker.check.remote()):
            break
        time.sleep(0.1)
    out = {"first": first, "finally_ran": api.get(tracker.check.remote())}
    api.kill(tracker)
    return out, None


def test_abandoned_generator_releases_producer(both):
    """Closing the consumer mid-stream unsticks a producer held at the
    window, and its generator's finally runs."""
    assert through_both(_abandoned)[0] == {"first": 0, "finally_ran": True}


def _async_gen(pkg):
    api = api_of(pkg)
    p = api.remote(AsyncProducer).remote()
    out = drain(api, p.stream.options(num_returns="streaming").remote(5))
    api.kill(p)
    return out, None


def test_async_generator_streaming(both):
    assert through_both(_async_gen)[0] == ([0, 2, 4, 6, 8], None)


# ---------------------------------- what streaming refuses, in both packages


def _refusals(pkg):
    api = api_of(pkg)
    p = api.remote(AsyncProducer).remote()
    out = {"plain_coroutine": drain(
               api, p.plain.options(num_returns="streaming").remote()),
           "async_gen_without_streaming": drain(
               api, iter([p.agen.remote()])),
           "async_gen_task": drain(api, api.remote(num_returns="streaming")(
               async_gen_task).remote())}
    api.kill(p)
    return out, None


def test_what_streaming_refuses_raises_the_jax_packages_type_errors(both):
    out, _ = through_both(_refusals)
    assert {k: v[1]["cause"]["classes"][0] for k, v in out.items()} == {
        k: "TypeError" for k in out}


# ------------------------------------------------------- what the port adds


def test_method_decorator_streams_by_default(core):
    p = rt.remote(MethodProducer).remote()
    gen = p.squares.remote(4)
    assert isinstance(gen, rt.ObjectRefGenerator)
    assert [rt.get(r) for r in gen] == [0, 1, 4, 9]
    rt.kill(p)


def test_sync_generator_of_an_async_actor_streams_off_the_loop(core):
    """The JAX mailbox runs it on a mailbox thread; so does the port."""
    p = rt.remote(AsyncProducer).remote()
    gen = p.sync_stream.options(num_returns="streaming").remote(3)
    assert [rt.get(r) for r in gen] == [(0, False), (1, False), (2, False)]
    rt.kill(p)


def test_large_items_travel_as_files(core):
    out = [rt.get(r)
           for r in rt.remote(num_returns="streaming")(big_items).remote(3)]
    assert [float(a[0]) for a in out] == [0.0, 1.0, 2.0]
    assert all(a.nbytes > serialization.SPILL_BYTES for a in out)
    assert os.listdir(_runtime().spill_dir) == []


def test_stream_handed_to_a_task(core):
    """Pickling hands the stream to the receiver, from where it stood."""
    gen = rt.remote(Producer).remote().stream.options(
        num_returns="streaming").remote(5)
    assert rt.get(next(gen)) == 0
    assert rt.get(rt.remote(consume).remote(gen), timeout=60) == [
        10, 20, 30, 40]


def test_producer_never_runs_past_the_window(core):
    """After each read, the reports the driver answered are at most the
    window ahead of the items read."""
    c = rt.remote(max_concurrency=2)(Counted).remote()
    gen = c.stream.options(num_returns="streaming",
                           _generator_backpressure_num_objects=3).remote(12)
    ahead = []
    for read in range(1, 13):
        next(gen)
        time.sleep(0.05)
        ahead.append(rt.get(c.read.remote()) - read)
    assert max(ahead) <= 3, ahead
    assert max(ahead) >= 1, ahead  # it did run ahead
    rt.kill(c)


def test_closed_stream_lets_its_objects_go(core):
    rt_ = _runtime()
    before = len(rt_.objects)
    gen = rt.remote(Producer).remote().stream.options(
        num_returns="streaming").remote(8)
    ref = next(gen)
    assert rt.get(ref) == 0
    deadline = time.monotonic() + 10
    while len(rt_.objects) < before + 8 and time.monotonic() < deadline:
        time.sleep(0.02)  # every item reported (window 16)
    gen.close()
    del gen
    deadline = time.monotonic() + 10
    while len(rt_.objects) > before + 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(rt_.objects) == before + 1  # the ref still held
    assert rt_.gens == {}
    del ref
    assert len(rt_.objects) == before
