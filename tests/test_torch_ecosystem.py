"""The port's ecosystem shims (``ray_tpu_torch.util``: ``ActorPool``,
``Queue``, ``multiprocessing.Pool``, the joblib backend) held to the JAX
package's (``ray_tpu.util``): every case of tests/test_ecosystem.py, the
same work through both packages with the results held equal; a queue's
blocked ``get`` beside a ``put`` from a task (the backing actor is
async), the queue's bounds and batch forms, a Pool's initializer and
``kwds``, and the refusal of a lambda before any task is submitted.

Divergence by design: the JAX tests' nested functions and lambdas given
to ``Pool`` and joblib are module-level here (the port sends functions
by reference); ``ActorPool``'s ``fn(actor, value)`` runs in the caller
and stays a lambda. Task workers and actors of both packages import this
module again, so its top loads neither torch nor jax.
"""
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import ActorPool, Empty, Full, Queue

_INIT_CALLS = []


class Doubler:
    def double(self, x):
        return x * 2


class Producer:
    """Puts ``n`` items into a queue it was given, counting the puts that
    found it full."""

    def fill(self, q, n):
        blocked = 0
        for i in range(n):
            try:
                q.put_nowait(i)
            except Exception:  # noqa: BLE001 — Full of either package
                blocked += 1
                q.put(i)
        return blocked


def producer(q, n):
    for i in range(n):
        q.put(i)
    return "done"


def put_later(q, item, delay_s):
    time.sleep(delay_s)
    q.put(item)
    return True


def sq(x):
    return x * x


def plus(a, b):
    return a + b


def scaled(x, k=1):
    return x * k


def cube(x):
    return x ** 3


def note_init(tag):
    _INIT_CALLS.append(tag)


def init_calls(_):
    return list(_INIT_CALLS)


def remote_of(pkg):
    if pkg == "jax":
        import ray_tpu

        return ray_tpu.remote
    return rt.remote


def util_of(pkg):
    if pkg == "jax":
        import ray_tpu.util as jutil

        return jutil
    import ray_tpu_torch.util as tutil

    return tutil


def get_of(pkg):
    if pkg == "jax":
        import ray_tpu

        return ray_tpu.get
    return rt.get


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


PKGS = ("jax", "port")


# ------------------------------------------------------------- ActorPool


def _pool_runs(pkg):
    util, remote = util_of(pkg), remote_of(pkg)
    D = remote(Doubler)
    pool = util.ActorPool([D.remote() for _ in range(2)])
    ordered = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    unordered = list(pool.map_unordered(lambda a, v: a.double.remote(v),
                                        range(8)))
    one = util.ActorPool([D.remote()])
    one.submit(lambda a, v: a.double.remote(v), 10)
    one.submit(lambda a, v: a.double.remote(v), 20)
    has = one.has_next()
    nexts = [one.get_next(), one.get_next()]
    return ordered, sorted(unordered), has, nexts, one.has_next()


def test_actor_pool_map_ordered(core, jax_core):
    got = {pkg: _pool_runs(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    ordered, unordered, has, nexts, has_after = got["port"]
    assert ordered == [0, 2, 4, 6, 8, 10, 12, 14]
    assert unordered == ordered
    assert has and nexts == [20, 40] and not has_after


def test_actor_pool_map_unordered(core):
    pool = ActorPool([rt.remote(Doubler).remote() for _ in range(2)])
    out = list(pool.map_unordered(lambda a, v: a.double.remote(v), range(8)))
    assert sorted(out) == [0, 2, 4, 6, 8, 10, 12, 14]


def test_actor_pool_submit_get_next(core):
    pool = ActorPool([rt.remote(Doubler).remote()])
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)
    assert pool.has_next()
    assert pool.get_next() == 20
    assert pool.get_next() == 40
    assert not pool.has_next()
    assert pool.pop_idle() is not None and pool.pop_idle() is None


# ----------------------------------------------------------------- Queue


def _queue_runs(pkg):
    util, remote, get = util_of(pkg), remote_of(pkg), get_of(pkg)
    q = util.Queue(maxsize=4)
    q.put("a")
    q.put("b")
    out = [q.qsize(), q.get(), q.get()]
    try:
        q.get_nowait()
        out.append("not empty")
    except util.Empty:
        out.append("empty")
    q2 = util.Queue()
    ref = remote(producer).remote(q2, 5)
    out.append([q2.get(timeout=20) for _ in range(5)])
    out.append(get(ref))
    q.shutdown()
    q2.shutdown()
    return out


def test_queue_roundtrip_and_cross_task(core, jax_core):
    """tests/test_ecosystem.py's queue cases through both packages: a
    queue passed into a task, every copy on one actor."""
    got = {pkg: _queue_runs(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"] == [2, "a", "b", "empty",
                                         list(range(5)), "done"]


def test_queue_blocked_get_beside_a_put_from_a_task(core):
    """The driver's get blocks on the empty queue while a task puts: the
    actor's loop serves the put, and the get returns it."""
    q = Queue()
    ref = rt.remote(put_later).remote(q, "late", 0.5)
    t0 = time.perf_counter()
    assert q.get(timeout=30) == "late"
    assert time.perf_counter() - t0 >= 0.4
    assert rt.get(ref) is True
    with pytest.raises(Empty):
        q.get(timeout=0.2)
    q.shutdown()


def test_queue_bounds_and_batches(core):
    q = Queue(maxsize=2)
    q.put_nowait_batch([1, 2])
    assert q.full() and q.qsize() == 2
    with pytest.raises(Full):
        q.put_nowait(3)
    with pytest.raises(Full):
        q.put(3, timeout=0.2)
    with pytest.raises(Full):
        q.put_nowait_batch([3])
    with pytest.raises(Empty):
        q.get_nowait_batch(3)
    assert q.get_nowait_batch(2) == [1, 2]
    assert q.empty()
    assert rt.get(q.actor.maxsize.remote()) == 2
    q.shutdown()


def test_queue_fills_from_an_actor(core):
    """An actor given the queue puts past its bound; the driver drains
    it; the actor saw it full."""
    q = Queue(maxsize=2)
    p = rt.remote(Producer).remote()
    ref = p.fill.remote(q, 6)
    deadline = time.monotonic() + 30
    while not q.full():  # the producer is past its bound
        assert time.monotonic() < deadline
        time.sleep(0.02)
    assert [q.get(timeout=30) for _ in range(6)] == list(range(6))
    assert rt.get(ref, timeout=30) >= 1
    rt.kill(p)
    q.shutdown()


# ---------------------------------------------------------- multiprocessing


def _mp_runs(pkg):
    if pkg == "jax":
        from ray_tpu.util.multiprocessing import Pool
    else:
        from ray_tpu_torch.util.multiprocessing import Pool
    with Pool(processes=2) as p:
        return [p.map(sq, range(6)), sorted(p.imap_unordered(sq, [2, 3])),
                p.apply(sq, (7,)), p.starmap(plus, [(1, 2), (3, 4)]),
                list(p.imap(sq, [4, 5])), p.apply(scaled, (3,), {"k": 5}),
                p.map_async(sq, [8]).get(timeout=30)]


def test_multiprocessing_pool(core, jax_core):
    got = {pkg: _mp_runs(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"] == [[0, 1, 4, 9, 16, 25], [4, 9], 49,
                                         [3, 7], [16, 25], 15, [64]]


def test_pool_initializer_runs_once_a_worker(core):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=1, initializer=note_init, initargs=("x",)) as p:
        seen = p.map(init_calls, range(4))
    # Every task saw the initializer's mark, and no worker ran it twice.
    assert all(s and set(s) == {"x"} and len(s) == 1 for s in seen), seen


def test_pool_refuses_a_lambda_before_any_submit(core):
    from ray_tpu_torch.core import api
    from ray_tpu_torch.util.multiprocessing import Pool

    def nested(x):
        return x

    before = len(api.runtime().tasks) + len(api.runtime().task_procs)
    with Pool(processes=2) as p:
        with pytest.raises(TypeError, match="lambda"):
            p.map(lambda x: x, range(3))
        with pytest.raises(TypeError, match="nested"):
            p.apply(nested, (1,))
    with pytest.raises(TypeError, match="nested"):
        Pool(initializer=nested)
    assert len(api.runtime().tasks) + len(api.runtime().task_procs) <= (
        before)


# ----------------------------------------------------------------- joblib


def _joblib_runs(pkg):
    import joblib

    if pkg == "jax":
        from ray_tpu.util.joblib import register_ray
    else:
        from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray_tpu"):
        return joblib.Parallel(n_jobs=2)(joblib.delayed(cube)(i)
                                         for i in range(5))


def test_joblib_backend(core, jax_core):
    pytest.importorskip("joblib")
    jax_out = _joblib_runs("jax")
    port_out = _joblib_runs("port")
    assert port_out == jax_out == [0, 1, 8, 27, 64]


def test_joblib_backend_pickles_without_its_parallel(core):
    pytest.importorskip("joblib")
    import pickle

    from ray_tpu_torch.util import joblib as tjoblib

    b = tjoblib.RayTpuBackend()
    b.configure(n_jobs=2, parallel=object())
    back = pickle.loads(pickle.dumps(b))
    assert type(back) is tjoblib.RayTpuBackend
    assert not hasattr(back, "parallel")
