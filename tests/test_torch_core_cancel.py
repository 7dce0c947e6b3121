"""Cancel, deadlines and the rest of the core's API in the port
(``ray_tpu_torch.core``): the 5 cases of the JAX package's
tests/test_cancel_tree.py, case for case, each run through both packages
and the port's outcome (the values, the errors' classes, their causes
and messages, whether a child stopped) held equal to the JAX package's;
the dependency errors and a node's keys, likewise; then what the port
adds: a running actor call and a coroutine cancelled in place,
``force=True`` on a task and on an actor call, a cancel from inside a
task, ``deadline_s`` on tasks and actor calls, ``free``/``error_of`` (the
uses of tests/test_object_census.py:52-124 and tests/test_spilling.py:50),
``available_resources`` and ``get_runtime_context``, a cancel that
lands while the call sends a large message up its pipe, and what a
process's registry of its calls keeps.

Divergence by design: the JAX tests' nested ``@remote`` functions and
classes are module-level plain functions and classes here, wrapped by
each package's ``remote`` where used (the port sends them by name). Task
workers and actor processes of both packages import this module again,
so its top loads neither torch nor jax.
"""
import asyncio
import os
import pathlib
import random
import re
import tempfile
import time
import uuid

import pytest

import ray_tpu_torch as rt

PKGS = ("jax", "port")


def api_of(pkg):
    """The JAX package ("jax") or the port."""
    if pkg == "jax":
        import ray_tpu

        return ray_tpu
    return rt


def _sentinel(tag):
    return os.path.join(tempfile.gettempdir(), f"{tag}_{uuid.uuid4().hex}")


def _spin_hb(path, sec=30.0):
    """Spin for ``sec``, touching a heartbeat file each tick; writes a
    .done marker only on natural completion."""
    hb = pathlib.Path(path + ".hb")
    pathlib.Path(path + ".started").touch()
    t0 = time.time()
    while time.time() - t0 < sec:
        hb.touch()
        time.sleep(0.05)
    pathlib.Path(path + ".done").touch()
    return 1


def add(a, b):
    return a + b


def boom():
    raise ValueError("kaboom")


def _noop(i):
    return i


def parent(paths, pkg):
    api = api_of(pkg)
    refs = [api.remote(_spin_hb).remote(p) for p in paths]
    return api.get(refs)


def spawn(path, pkg):
    return api_of(pkg).remote(_spin_hb).remote(path)  # the child runs on


def cancels_its_child(path):
    """A task that cancels what it submitted (the child's up-op)."""
    ref = rt.remote(_spin_hb).remote(path)
    deadline = time.time() + 20
    while not os.path.exists(path + ".started") and time.time() < deadline:
        time.sleep(0.05)
    rt.cancel(ref)
    try:
        rt.get(ref, timeout=20)
    except rt.TaskCancelledError:
        return "cancelled"
    return "ran"


def touch(path):
    pathlib.Path(path).touch()
    return "ran"


def where_am_i():
    c = rt.get_runtime_context()
    return (c.get_node_id(), c.task_id, c.actor_id, c.get_accelerator_ids(),
            rt.available_resources()["CPU"], len(rt.nodes()))


# A message well above the 16 KiB past which ``Connection.send_bytes``
# writes a frame in two writes, and below the size that travels as a
# file (``serialization.SPILL_BYTES``).
BIG = 200 * 1024


def put_forever(path):
    """Puts BIG bytes again and again until cancelled."""
    blob = bytes(BIG)
    pathlib.Path(path).touch()
    while True:
        rt.put(blob)


class Blocker:
    def block(self, sec):
        time.sleep(sec)
        return "done"

    def quick(self):
        return "q"

    def mark(self, path):
        pathlib.Path(path).touch()
        return "ran"

    def spin(self, path):
        """Loops in short sleeps until cancelled; says how it ended."""
        pathlib.Path(path + ".started").touch()
        try:
            while True:
                time.sleep(0.02)
        except rt.TaskCancelledError:
            pathlib.Path(path + ".cancelled").touch()
            raise

    def context(self):
        c = rt.get_runtime_context()
        return c.get_node_id(), c.task_id, c.actor_id

    def pid(self):
        return os.getpid()

    def echo(self, x):
        return x

    def big_stream(self, n):
        blob = bytes(BIG)
        for _ in range(n):
            yield blob


class AsyncSleeper:
    async def sleep(self, path):
        pathlib.Path(path + ".started").touch()
        try:
            await asyncio.sleep(30)
        except asyncio.CancelledError:
            pathlib.Path(path + ".cancelled").touch()
            raise
        return "slept"

    async def ping(self):
        return "pong"


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


def _wait_for(path, timeout=20.0, what="started"):
    deadline = time.time() + timeout
    while not os.path.exists(path):
        assert time.time() < deadline, f"never {what}: {path}"
        time.sleep(0.05)


def _warm_cluster(pkg, n=4):
    api = api_of(pkg)
    assert api.get([api.remote(_noop).remote(i) for i in range(n)],
                   timeout=60) == list(range(n))


def _raised(fn):
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 — the outcome compared
        return e
    return None


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


def cancel_shape(e):
    """The shape of a cancelled call's error. Divergence by design (ROADMAP
    queue C): a running call's TaskCancelledError reaches the port's
    caller as itself, the JAX package's inside a TaskError; that TaskError
    counts as its cause here."""
    cause = getattr(e, "cause", None)
    if (type(e).__name__ == "TaskError"
            and type(cause).__name__ == "TaskCancelledError"):
        e = cause
    return shape(e)


def through_both(scenario):
    """``scenario(pkg)`` for each package; the port's outcome, once held
    equal to the JAX package's."""
    out = {pkg: scenario(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"], out
    return out["port"]


# ------------------------------- tests/test_cancel_tree.py, case for case


def _double_cancel(pkg):
    api = api_of(pkg)
    base = _sentinel("dc")
    ref = api.remote(_spin_hb).remote(base)
    _wait_for(base + ".started")
    api.cancel(ref)
    api.cancel(ref)  # a second cancel is a no-op, not an error
    err = _raised(lambda: api.get(ref, timeout=20))
    api.cancel(ref)  # cancel after the failure is a no-op too
    return {"error": cancel_shape(err)}


def test_double_cancel_idempotent(both):
    out = through_both(_double_cancel)
    assert out["error"]["classes"][0] == "TaskCancelledError"


def _cancel_finished(pkg):
    api = api_of(pkg)
    ref = api.remote(add).remote(20, 22)
    first = api.get(ref, timeout=30)
    api.cancel(ref)
    api.cancel(ref, recursive=True)
    return {"first": first, "after": api.get(ref, timeout=30)}


def test_cancel_finished_ref_noop(both):
    assert through_both(_cancel_finished) == {"first": 42, "after": 42}


def _queued_actor_call(pkg):
    api = api_of(pkg)
    a = api.remote(Blocker).remote()
    r1 = a.block.remote(4)
    time.sleep(0.5)  # block() runs, quick() waits behind it
    r2 = a.quick.remote()
    t0 = time.time()
    api.cancel(r2)
    err = _raised(lambda: api.get(r2, timeout=8))
    took = time.time() - t0
    out = {"error": cancel_shape(err),
           "before_the_running_one_ended": took < 3,
           "running_one": api.get(r1, timeout=30)}
    api.kill(a)
    return out, took


def test_queued_actor_call_cancel_no_worker_roundtrip(both):
    """A call still queued behind a running one fails long before the
    running one ends; the running one is untouched."""
    out = {pkg: _queued_actor_call(pkg) for pkg in PKGS}
    assert out["port"][0] == out["jax"][0], out
    assert out["port"][0]["error"]["classes"][0] == "TaskCancelledError"
    assert out["port"][1] < 2, f"queued-call cancel took {out['port'][1]}"


def _recursive(pkg):
    api = api_of(pkg)
    _warm_cluster(pkg)
    bases = [_sentinel("rc0"), _sentinel("rc1")]
    pref = api.remote(parent).remote(bases, pkg)
    for b in bases:
        _wait_for(b + ".started")
    api.cancel(pref, recursive=True)
    err = _raised(lambda: api.get(pref, timeout=20))
    time.sleep(1.0)
    mtimes = [os.path.getmtime(b + ".hb") for b in bases]
    time.sleep(1.0)
    return {"error": err is not None,
            "children_stopped": [os.path.getmtime(b + ".hb") == m
                                 for b, m in zip(bases, mtimes)],
            "children_done": [os.path.exists(b + ".done") for b in bases]}


def test_recursive_cancel_kills_child_tree(both):
    """cancel(parent, recursive=True) interrupts the parent and every
    running child it submitted."""
    assert through_both(_recursive) == {
        "error": True, "children_stopped": [True, True],
        "children_done": [False, False]}


def _recursive_through_finished(pkg):
    api = api_of(pkg)
    _warm_cluster(pkg)
    base = _sentinel("rcf")
    pref = api.remote(spawn).remote(base, pkg)
    child_ref = api.get(pref, timeout=30)
    _wait_for(base + ".started")
    api.cancel(pref, recursive=True)  # parent finished, child alive
    time.sleep(1.0)
    m = os.path.getmtime(base + ".hb")
    time.sleep(1.0)
    return {"child_stopped": os.path.getmtime(base + ".hb") == m,
            "child_done": os.path.exists(base + ".done"),
            "child_error": _raised(
                lambda: api.get(child_ref, timeout=20)) is not None}


def test_recursive_cancel_through_finished_parent(both):
    """A parent that finished (it returned its child's ref) is still the
    root of a recursive cancel."""
    assert through_both(_recursive_through_finished) == {
        "child_stopped": True, "child_done": False, "child_error": True}


# ------------------------------------- the dependency errors, a node's keys


def _dependency_errors(pkg):
    api = api_of(pkg)
    a = api.remote(Blocker).remote()
    out = {"task": shape(_raised(lambda: api.get(
               api.remote(add).remote(api.remote(boom).remote(), 1),
               timeout=30))),
           "actor_call": shape(_raised(lambda: api.get(
               a.echo.remote(api.remote(boom).remote()), timeout=30)))}
    api.kill(a)
    return out


def test_dependency_errors_are_the_jax_packages(both):
    """A task on a failed object: DependencyError; an actor call: TaskError
    around the upstream's TaskError, as the JAX package raises them."""
    out = through_both(_dependency_errors)
    assert out["task"]["classes"][0] == "DependencyError"
    assert out["actor_call"]["cause"]["classes"][0] == "TaskError"


def test_a_node_has_the_jax_packages_keys(both):
    import ray_tpu

    (node,) = rt.nodes()
    assert set(node) == set(ray_tpu.nodes()[0])
    assert node["alive"] and node["resources"] == rt.cluster_resources()


# ------------------------------------------------------- what the port adds


def test_running_actor_call_raises_in_its_thread(core):
    a = rt.remote(Blocker).remote()
    base = _sentinel("ra")
    ref = a.spin.remote(base)
    _wait_for(base + ".started")
    rt.cancel(ref)
    with pytest.raises(rt.TaskCancelledError):
        rt.get(ref, timeout=10)
    assert os.path.exists(base + ".cancelled")
    assert rt.get(a.quick.remote(), timeout=10) == "q"  # the actor lives
    rt.kill(a)


def test_running_coroutine_is_cancelled(core):
    a = rt.remote(AsyncSleeper).remote()
    base = _sentinel("co")
    ref = a.sleep.remote(base)
    _wait_for(base + ".started")
    rt.cancel(ref)
    with pytest.raises(rt.TaskCancelledError):
        rt.get(ref, timeout=10)
    assert os.path.exists(base + ".cancelled")
    assert rt.get(a.ping.remote(), timeout=10) == "pong"
    rt.kill(a)


def test_force_stops_the_task_worker_and_frees_its_cpus(core):
    _warm_cluster("port")
    free = rt.available_resources()["CPU"]
    base = _sentinel("fo")
    ref = rt.remote(_spin_hb).options(num_cpus=2).remote(base)
    _wait_for(base + ".started")
    assert rt.available_resources()["CPU"] == free - 2
    procs_before = {p.pid for p in _runtime().task_procs}
    rt.cancel(ref, force=True)
    with pytest.raises(rt.TaskCancelledError, match="force"):
        rt.get(ref, timeout=10)
    deadline = time.time() + 10
    while rt.available_resources()["CPU"] != free:
        assert time.time() < deadline, rt.available_resources()
        time.sleep(0.02)
    gone = procs_before - {p.pid for p in _runtime().task_procs}
    assert len(gone) == 1  # the pool spawns another when one is needed
    assert rt.get(rt.remote(add).remote(1, 2), timeout=30) == 3


def test_force_on_an_actor_call_degrades_to_the_raise(core):
    a = rt.remote(Blocker).remote()
    pid = rt.get(a.pid.remote(), timeout=30)
    base = _sentinel("fa")
    ref = a.spin.remote(base)
    _wait_for(base + ".started")
    rt.cancel(ref, force=True)
    with pytest.raises(rt.TaskCancelledError):
        rt.get(ref, timeout=10)
    assert rt.get(a.pid.remote(), timeout=10) == pid  # not restarted
    rt.kill(a)


def test_a_task_cancels_what_it_submitted(core):
    _warm_cluster("port")
    assert rt.get(rt.remote(cancels_its_child).remote(_sentinel("tc")),
                  timeout=60) == "cancelled"


def test_cancel_of_a_queued_task_never_runs_it(core):
    base = _sentinel("qt")
    hog = rt.remote(_spin_hb).options(num_cpus=4).remote(base)  # all CPUs
    _wait_for(base + ".started")
    marker = _sentinel("qtm")
    ref = rt.remote(touch).remote(marker)
    rt.cancel(ref)
    with pytest.raises(rt.TaskCancelledError, match="before it started"):
        rt.get(ref, timeout=5)
    rt.cancel(hog)
    with pytest.raises(rt.TaskCancelledError):
        rt.get(hog, timeout=10)
    assert not os.path.exists(marker)


def test_deadline_on_a_queued_task(core):
    base = _sentinel("dl")
    hog = rt.remote(_spin_hb).options(num_cpus=4).remote(base)
    _wait_for(base + ".started")
    marker = _sentinel("dlm")
    ref = rt.remote(touch).options(deadline_s=0.5).remote(marker)
    with pytest.raises(rt.DeadlineExceededError) as ei:
        rt.get(ref, timeout=10)
    assert isinstance(ei.value, TimeoutError)
    rt.cancel(hog)
    with pytest.raises(rt.TaskCancelledError):
        rt.get(hog, timeout=10)
    assert not os.path.exists(marker)
    assert rt.get(rt.remote(touch).options(deadline_s=30).remote(marker),
                  timeout=30) == "ran"


def test_deadline_on_an_actor_call_queued_in_its_process(core):
    """Refused where the actor dequeues it: it never runs."""
    a = rt.remote(Blocker).remote()
    r1 = a.block.remote(2)
    time.sleep(0.3)
    marker = _sentinel("dla")
    ref = a.mark.options(deadline_s=0.5).remote(marker)
    with pytest.raises(rt.DeadlineExceededError):
        rt.get(ref, timeout=10)
    assert rt.get(r1, timeout=10) == "done"
    assert not os.path.exists(marker)
    assert rt.get(a.mark.options(deadline_s=30).remote(marker),
                  timeout=10) == "ran"
    rt.kill(a)


def test_free_and_error_of(core):
    ok = rt.put(123)
    assert rt.error_of(ok) is None
    bad = rt.remote(boom).remote()
    err = rt.error_of(bad, timeout=30)
    assert isinstance(err, rt.TaskError) and "kaboom" in str(err)
    rt.free([ok])
    with pytest.raises(rt.GetTimeoutError):
        rt.get(ok, timeout=0.5)
    with pytest.raises(rt.GetTimeoutError):
        rt.error_of(ok, timeout=0.5)
    pending = rt.remote(_spin_hb).remote(_sentinel("eo"), 1.0)
    with pytest.raises(rt.GetTimeoutError):
        rt.error_of(pending, timeout=0.2)
    assert rt.get(pending, timeout=30) == 1


def test_resources_nodes_and_runtime_context(core):
    res = rt.available_resources()
    assert set(res) == {"CPU", "GPU"} and res["CPU"] <= 4.0
    (node,) = rt.nodes()
    assert node["alive"] and node["resources"] == rt.cluster_resources()
    c = rt.get_runtime_context()
    assert c.get_node_id() == node["node_id"]
    assert c.actor_id is None and c.task_id is None
    assert set(c.get_accelerator_ids()) == {"GPU"}
    nid, tid, aid, acc, cpu, n = rt.get(rt.remote(where_am_i).remote(),
                                        timeout=30)
    assert nid == node["node_id"] and tid and aid is None
    assert acc == {"GPU": []} and cpu <= 3.0 and n == 1
    a = rt.remote(Blocker).remote()
    nid, tid, aid = rt.get(a.context.remote(), timeout=30)
    assert nid == node["node_id"] and tid and aid == a._actor_id
    rt.kill(a)


@pytest.mark.parametrize("what", ["actor_stream", "task_put"])
def test_cancel_while_sending_a_large_message_leaves_the_pipe_whole(
        core, what):
    """A cancel raised into a call's thread while it sends BIG bytes up
    its pipe (a streamed item, a put) never leaves half a message there:
    after each of many cancels at random moments, the process still
    answers."""
    rng = random.Random(0)
    a = rt.remote(Blocker).remote()
    assert rt.get(a.quick.remote(), timeout=60) == "q"
    _warm_cluster("port")
    for i in range(40):
        if what == "actor_stream":
            gen = a.big_stream.options(num_returns="streaming").remote(10**6)
            time.sleep(rng.uniform(0.0, 0.02))
            rt.cancel(gen)
            # Behind the stream on the actor's one thread: answered once
            # the stream's call has ended, so the stream's end is there.
            assert rt.get(a.quick.remote(), timeout=20) == "q", i
            with pytest.raises(rt.TaskCancelledError):
                for r in gen:
                    rt.get(r, timeout=20)
        else:
            marker = _sentinel("pf")
            ref = rt.remote(put_forever).remote(marker)
            _wait_for(marker)
            time.sleep(rng.uniform(0.0, 0.02))
            rt.cancel(ref)
            with pytest.raises(rt.TaskCancelledError):
                rt.get(ref, timeout=20)
            os.unlink(marker)
            assert rt.get([rt.remote(add).remote(j, 1) for j in range(8)],
                          timeout=20) == list(range(1, 9)), i
    rt.kill(a)


def test_a_process_keeps_only_the_calls_a_cancel_can_still_reach():
    """A process's call registry holds a call from its receipt to its end:
    a cancel of an ended or unknown call records nothing, one of a call
    received and not begun refuses it in the JAX worker's words, and
    nothing is left once each call has begun or dropped."""
    from ray_tpu_torch.core import worker

    calls = worker._Calls()
    assert calls.cancel(1) is None  # never received here
    calls.expect((2, "call", ("m", None, {"task_id": "0123456789ab"}), {}))
    calls.expect((3, "run", (len, {"task_id": "ba9876543210"}), {}))
    calls.expect((4, "call", ("m", None, {"task_id": "feed"}), {}))
    calls.expect((5, "dag_status", ("d",), {}))  # not a task or a call
    refused = calls.cancel(2)
    assert isinstance(refused.exc, rt.TaskCancelledError)
    assert str(refused.exc) == "actor call 01234567 was cancelled while queued"
    assert str(calls.cancel(3).exc) == (
        "task ba987654 was cancelled before it started")
    assert not calls.begin(2, None) and not calls.drop(3)
    assert calls.drop(4)  # answered without running
    assert calls.cancel(4) is None and calls.cancel(5) is None
    assert calls.begin(6, None)
    calls.end(6)
    assert calls.cancel(6) is None  # ended
    assert (calls.queued, calls.running, calls.cancelled, calls.raised) == (
        {}, {}, set(), set())
