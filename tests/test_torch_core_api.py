"""The port's core API on one host (``ray_tpu_torch.core``): tasks,
objects, actors and actor checkpoints, case for case with the JAX
package's tests/test_core_tasks.py (:16-36, :53-93, :110, :115),
tests/test_actors.py (:22-29, :46-98, :160-211) and
tests/test_actor_checkpoint.py (:68, :151, :233, :292-330), where one
host allows; the JAX tests' nested ``@remote`` functions and classes are
module-level here (the port sends them by name). Refs and handles that
cross processes, tasks submitted from tasks (tests/test_core_tasks.py:42,
:102, tests/test_actors.py:35), task retries
(tests/test_fault_tolerance.py:26, :40, :114, :131) and async actors
whose coroutines interleave are held here too.

Task workers and actor processes import this module again to find its
functions and classes, so its top loads neither torch nor jax.
"""
import multiprocessing
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import checkpoint as ckpt
from ray_tpu_torch.core import worker as core_worker


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def passthrough(lst):
    return lst


@rt.remote
def boom():
    raise ValueError("kaboom")


@rt.remote
def slow(t):
    time.sleep(t)
    return t


@rt.remote(num_returns=2)
def two():
    return 1, 2


@rt.remote
def submits_a_task():
    return rt.get(add.remote(20, 22))


@rt.remote
def gets_nested(lst):
    assert isinstance(lst[0], rt.ObjectRef)
    return rt.get(lst[0])


@rt.remote
def relay(lst):
    """Gets a ref it was sent, nested; returns a ref of its own put (made
    through the driver) and the ref it was sent."""
    inner = lst[0]
    return [rt.put(rt.get(inner) + 1)], inner


@rt.remote
def bump(handle):
    return rt.get(handle.inc.remote(10))


@rt.remote(max_retries=2)
def dies_once(marker):
    if not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(1)  # the worker dies in the middle of the task
    return "survived"


@rt.remote
def dies():
    os._exit(1)


@rt.remote(max_retries=1)
def square_or_die(i, marker):
    if i == 3 and not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(1)
    return i * i


@rt.remote(max_retries=3, retry_exceptions=True)
def fails_twice(marker):
    n = int(open(marker).read() or 0) if os.path.exists(marker) else 0
    with open(marker, "w") as f:
        f.write(str(n + 1))
    if n < 2:
        raise ValueError(f"app failure #{n}")
    return n


@rt.remote(max_retries=3)
def always_raises():
    raise ValueError("boom")


@rt.remote
def modules_loaded():
    return sorted(m for m in ("torch", "jax", "ray_tpu") if m in sys.modules)


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, k=1):
        self.n += k
        return self.n

    def read(self):
        return self.n

    def get(self):
        return self.n

    def sleep_then_mark(self, path, tag, sleep_s=0.0):
        if sleep_s:
            time.sleep(sleep_s)
        with open(path, "a") as f:
            f.write(tag + "\n")
            f.flush()
        return tag

    def pid(self):
        return os.getpid()


@rt.remote
class Bad:
    def __init__(self):
        raise RuntimeError("bad init")

    def ping(self):
        return 1


@rt.remote
class Flaky:
    def boom(self):
        raise ValueError("x")

    def ok(self):
        return "fine"


@rt.remote
class AsyncActor:
    async def compute(self, x):
        return x * 2


@rt.remote
class Splitter:
    @rt.method(num_returns=2)
    def pair(self, x):
        return x, x + 1

    def single(self, x):
        return x


@rt.remote(max_restarts=3)
class Quitter:
    def ping(self):
        return "ok"

    def quit(self):
        rt.exit_actor()
        return "unreachable"


@rt.remote(max_restarts=2)
class AsyncQuitter:
    async def quit(self):
        rt.exit_actor()

    async def ping(self):
        return "ok"


@rt.remote
class SyncQuitter:
    def quit(self):
        time.sleep(0.8)  # let the chaser join the queue
        rt.exit_actor()

    def ping(self):
        return "ok"


@rt.remote
class PairQuitter:
    @rt.method(num_returns=2)
    def quit(self):
        rt.exit_actor()


@rt.remote
class HoldsHandle:
    def __init__(self, handle):
        self.handle = handle

    def bump(self, k):
        return rt.get(self.handle.inc.remote(k))


@rt.remote
class Keeper:
    """Holds a ref it was sent, nested in a list."""

    def keep(self, lst):
        self.ref = lst[0]
        return True

    def read(self):
        return rt.get(self.ref)

    def drop(self):
        del self.ref
        return True


@rt.remote
class Gate:
    """An async actor: ``wait_open`` awaits until ``open`` runs."""

    def __init__(self):
        self.event = None
        self.log = []

    def _event(self):
        import asyncio

        if self.event is None:
            self.event = asyncio.Event()
        return self.event

    async def wait_open(self, tag):
        await self._event().wait()
        self.log.append(tag)
        return tag

    async def open(self):
        self._event().set()
        self.log.append("open")
        return "opened"

    def read_log(self):
        return list(self.log)


def _wait_for(pred, timeout=30.0, interval=0.05, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise TimeoutError(f"timed out waiting for {desc}")


def _leftover_processes():
    return [p for p in multiprocessing.active_children()
            if p.name.startswith(("rtpt-task", "rtpt-actor"))]


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    os.environ["RTPU_CHECKPOINT_DIR"] = str(
        tmp_path_factory.mktemp("actor-ckpt"))
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()
        os.environ.pop("RTPU_CHECKPOINT_DIR", None)
    assert _leftover_processes() == []


def _runtime():
    from ray_tpu_torch.core import api

    return api.runtime()


# ------------------------------------------------ tasks and objects


def test_task_roundtrip(core):
    assert rt.get(add.remote(1, 2)) == 3


def test_parallel_tasks(core):
    refs = [add.remote(i, i) for i in range(8)]
    assert rt.get(refs) == [2 * i for i in range(8)]


def test_put_get_small(core):
    ref = rt.put({"k": [1, 2, 3]})
    assert rt.get(ref) == {"k": [1, 2, 3]}


def test_put_get_large_shm(core):
    """A 4 MB array: put, and through a task both ways (arguments and
    results of 1 MiB or more travel as files)."""
    big = np.arange(1_000_000, dtype=np.float32)
    out = rt.get(rt.put(big))
    np.testing.assert_array_equal(out, big)
    np.testing.assert_array_equal(rt.get(add.remote(big, 1.0)), big + 1.0)
    assert os.listdir(_runtime().spill_dir) == []  # each file read once


def test_objectref_arg_dependency(core):
    r1 = add.remote(1, 1)
    r2 = add.remote(r1, 10)
    assert rt.get(r2) == 12


def test_num_returns(core):
    a, b = two.remote()
    assert rt.get(a) == 1 and rt.get(b) == 2


def test_task_error_propagates(core):
    with pytest.raises(rt.TaskError) as ei:
        rt.get(boom.remote())
    assert isinstance(ei.value.cause, ValueError)


def test_dependency_error_propagates(core):
    downstream = add.remote(boom.remote(), 1)
    with pytest.raises(rt.RayTpuError):
        rt.get(downstream)


def test_wait(core):
    fast, slow_ref = slow.remote(0.05), slow.remote(10)
    ready, not_ready = rt.wait([fast, slow_ref], num_returns=1, timeout=5)
    assert ready == [fast] and not_ready == [slow_ref]


def test_get_timeout(core):
    with pytest.raises(rt.GetTimeoutError):
        rt.get(slow.remote(3), timeout=0.5)


def test_remote_function_not_callable(core):
    with pytest.raises(TypeError):
        add(1, 2)


def test_cluster_resources(core):
    res = rt.cluster_resources()
    assert res.get("CPU", 0) >= 4


def test_task_workers_load_no_torch(core):
    """A task worker imports what its function's module imports: this
    module's top loads neither torch nor jax, nor does the core."""
    assert rt.get(modules_loaded.remote()) == []


# ------------------------------------- refusals of this slice (divergences)


def test_nested_ref_passthrough(core):
    """tests/test_core_tasks.py:42: a ref nested in an argument arrives
    as a ref, and the task gets its value from the driver."""
    inner = rt.put(42)
    assert rt.get(gets_nested.remote([inner])) == 42
    # A task's result that holds a ref hands it back to the driver.
    (back,) = rt.get(passthrough.remote([inner]))
    assert isinstance(back, rt.ObjectRef) and rt.get(back) == 42


def test_nested_task_submission(core):
    """tests/test_core_tasks.py:102: a task submits a task and gets it."""
    assert rt.get(submits_a_task.remote(), timeout=60) == 42


_ONE_CPU_SCRIPT = r"""
import sys
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def outer():
    return rt.get(add.remote(20, 22))


@rt.remote
def waits_outer():
    ready, _ = rt.wait([outer.remote()], num_returns=1, timeout=60)
    return rt.get(ready[0])


if __name__ == "__main__":
    rt.init(num_cpus=1)
    try:
        print("NESTED", rt.get(outer.remote(), timeout=60))
        print("DEEPER", rt.get(waits_outer.remote(), timeout=60))
    finally:
        rt.shutdown()
"""


def test_nested_task_submission_on_one_cpu(tmp_path):
    """tests/test_core_tasks.py:102 under ``init(num_cpus=1)``: the outer
    task gives its CPU back while it waits, so the inner one runs (a
    driver of its own, in a process with a time limit of its own: a
    deadlock fails the test instead of hanging it)."""
    script = tmp_path / "one_cpu.py"
    script.write_text(_ONE_CPU_SCRIPT.format(
        repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=90, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines() == ["NESTED 42", "DEEPER 42"]


def test_actor_handle_passing(core):
    """tests/test_actors.py:35: a handle passed into a task calls the
    actor through the driver; so does one passed to an actor's
    constructor."""
    c = Counter.remote(0)
    assert rt.get(bump.remote(c), timeout=60) == 10
    assert rt.get(c.read.remote()) == 10
    h = HoldsHandle.remote(c)
    assert rt.get(h.bump.remote(5), timeout=60) == 15
    assert rt.get(c.read.remote()) == 15
    rt.kill(h)
    rt.kill(c)


def test_borrowed_ref_pins_its_object(core):
    """A ref held in an actor pins its object after the driver dropped
    its own, until the actor drops its copy; the process's exit drops
    every ref it held."""
    import gc

    holds = _runtime().holds
    k = Keeper.remote()
    ref = rt.put("kept")
    oid = ref.object_id
    assert rt.get(k.keep.remote([ref]), timeout=30)
    del ref
    gc.collect()
    assert oid in holds
    assert rt.get(k.read.remote(), timeout=30) == "kept"
    assert rt.get(k.drop.remote(), timeout=30)
    _wait_for(lambda: oid not in holds, desc="the released borrow")
    ref = rt.put("again")
    oid = ref.object_id
    assert rt.get(k.keep.remote([ref]), timeout=30)
    del ref
    gc.collect()
    rt.kill(k)
    _wait_for(lambda: oid not in holds, desc="the dead borrower's refs")


def test_ref_borrows_balance_under_load(core):
    """64 tasks on 4 CPUs pass refs both ways at once, with the
    interpreter switching threads every 10 us: every value arrives, and
    once the driver drops its refs every object is released (a lost
    update to a hold count would pin one for good or free one in use)."""
    import gc

    holds = _runtime().holds
    base = set(holds)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        refs = [rt.put(i) for i in range(64)]
        got = rt.get([relay.remote([r]) for r in refs], timeout=120)
        assert rt.get([g[0][0] for g in got], timeout=60) == [
            i + 1 for i in range(64)]
        assert [g[1] for g in got] == refs
        del refs, got
        gc.collect()
        _wait_for(lambda: set(holds) <= base, timeout=30,
                  desc="every object released")
    finally:
        sys.setswitchinterval(old)


def test_task_retries_on_worker_death(core, tmp_path):
    """tests/test_fault_tolerance.py:26, :40, :114."""
    marker = str(tmp_path / "died")
    assert rt.get(dies_once.remote(marker), timeout=60) == "survived"
    with pytest.raises(rt.WorkerCrashedError):
        rt.get(dies.remote(), timeout=60)
    marker = str(tmp_path / "died3")
    out = rt.get([square_or_die.remote(i, marker) for i in range(8)],
                 timeout=90)
    assert out == [i * i for i in range(8)]


def test_retry_exceptions_retries_application_errors(core, tmp_path):
    """tests/test_fault_tolerance.py:131: retry_exceptions re-runs a task
    whose own code raised; without it the error surfaces at once."""
    marker = str(tmp_path / "count")
    assert rt.get(fails_twice.remote(marker), timeout=60) == 2
    with pytest.raises(rt.TaskError, match="boom"):
        rt.get(always_raises.remote(), timeout=30)


def test_catch_exceptions_option_is_carried(core):
    """The workflow layer's option rides on the task and changes nothing
    here (as in the JAX package)."""
    f = add.options(catch_exceptions=True)
    assert f._options["catch_exceptions"] is True
    assert rt.get(f.remote(1, 2)) == 3


def test_async_actor_calls_interleave(core):
    """A coroutine blocked on an event holds up no other call: the gate's
    opener runs while two waiters wait, and a sync method runs (off the
    loop) meanwhile."""
    g = Gate.remote()
    first = g.wait_open.remote("a")
    second = g.wait_open.remote("b")
    ready, _ = rt.wait([first, second], num_returns=1, timeout=1.0)
    assert ready == []
    assert rt.get(g.read_log.remote(), timeout=30) == []
    assert rt.get(g.open.remote(), timeout=30) == "opened"
    assert rt.get([first, second], timeout=30) == ["a", "b"]
    assert rt.get(g.read_log.remote(), timeout=30) == ["open", "a", "b"]
    rt.kill(g)


def test_nested_function_and_class_refused_before_any_spawn(core):
    def nested(x):
        return x

    class Nested:
        pass

    before = len(_runtime().task_procs), len(_runtime().actors)
    with pytest.raises(TypeError, match="nested"):
        rt.remote(nested).remote(1)
    with pytest.raises(TypeError, match="Nested"):
        rt.remote(Nested).remote()
    with pytest.raises(TypeError, match="lambda"):
        add.remote(lambda: 1, 2)
    assert (len(_runtime().task_procs), len(_runtime().actors)) == before


def test_num_gpus_without_cuda_refused_before_any_spawn(core, monkeypatch):
    rt_ = _runtime()
    monkeypatch.setattr(rt_, "_num_gpus", 0)
    before = len(rt_.actors)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Counter.options(num_gpus=1).remote()
    assert len(rt_.actors) == before
    with pytest.raises(ValueError, match="0 or 1"):
        Counter.options(num_gpus=2)


# ------------------------------------------------------------- actors


def test_actor_basic(core):
    c = Counter.remote(100)
    assert rt.get(c.inc.remote()) == 101
    assert rt.get(c.inc.remote(5)) == 106
    assert rt.get(c.read.remote()) == 106
    rt.kill(c)


def test_actor_ordered_execution(core):
    c = Counter.remote(0)
    refs = [c.inc.remote() for _ in range(20)]
    assert rt.get(refs) == list(range(1, 21))
    rt.kill(c)


def test_named_actor(core):
    c = Counter.options(name="the-counter").remote(7)
    rt.get(c.read.remote())
    h = rt.get_actor("the-counter")
    assert rt.get(h.read.remote()) == 7
    rt.kill(c)


def test_named_actor_duplicate_rejected(core):
    c = Counter.options(name="dup-counter").remote(0)
    with pytest.raises(Exception):
        Counter.options(name="dup-counter").remote(0)
    rt.kill(c)


def test_kill_actor(core):
    c = Counter.options(name="victim").remote(0)
    rt.get(c.read.remote())
    rt.kill(c)
    time.sleep(0.2)
    with pytest.raises(Exception):
        rt.get(c.read.remote(), timeout=5)
    with pytest.raises(ValueError):
        rt.get_actor("victim")  # the name is free again


def test_actor_constructor_error(core):
    b = Bad.remote()
    with pytest.raises(rt.ActorDiedError, match="bad init"):
        rt.get(b.ping.remote(), timeout=30)


def test_actor_method_error(core):
    f = Flaky.remote()
    with pytest.raises(rt.TaskError):
        rt.get(f.boom.remote())
    # The actor survives a method's error.
    assert rt.get(f.ok.remote()) == "fine"
    rt.kill(f)


def test_async_actor_method(core):
    a = AsyncActor.remote()
    assert rt.get(a.compute.remote(21)) == 42
    rt.kill(a)


def test_method_decorator_num_returns(core):
    s = Splitter.options(name="splitter-m").remote()
    a, b = s.pair.remote(5)
    assert rt.get([a, b], timeout=30) == [5, 6]
    assert rt.get(s.single.remote(7), timeout=30) == 7
    g = rt.get_actor("splitter-m")
    c, d = g.pair.remote(10)
    assert rt.get([c, d], timeout=30) == [10, 11]
    rt.kill(s)


def _dies(ping, timeout=20):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            rt.get(ping(), timeout=5)
        except Exception:
            return True
        time.sleep(0.3)
    return False


def test_exit_actor(core):
    """exit_actor retires the actor: the call returns, later calls fail,
    and max_restarts does not bring it back."""
    q = Quitter.remote()
    assert rt.get(q.ping.remote(), timeout=30) == "ok"
    assert rt.get(q.quit.remote(), timeout=30) is None
    assert _dies(q.ping.remote), "actor survived exit_actor"
    assert _runtime().actor_info(q._actor_id)["restarts"] == 0


def test_exit_actor_async_and_queued_and_multireturn(core):
    a = AsyncQuitter.remote()
    assert rt.get(a.ping.remote(), timeout=30) == "ok"
    assert rt.get(a.quit.remote(), timeout=30) is None
    assert _dies(a.ping.remote), "async exit_actor did not retire the actor"

    # A call queued behind the exiting call fails, not runs.
    s = SyncQuitter.remote()
    assert rt.get(s.ping.remote(), timeout=30) == "ok"
    q = s.quit.remote()
    chased = s.ping.remote()
    assert rt.get(q, timeout=30) is None
    with pytest.raises(Exception):
        rt.get(chased, timeout=20)

    p = PairQuitter.remote()
    x, y = p.quit.remote()
    assert rt.get([x, y], timeout=30) == [None, None]


# ------------------------------------------- checkpoints and restarts


def _state(handle):
    return _runtime().control(handle._actor_id, "checkpoint_state")


def _sigkill(handle):
    os.kill(_runtime().actor_info(handle._actor_id)["pid"], signal.SIGKILL)


def test_sigkill_restores_checkpoint_state(core):
    """SIGKILL the actor's process: the restart restores the newest
    checkpoint (every call checkpoints here, so nothing is lost) instead
    of running the constructor again."""
    a = Counter.options(max_restarts=2, max_task_retries=-1,
                        checkpoint_every_n=1).remote()
    for _ in range(5):
        rt.get(a.inc.remote())
    assert _state(a)["epoch"] >= 5
    _sigkill(a)
    assert rt.get(a.get.remote(), timeout=30) == 5
    info = _runtime().actor_info(a._actor_id)
    assert info["state"] == "alive" and info["restarts"] == 1
    assert _state(a)["restored_epoch"] >= 5
    rt.kill(a)


def test_replayed_calls_apply_exactly_once(core, tmp_path):
    """Kill the actor with two calls sent, the first answered (journaled
    and checkpointed), the second mid-call: the replay sends both again;
    the first returns its journaled value without running, the second
    runs (it never wrote), so each marker lands once."""
    marker = str(tmp_path / "markers.txt")
    a = Counter.options(max_restarts=4, max_task_retries=-1,
                        checkpoint_every_n=1).remote()
    rt.get(a.inc.remote())
    ref_b = a.sleep_then_mark.remote(marker, "B")
    ref_a = a.sleep_then_mark.remote(marker, "A", 2.5)
    _wait_for(lambda: os.path.exists(marker)
              and "B\n" in open(marker).read(), desc="first call's marker")
    time.sleep(0.4)
    _sigkill(a)
    assert rt.get(ref_b, timeout=30) == "B"
    assert rt.get(ref_a, timeout=30) == "A"
    lines = open(marker).read().splitlines()
    assert sorted(lines) == ["A", "B"], lines
    assert rt.get(a.get.remote(), timeout=30) == 1
    rt.kill(a)


def test_no_task_retries_fails_the_call_in_flight(core):
    a = Counter.options(max_restarts=1).remote()
    first = rt.get(a.pid.remote())
    ref = a.sleep_then_mark.remote(os.devnull, "x", 5.0)
    time.sleep(0.3)
    _sigkill(a)
    with pytest.raises(rt.ActorDiedError, match="max_task_retries=0"):
        rt.get(ref, timeout=30)
    assert rt.get(a.pid.remote(), timeout=30) != first  # restarted
    assert rt.get(a.get.remote(), timeout=30) == 0  # no checkpoint: ctor
    rt.kill(a)


class _Instance:
    def __init__(self):
        self.ran = 0

    def bump(self):
        self.ran += 1
        return self.ran


def test_exactly_once_journal_dedup_unit(tmp_path, monkeypatch):
    """The host's journal: a call number it holds returns its journaled
    value without running; another number runs."""
    import pickle

    monkeypatch.setenv("RTPU_CHECKPOINT_DIR", str(tmp_path))
    host = core_worker.ActorHost(pickle.dumps((_Instance, (), {})),
                                 "unit-actor", {"max_task_retries": -1},
                                 restore=False)
    assert host.call("bump", 0) == 1
    assert host.call("bump", 0) == 1  # journal hit: did not run
    assert host.instance.ran == 1
    assert host.call("bump", 1) == 2
    assert host.call("bump", None) == 3  # no number: no dedup


def test_checkpoint_record_roundtrip_unit(tmp_path, monkeypatch):
    import pickle

    monkeypatch.setenv("RTPU_CHECKPOINT_DIR", str(tmp_path))
    rec = ckpt.decode(ckpt.encode({"state": 7}, {"c": {0: "p"}}, 4))
    assert rec["epoch"] == 4 and rec["instance"] == {"state": 7}
    assert rec["journal"] == {"c": {0: "p"}}
    legacy = ckpt.decode(pickle.dumps({"plain": "instance"}))
    assert legacy["epoch"] == 0 and legacy["journal"] == {}
    assert legacy["instance"] == {"plain": "instance"}
    ckpt.write_local("actorX", 1, b"one")
    ckpt.write_local("actorX", 3, b"three")
    assert ckpt.newest_local("actorX") == (3, b"three")
    assert [e for e, _ in ckpt._list_local("actorX")] == [3]
    ckpt.prune_local("actorX")
    assert ckpt.newest_local("actorX") is None


def test_checkpoint_interval(core):
    """Interval checkpoints: epochs advance with no further calls."""
    a = Counter.options(max_restarts=1, checkpoint_interval_s=0.2).remote()
    rt.get(a.inc.remote())
    _wait_for(lambda: _state(a)["epoch"] >= 2,
              desc="interval checkpoints advancing")
    rt.kill(a)


def test_checkpoint_disabled_flag(core, monkeypatch):
    """RTPU_ACTOR_CHECKPOINT=0 (the actor's environment at its spawn)
    turns checkpoints off."""
    monkeypatch.setenv("RTPU_ACTOR_CHECKPOINT", "0")
    a = Counter.options(max_restarts=1, checkpoint_every_n=1).remote()
    for _ in range(3):
        rt.get(a.inc.remote())
    time.sleep(0.5)
    assert _state(a)["epoch"] == 0
    rt.kill(a)


# ----------------------------------------------------- serialization


def test_cuda_tensor_travels_as_host_copy(monkeypatch):
    """A CUDA tensor pickles as its host copy, and the receiver puts it on
    its own device (serialization.own_device), not on the sender's
    card: the tensor's card is not in the bytes. The card stands in for
    a CPU tensor here; the card's own case is in
    tests/test_torch_kernels_cuda.py."""
    import pickle

    import torch

    from ray_tpu_torch.core import serialization as ser

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(
        torch.bfloat16)
    monkeypatch.setattr(ser, "_on_card", lambda x: True)
    seen = []

    def own_device():
        seen.append(1)
        return torch.device("cpu")

    monkeypatch.setattr(ser, "own_device", own_device)
    data = ser.dumps({"x": t})
    assert b"cuda" not in data
    back = pickle.loads(data)["x"]
    assert seen == [1]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_own_device_is_the_context_card(monkeypatch):
    import torch

    from ray_tpu_torch.core import context as ctx
    from ray_tpu_torch.core import serialization as ser

    monkeypatch.setattr(ctx, "_context",
                        ctx.WorkerContext("actor", "a" * 32, card=3))
    assert ser.own_device() == torch.device("cuda", 3)
    monkeypatch.setattr(ctx, "_context", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ser.own_device() == torch.device("cpu")
