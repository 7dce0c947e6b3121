"""Durable workflows of the port (``ray_tpu_torch.workflow``) held to the
JAX package's (``ray_tpu.workflow``): every case of
tests/test_dag_workflow.py:136-290, each DAG run through both packages
with the outputs, ``assign_step_ids``, the ``steps/*.json`` states and
the sequence of ``events.jsonl`` events held equal; the RESUMABLE status
of a stale heartbeat, a cancel between waves and the storage roots; and
the whole slice: a workflow of ``generate`` steps on an actor holding
llama_tiny (the JAX package's params, carried across by ``convert.py``)
whose driver, a process of its own, is killed by SIGKILL after its second
checkpoint, then resumed here, its output the JAX package's greedy
tokens.

Divergence by design: the JAX tests' nested functions and lambdas are
module-level plain functions here, wrapped by each package's ``remote``
where used (the port sends functions by reference). Task workers and
actors of both packages import this module again, so its top loads
neither torch nor jax.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.workflow import storage as port_storage
from ray_tpu_torch.workflow.executor import assign_step_ids

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


# ------------------------------------------- the steps, for both packages


def add(a, b):
    return a + b


def double(x):
    return 2 * x


def step_a(marker):
    with open(marker, "a") as f:  # counts the runs of the finished step
        f.write("a")
    return 5


def step_b(x, allow):
    if not os.path.exists(allow):
        raise RuntimeError("injected failure")
    return x * 10


def fib(a, b, n, pkg):
    if n == 0:
        return a
    return remote_of(pkg)(fib).bind(b, a + b, n - 1, pkg)


def boom():
    raise ValueError("expected")


def slow(x):
    time.sleep(1.0)
    return x


def split(x):
    return x, x + 1


def wait_file(path, x):
    deadline = time.monotonic() + 30
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.02)
    return x


def remote_of(pkg):
    """The ``remote`` of the JAX package ("jax") or of the port."""
    if pkg == "jax":
        import ray_tpu

        return ray_tpu.remote
    return rt.remote


def pkg_workflow(pkg):
    if pkg == "jax":
        from ray_tpu import workflow as jwf

        return jwf
    return workflow


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def core():
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def jax_core():
    """The JAX package's cluster, its four workers warm: its executor
    ends a run whose last step takes more than one second
    (``ray_tpu/workflow/executor.py:98``), which a worker's spawn can."""
    import ray_tpu

    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    ray_tpu.get([ray_tpu.remote(slow).remote(i) for i in range(4)])
    try:
        yield
    finally:
        ray_tpu.shutdown()


@pytest.fixture
def both(core, jax_core, tmp_path):
    """(pkg, remote, workflow, storage dir) for each package."""
    out = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        out.append((pkg, remote_of(pkg), pkg_workflow(pkg), str(d)))
    return out


def record(store, wid):
    """What a run left on disk: its status, each step's state and the
    (event, step) sequence of its log."""
    d = os.path.join(store, wid)
    steps = {}
    for name in sorted(os.listdir(os.path.join(d, "steps"))):
        if name.endswith(".json"):
            with open(os.path.join(d, "steps", name)) as f:
                steps[name[:-5]] = json.load(f)["state"]
    events = []
    if os.path.exists(os.path.join(d, "events.jsonl")):
        with open(os.path.join(d, "events.jsonl")) as f:
            events = [(e["event"], e.get("step"))
                      for e in map(json.loads, f)]
    with open(os.path.join(d, "workflow.json")) as f:
        status = json.load(f)["status"]
    return {"status": status, "steps": steps, "events": events}


def ids_in_order(dag, ids):
    return [ids[id(n)] for n in dag.topological()]


# ------------------------------------------------------------------ cases


def test_workflow_run_and_output(both):
    got = {}
    for pkg, remote, wf, store in both:
        dag = remote(add).bind(remote(double).bind(3), 4)
        assert wf.run(dag, workflow_id="wf1", storage=store) == 10
        assert wf.get_status("wf1", storage=store) == "SUCCESSFUL"
        assert wf.get_output("wf1", storage=store) == 10
        assert [r["workflow_id"] for r in wf.list_all(storage=store)] == [
            "wf1"]
        got[pkg] = record(store, "wf1")
    assert got["port"] == got["jax"]
    assert got["port"]["steps"] == {"add.0": "SUCCESSFUL",
                                    "double.0": "SUCCESSFUL",
                                    "__output__": "SUCCESSFUL"}


def test_workflow_resume_skips_completed_steps(both, tmp_path):
    """The run fails at step_b; resume runs only step_b again."""
    got = {}
    for pkg, remote, wf, store in both:
        marker, allow = os.path.join(store, "ran"), os.path.join(store,
                                                                 "allow")
        dag = remote(step_b).bind(remote(step_a).bind(marker), allow)
        with pytest.raises(Exception, match="injected failure"):
            wf.run(dag, workflow_id="wf2", storage=store)
        assert wf.get_status("wf2", storage=store) == "FAILED"
        assert open(marker).read() == "a"
        failed = record(store, "wf2")
        open(allow, "w").close()
        assert wf.resume("wf2", storage=store) == 50
        assert open(marker).read() == "a"
        assert wf.get_status("wf2", storage=store) == "SUCCESSFUL"
        got[pkg] = failed, record(store, "wf2")
    assert got["port"] == got["jax"]


def test_workflow_continuation(both):
    got = {}
    for pkg, remote, wf, store in both:
        out = wf.run(remote(fib).bind(0, 1, 8, pkg), workflow_id="fib",
                     storage=store)
        assert out == 21
        got[pkg] = record(store, "fib")
        sub = os.path.join(store, "fib", "steps", "fib.0.sub", "steps")
        got[pkg]["sub"] = sorted(os.listdir(sub))
    assert got["port"] == got["jax"]


def test_workflow_catch_exceptions(both):
    got = {}
    for pkg, remote, wf, store in both:
        dag = remote(boom).options(catch_exceptions=True).bind()
        result, err = wf.run(dag, workflow_id="wfc", storage=store)
        assert result is None
        assert isinstance(err, Exception) and "expected" in str(err)
        assert wf.get_status("wfc", storage=store) == "SUCCESSFUL"
        got[pkg] = record(store, "wfc")
    assert got["port"] == got["jax"]


def test_workflow_parallel_branches(core, tmp_path):
    """Independent branches are in flight together (wave submission)."""
    rslow, radd = rt.remote(slow), rt.remote(add)
    dag = radd.bind(rslow.bind(1), rslow.bind(2))
    rt.get([rslow.remote(0), rslow.remote(0)])  # two warm workers
    t0 = time.perf_counter()
    assert workflow.run(dag, storage=str(tmp_path)) == 3
    wall = time.perf_counter() - t0
    assert wall < 2.0, f"branches ran one after the other: {wall:.2f} s"


def test_workflow_multi_return_step(both):
    got = {}
    for pkg, remote, wf, store in both:
        pair = remote(num_returns=2)(split).bind(10)
        result = wf.run(remote(add).bind(pair, [100, 100]),
                        workflow_id="mr", storage=store)
        assert list(result) == [10, 11, 100, 100]
        got[pkg] = record(store, "mr")
    assert got["port"] == got["jax"]


def test_remote_function_deepcopy_without_session():
    """A remote function inside a config survives copy.deepcopy, with its
    options."""
    import copy

    f = rt.remote(add).options(num_returns=1, max_retries=2)
    g = copy.deepcopy({"fn": f})["fn"]
    assert isinstance(g, rt.RemoteFunction)
    assert g._options == f._options


def test_workflow_delete_and_async(both):
    for pkg, remote, wf, store in both:
        fut = wf.run_async(remote(double).bind(21), workflow_id="wfa",
                           storage=store)
        assert fut.result(timeout=30) == 42
        wf.delete("wfa", storage=store)
        assert wf.list_all(storage=store) == []


def test_input_node_mixed_args_kwargs_raises(core):
    with InputNode() as inp:
        dag = rt.remote(double).bind(inp)
    with pytest.raises(Exception, match="positional and keyword"):
        rt.get(dag.execute(1, y=2))


def test_workflow_run_refuses_reused_id(both):
    for pkg, remote, wf, store in both:
        assert wf.run(remote(add).bind(1, 2), workflow_id="wreuse",
                      storage=store) == 3
        with pytest.raises(ValueError, match="already exists"):
            wf.run(remote(add).bind(5, 6), workflow_id="wreuse",
                   storage=store)
        assert wf.resume("wreuse", storage=store) == 3
        wf.delete("wreuse", storage=store)
        assert wf.run(remote(add).bind(5, 6), workflow_id="wreuse",
                      storage=store) == 11


def test_workflow_reads_do_not_create_dirs(tmp_path):
    from ray_tpu.workflow import storage as jax_storage

    for mod, wf in ((jax_storage, pkg_workflow("jax")),
                    (port_storage, workflow)):
        st = mod.WorkflowStorage("no-such-wf", str(tmp_path))
        assert st.get_meta() == {}
        assert not st.has_dag()
        assert wf.get_status("no-such-wf", storage=str(tmp_path)) == (
            "UNKNOWN")
        assert not os.path.exists(os.path.join(str(tmp_path),
                                               "no-such-wf"))


# ------------------------------------------------- beyond the JAX cases


def _graphs(remote):
    """DAGs with functions, an actor, input selectors and several
    outputs, built with one package's ``remote`` and ``.bind()``."""
    if remote is rt.remote:
        Input, Multi = InputNode, MultiOutputNode
    else:
        from ray_tpu.dag import InputNode as Input
        from ray_tpu.dag import MultiOutputNode as Multi
    a, d = remote(add), remote(double)
    yield a.bind(d.bind(3), d.bind(a.bind(1, 2)))
    with Input() as inp:
        base = d.bind(inp[0])
        yield Multi([a.bind(base, inp[1]), d.bind(base), a.bind(base, 1)])
    counter = remote(Counter).bind(10)
    yield a.bind(counter.inc.bind(1), counter.inc.bind(d.bind(2)))


class Counter:
    def __init__(self, start):
        self.n = start

    def inc(self, k):
        self.n += k
        return self.n


def test_assign_step_ids_equal_the_jax_package():
    from ray_tpu.workflow.executor import assign_step_ids as jax_ids

    import ray_tpu

    for port_dag, jax_dag in zip(_graphs(rt.remote),
                                 _graphs(ray_tpu.remote)):
        assert ids_in_order(port_dag, assign_step_ids(port_dag)) == (
            ids_in_order(jax_dag, jax_ids(jax_dag)))


def test_actor_steps_through_both(both):
    """A DAG over an actor's methods: outputs, states and events equal."""
    got = {}
    for pkg, remote, wf, store in both:
        dag = list(_graphs(remote))[2]
        assert wf.run(dag, workflow_id="actor", storage=store) == 11 + 15
        got[pkg] = record(store, "actor")
        # Two steps of one wave may finish in either order.
        got[pkg]["events"] = sorted(got[pkg]["events"])
    assert got["port"] == got["jax"]


def test_stale_heartbeat_reads_resumable(tmp_path):
    """A RUNNING run whose owner's heartbeat is older than LIVENESS_S is
    RESUMABLE in both packages (list_all too); a fresh one is RUNNING."""
    from ray_tpu.workflow import storage as jax_storage

    for mod, wf in ((jax_storage, pkg_workflow("jax")),
                    (port_storage, workflow)):
        root = tmp_path / mod.__name__.split(".")[0]
        st = mod.WorkflowStorage("w", str(root))
        st.set_status("RUNNING")
        st.touch_owner()
        assert wf.get_status("w", storage=str(root)) == "RUNNING"
        with open(st._owner_path(), "w") as f:
            json.dump({"pid": 1, "ts": time.time() - st.LIVENESS_S - 1}, f)
        assert wf.get_status("w", storage=str(root)) == "RESUMABLE"
        assert [r["status"] for r in wf.list_all(storage=str(root))] == [
            "RESUMABLE"]
    assert (port_storage.WorkflowStorage.HEARTBEAT_S,
            port_storage.WorkflowStorage.LIVENESS_S) == (
        jax_storage.WorkflowStorage.HEARTBEAT_S,
        jax_storage.WorkflowStorage.LIVENESS_S)


def test_cancel_between_waves(both):
    """cancel() from another thread stops the run before its next wave:
    CANCELED, the later step never started."""
    import threading

    got = {}
    for pkg, remote, wf, store in both:
        gate = os.path.join(store, "gate")
        dag = remote(double).bind(remote(wait_file).bind(gate, 4))
        fut = wf.run_async(dag, workflow_id="wcancel", storage=store)
        deadline = time.monotonic() + 30
        while not os.path.exists(os.path.join(store, "wcancel",
                                              "events.jsonl")):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        wf.cancel("wcancel", storage=store)
        threading.Timer(0.2, lambda g=gate: open(g, "w").close()).start()
        with pytest.raises(Exception):
            fut.result(timeout=30)
        assert wf.get_status("wcancel", storage=store) == "CANCELED"
        got[pkg] = record(store, "wcancel")
    assert got["port"] == got["jax"]
    assert ("step_started", "double.0") not in got["port"]["events"]


def test_last_step_longer_than_the_wave_wait(core, tmp_path):
    """A divergence by design: the run waits for a last step that takes
    more than the executor's one-second wait (the JAX package's loop ends
    there and raises KeyError, ``ray_tpu/workflow/executor.py:98``)."""
    dag = rt.remote(slow).bind(rt.remote(slow).bind(7))
    assert workflow.run(dag, workflow_id="long", storage=str(tmp_path)) == 7
    assert record(str(tmp_path), "long")["events"] == [
        ("step_started", "slow.0"), ("step_finished", "slow.0"),
        ("step_started", "slow.1"), ("step_finished", "slow.1")]


def test_storage_roots_are_each_packages_own(monkeypatch, tmp_path):
    from ray_tpu.workflow import storage as jax_storage

    monkeypatch.delenv("RTPU_WORKFLOW_STORAGE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert port_storage.default_storage_root() == str(
        tmp_path / ".ray_tpu_torch" / "workflows")
    assert jax_storage.default_storage_root() == str(
        tmp_path / ".ray_tpu" / "workflows")
    monkeypatch.setenv("RTPU_WORKFLOW_STORAGE", str(tmp_path / "x"))
    assert port_storage.default_storage_root() == str(tmp_path / "x")


# ------------------------------------------------------- the whole slice

NEW_TOKENS = 8
PROMPTS = 4
PROMPT_LEN = 6
STEP_DELAY_S = 0.6


def port_cfg():
    import torch

    from ray_tpu_torch.models.configs import llama_tiny

    return llama_tiny(dtype=torch.float32)


class TinyGen:
    """An actor holding llama_tiny (the JAX package's params from an
    .npz) that appends ``(i, pid)`` to a marker file at each generate
    and returns its greedy tokens."""

    def __init__(self, npz, marker, delay_s):
        import torch

        from ray_tpu_torch import convert

        torch.set_num_threads(1)
        tree = {"layers": {}}
        with np.load(npz) as z:
            for k in z.files:
                if k.startswith("layers/"):
                    tree["layers"][k[len("layers/"):]] = z[k]
                else:
                    tree[k] = z[k]
        self.cfg = port_cfg()
        self.params = convert.params_from_numpy(tree, self.cfg, "cpu")
        self.marker, self.delay_s = marker, delay_s

    def generate(self, i, prompt):
        import torch

        from ray_tpu_torch.models import generate as tgen

        with open(self.marker, "a") as f:
            f.write(f"{i} {os.getpid()}\n")
        time.sleep(self.delay_s)
        out = tgen.generate(self.params, torch.tensor([prompt]), self.cfg,
                            NEW_TOKENS)
        return out[0, len(prompt):].tolist()


def collect(*outs):
    return list(outs)


def slice_dag(npz, marker, prompts, delay_s):
    w = rt.remote(TinyGen).bind(npz, marker, delay_s)
    return rt.remote(collect).bind(
        *[w.generate.bind(i, p) for i, p in enumerate(prompts)])


_DRIVER = r"""
import sys
sys.path[:0] = [{here!r}, {repo!r}]
import ray_tpu_torch as rt
import test_torch_workflow as m

if __name__ == "__main__":
    rt.init(num_cpus=2)
    dag = m.slice_dag({npz!r}, {marker!r}, {prompts!r}, {delay!r})
    rt.workflow.run(dag, workflow_id="slice", storage={store!r})
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """llama_tiny (f32, key 0) in an .npz, the prompts, and the JAX
    package's greedy tokens for each."""
    import importlib

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import configs as jconfigs
    from ray_tpu.models import transformer as jtfm

    jgen = importlib.import_module("ray_tpu.models.generate")
    jcfg = jconfigs.llama_tiny(remat=False, dtype=jnp.float32)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    flat = {}
    for k, v in jparams.items():
        if k == "layers":
            flat.update({f"layers/{n}": np.asarray(w) for n, w in v.items()})
        else:
            flat[k] = np.asarray(v)
    path = str(tmp_path_factory.mktemp("wf-slice") / "llama_tiny.npz")
    np.savez(path, **flat)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab_size,
                           (PROMPTS, PROMPT_LEN)).tolist()
    toks = np.asarray(jgen.generate(jparams, jnp.asarray(prompts, jnp.int32),
                                    jcfg, NEW_TOKENS))
    return path, prompts, toks[:, PROMPT_LEN:].tolist()


def _generate_steps(store):
    d = os.path.join(store, "slice", "steps")
    if not os.path.isdir(d):
        return set()
    done = set()
    for name in os.listdir(d):
        if name.startswith("generate.") and name.endswith(".json"):
            try:
                with open(os.path.join(d, name)) as f:
                    if json.load(f)["state"] == "SUCCESSFUL":
                        done.add(name[:-5])
            except (OSError, ValueError):
                pass  # a write in flight
    return done


def test_slice_driver_killed_and_resumed(core, tiny, tmp_path, monkeypatch):
    """A child driver runs the generate workflow and is SIGKILLed after
    its second checkpoint; its actor leaves, the run reads RESUMABLE, and
    resume here returns the JAX package's greedy tokens, each step
    checkpointed before the kill run exactly once."""
    npz, prompts, want = tiny
    store, marker = str(tmp_path / "store"), str(tmp_path / "marker")
    script = tmp_path / "driver.py"
    script.write_text(_DRIVER.format(here=HERE, repo=REPO, npz=npz,
                                     marker=marker, prompts=prompts,
                                     delay=STEP_DELAY_S, store=store))
    (tmp_path / "tmp").mkdir()  # the killed driver's core directory
    child = subprocess.Popen([sys.executable, str(script)],
                             cwd=str(tmp_path), stderr=subprocess.PIPE,
                             env={**os.environ,
                                  "TMPDIR": str(tmp_path / "tmp")})
    try:
        deadline = time.monotonic() + 60
        while len(_generate_steps(store)) < 2:
            assert child.poll() is None, child.stderr.read()[-3000:]
            assert time.monotonic() < deadline, "no second checkpoint"
            time.sleep(0.02)
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=10)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    done = _generate_steps(store)
    assert 2 <= len(done) < PROMPTS
    # The driver's actor sees its pipe close and leaves.
    ran = [line.split() for line in open(marker).read().splitlines()]
    actor_pid = int(ran[0][1])
    deadline = time.monotonic() + 10
    while os.path.exists(f"/proc/{actor_pid}") and (
            open(f"/proc/{actor_pid}/stat").read().rsplit(")", 1)[1].split()[0]
            != "Z"):
        assert time.monotonic() < deadline, "the actor outlived its driver"
        time.sleep(0.05)
    monkeypatch.setattr(port_storage.WorkflowStorage, "LIVENESS_S", 3.0)
    deadline = time.monotonic() + 10
    while workflow.get_status("slice", storage=store) != "RESUMABLE":
        assert time.monotonic() < deadline, "never RESUMABLE"
        time.sleep(0.1)
    out = workflow.resume("slice", storage=store)
    assert out == want
    assert workflow.get_status("slice", storage=store) == "SUCCESSFUL"
    runs = {}
    for i, _ in ([int(a), b] for a, b in (line.split() for line in
                                          open(marker).read().splitlines())):
        runs[i] = runs.get(i, 0) + 1
    for i in range(PROMPTS):
        if f"generate.{i}" in done:
            assert runs[i] == 1, (i, runs)
        else:
            assert 1 <= runs[i] <= 2, (i, runs)
