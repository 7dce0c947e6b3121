"""Threaded actors in the port's core (``ray_tpu_torch.core``): a sync
actor with ``max_concurrency=N`` runs its calls on N threads of its
process (the JAX package's ``ActorMailbox`` threads,
``ray_tpu/core/worker.py:63-104``), and an async actor's sync methods
leave its event loop.

- The mirror of tests/test_collective_lib.py:52: two ``max_concurrency=4``
  actors meet in a collective group, and its five cases run on them.
- Calls overlap on N threads; N = 1 keeps one thread, in order;
  ``exit_actor`` from a call thread retires the actor.
- The slice as a whole, on the CPU: a Llama-shaped tiny config (2 layers)
  behind a ContinuousBatchingEngine in a four-thread actor streams four
  prompts as ``num_returns="streaming"``; the tokens equal the greedy
  tokens of the JAX package's ContinuousBatchingEngine on the same params
  (carried across by ``ray_tpu_torch/convert.py``), exactly, in f32.

Actor processes import this module again, so its top loads neither torch
nor jax.
"""
import asyncio
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt

MAX_PROMPT, MAX_NEW = 16, 8
PROMPTS = ([5, 9, 2], [7, 1, 3, 3, 8, 1], [4], [11, 12, 13, 14, 15, 16, 17])


class Member:
    """tests/test_collective_lib.py's member, on the port's host
    collectives (a gloo group met through a file store)."""

    def __init__(self, world_size, rank, group, store):
        from ray_tpu_torch.util import collective

        self.rank = rank
        self.group = group
        collective.init_collective_group(world_size, rank, "host", group,
                                         store_address=store)

    def do_allreduce(self, x):
        from ray_tpu_torch.util import collective

        return collective.allreduce(np.asarray(x), self.group)

    def do_broadcast(self, x):
        from ray_tpu_torch.util import collective

        payload = np.asarray(x) if self.rank == 0 else None
        return collective.broadcast(payload, 0, self.group)

    def do_allgather(self, x):
        from ray_tpu_torch.util import collective

        return collective.allgather(np.asarray(x), self.group)

    def do_reducescatter(self, x):
        from ray_tpu_torch.util import collective

        return collective.reducescatter(np.asarray(x), self.group)

    def do_sendrecv(self, x):
        from ray_tpu_torch.util import collective

        if self.rank == 0:
            collective.send(np.asarray(x), 1, self.group)
            return None
        return collective.recv(0, self.group)


@rt.remote(max_concurrency=4)
class Sleeper:
    def nap(self, s):
        t0 = time.time()
        time.sleep(s)
        return t0, time.time(), threading.get_ident()

    def quit(self):
        rt.exit_actor()


@rt.remote
class OneThread:
    def __init__(self):
        self.log = []

    def note(self, i):
        time.sleep(0.01 * (i % 3))
        self.log.append(i)
        return threading.get_ident()

    def read(self):
        return list(self.log)


@rt.remote
class AsyncWithSync:
    def __init__(self):
        self.ticks = 0

    async def tick_for(self, s):
        end = time.monotonic() + s
        while time.monotonic() < end:
            self.ticks += 1
            await asyncio.sleep(0.01)
        return self.ticks

    def block(self, s):
        """Sync: blocks its thread, not the loop."""
        try:
            asyncio.get_running_loop()
            on_loop = True
        except RuntimeError:
            on_loop = False
        before = self.ticks
        time.sleep(s)
        return on_loop, self.ticks - before


@rt.remote(max_concurrency=4)
class TinyLlamaStreamer:
    """The slice on the CPU: llama_tiny f32 from numpy params behind a
    4-slot engine ticking on its own thread, 4 call threads."""

    def __init__(self, tree):
        import torch

        from ray_tpu_torch import convert
        from ray_tpu_torch.models.configs import llama_tiny
        from ray_tpu_torch.serve.llm_engine import ContinuousBatchingEngine

        torch.set_num_threads(1)
        cfg = llama_tiny(dtype=torch.float32)
        self.eng = ContinuousBatchingEngine(
            cfg, convert.params_from_numpy(tree, cfg, "cpu"), num_slots=4,
            max_prompt_len=MAX_PROMPT, max_new_tokens=MAX_NEW, device="cpu")
        self.stop = threading.Event()
        threading.Thread(target=self.eng.run_forever, args=(self.stop,),
                         daemon=True).start()
        self.spans = []
        self.max_busy = 0

    def stream_tokens(self, prompt):
        t0 = time.time()
        req = self.eng.submit(prompt, timeout=60)
        sent, done = 0, False
        try:
            while True:
                done = self.eng.is_done(req)
                toks = self.eng.peek(req)
                self.max_busy = max(self.max_busy,
                                    self.eng.stats()["slots_busy"])
                for tok in toks[sent:]:
                    yield tok
                    sent += 1
                if done and sent == len(toks):
                    break
                time.sleep(0.002)
        finally:
            if done:
                self.eng.pop_result(req)
            else:
                self.eng.abort(req)
            self.spans.append((t0, time.time()))

    def report(self):
        return {"spans": list(self.spans), "max_busy": self.max_busy,
                "busy_now": self.eng.stats()["slots_busy"]}


@pytest.fixture(scope="module")
def core():
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


# ----------------------------- tests/test_collective_lib.py:52, its cases


@pytest.fixture(scope="module")
def members(core, tmp_path_factory):
    cls = rt.remote(Member)
    store = "file://" + str(tmp_path_factory.mktemp("grp") / "store")
    ms = [cls.options(max_concurrency=4).remote(2, r, "testgrp", store)
          for r in range(2)]
    # The constructors meet: both exist once one call answers on each.
    rt.get([m.do_allreduce.remote(np.zeros(1)) for m in ms], timeout=120)
    yield ms
    for m in ms:
        rt.kill(m)


def test_allreduce(members):
    out = rt.get([m.do_allreduce.remote(np.full((3,), r + 1.0))
                  for r, m in enumerate(members)], timeout=60)
    for o in out:
        np.testing.assert_allclose(o, np.full((3,), 3.0))


def test_broadcast(members):
    out = rt.get([m.do_broadcast.remote(np.arange(4.0)) for m in members],
                 timeout=60)
    for o in out:
        np.testing.assert_allclose(o, np.arange(4.0))


def test_allgather(members):
    out = rt.get([m.do_allgather.remote(np.full((2,), float(r)))
                  for r, m in enumerate(members)], timeout=60)
    for o in out:
        assert len(o) == 2
        np.testing.assert_allclose(o[0], [0.0, 0.0])
        np.testing.assert_allclose(o[1], [1.0, 1.0])


def test_reducescatter(members):
    out = rt.get([m.do_reducescatter.remote(np.ones((4,)))
                  for m in members], timeout=60)
    np.testing.assert_allclose(out[0], [2.0, 2.0])
    np.testing.assert_allclose(out[1], [2.0, 2.0])


def test_send_recv(members):
    out = rt.get([m.do_sendrecv.remote(np.array([7.0, 8.0]))
                  for m in members], timeout=60)
    np.testing.assert_allclose(out[1], [7.0, 8.0])


# ----------------------------------------------------- the call threads


def test_calls_overlap_on_max_concurrency_threads(core):
    s = Sleeper.remote()
    rt.get(s.nap.remote(0), timeout=60)
    t0 = time.perf_counter()
    out = rt.get([s.nap.remote(0.6) for _ in range(4)], timeout=60)
    wall = time.perf_counter() - t0
    assert wall < 1.5, f"four 0.6 s calls took {wall:.2f} s: not threaded"
    assert len({ident for _, _, ident in out}) == 4
    assert max(a for a, _, _ in out) < min(b for _, b, _ in out)  # overlap
    rt.kill(s)


def test_one_thread_keeps_the_order(core):
    a = OneThread.remote()
    idents = rt.get([a.note.remote(i) for i in range(12)], timeout=60)
    assert len(set(idents)) == 1
    assert rt.get(a.read.remote(), timeout=60) == list(range(12))
    rt.kill(a)


def test_exit_actor_from_a_call_thread(core):
    s = Sleeper.remote()
    assert rt.get(s.quit.remote(), timeout=60) is None
    with pytest.raises(rt.ActorDiedError):
        rt.get(s.nap.remote(0), timeout=30)


def test_sync_method_of_an_async_actor_runs_off_the_loop(core):
    """The loop's coroutine goes on while the sync method blocks."""
    a = AsyncWithSync.remote()
    ticking = a.tick_for.remote(1.0)
    time.sleep(0.2)
    on_loop, ticks_meanwhile = rt.get(a.block.remote(0.4), timeout=30)
    assert on_loop is False
    assert ticks_meanwhile > 5, ticks_meanwhile
    assert rt.get(ticking, timeout=30) > 0
    rt.kill(a)


# ------------------------------------------------- the slice on the CPU


def test_four_streams_on_four_threads_match_the_jax_engine(core):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm
    from ray_tpu.models.configs import llama_tiny as jllama_tiny
    from ray_tpu.serve.llm_engine import ContinuousBatchingEngine as JEngine

    jcfg = jllama_tiny(remat=False, dtype=jnp.float32)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    a = TinyLlamaStreamer.remote(tree)
    gens = [a.stream_tokens.options(num_returns="streaming").remote(p)
            for p in PROMPTS]
    # The JAX engine's greedy tokens, one prompt at a time, meanwhile.
    ref = JEngine(jcfg, jparams, num_slots=1, max_prompt_len=MAX_PROMPT,
                  max_new_tokens=MAX_NEW)
    want = []
    for p in PROMPTS:
        r = ref.submit(p, max_new_tokens=MAX_NEW)
        while ref.tick():
            pass
        want.append(ref.pop_result(r))
    got = [[] for _ in PROMPTS]
    live = list(range(len(PROMPTS)))
    while live:  # round-robin over the four streams
        for i in list(live):
            try:
                got[i].append(rt.get(next(gens[i]), timeout=120))
            except StopIteration:
                live.remove(i)
    assert got == want
    rep = rt.get(a.report.remote(), timeout=60)
    spans = rep["spans"]
    assert len(spans) == 4
    assert max(s for s, _ in spans) < min(e for _, e in spans)  # overlap
    assert rep["max_busy"] == 4 and rep["busy_now"] == 0
    rt.kill(a)
