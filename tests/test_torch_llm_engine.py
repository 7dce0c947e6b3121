"""The port's continuous-batching engine (ray_tpu_torch/serve/llm_engine.py),
the mirror of tests/test_llm_engine.py's non-cluster tests.

Requests that join a RUNNING batch must produce exactly the tokens of
isolated greedy generation by the JAX package (token-exact; both sides run
``dtype=float32`` on the same params, carried across through numpy).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu.models.configs import llama_tiny as jllama_tiny
from ray_tpu.serve.llm_engine import ContinuousBatchingEngine as JEngine
from ray_tpu_torch import convert
from ray_tpu_torch.models.configs import llama_tiny as tllama_tiny
from ray_tpu_torch.serve import llm_engine as tengine
from ray_tpu_torch.serve.llm_engine import ContinuousBatchingEngine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama_tiny(remat=False, dtype=jnp.float32)
    tcfg = tllama_tiny(dtype=torch.float32)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    # Isolated JAX greedy generation: one request at a time through the
    # JAX engine (the JAX suite holds it to the naive re-run forward).
    ref_eng = JEngine(jcfg, jparams, num_slots=1, max_prompt_len=16,
                      max_new_tokens=8)
    memo = {}

    def isolated(prompt, n, eos=None):
        key = (tuple(prompt), n, eos)
        if key not in memo:
            r = ref_eng.submit(prompt, max_new_tokens=n, eos_id=eos)
            while ref_eng.tick():
                pass
            memo[key] = ref_eng.pop_result(r)
        return memo[key]

    return jcfg, tcfg, jparams, tparams, isolated


def _engine(setup, **kw):
    return ContinuousBatchingEngine(setup[1], setup[3], device="cpu", **kw)


def _drain(eng):
    while eng.tick():
        pass


def test_interleaved_requests_match_isolated(setup):
    isolated = setup[4]
    eng = _engine(setup, num_slots=3, max_prompt_len=16, max_new_tokens=6)
    # A starts alone; B and C attach after A has already emitted tokens.
    a = eng.submit([5, 9, 2], max_new_tokens=6)
    eng.tick(); eng.tick()
    b = eng.submit([7, 1, 3, 3, 8, 1], max_new_tokens=4)
    eng.tick()
    c = eng.submit([4], max_new_tokens=3)
    _drain(eng)
    for req, prompt, n in ((a, [5, 9, 2], 6), (b, [7, 1, 3, 3, 8, 1], 4),
                           (c, [4], 3)):
        assert eng.result(req, timeout=60) == isolated(prompt, n), prompt


def test_slot_reuse_after_retirement(setup):
    isolated = setup[4]
    eng = _engine(setup, num_slots=1, max_prompt_len=16, max_new_tokens=4)
    s1 = eng.submit([5, 9, 2], max_new_tokens=2)
    _drain(eng)
    r1 = eng.result(s1, timeout=60)
    s2 = eng.submit([7, 7, 7, 7], max_new_tokens=3)
    assert s2 != s1
    _drain(eng)
    assert eng.result(s2, timeout=60) == isolated([7, 7, 7, 7], 3)
    assert r1 == isolated([5, 9, 2], 2)


def test_eos_retires_early(setup):
    isolated = setup[4]
    probe = isolated([5, 9, 2], 4)
    eos = probe[1]
    eng = _engine(setup, num_slots=2, max_prompt_len=16, max_new_tokens=4)
    s = eng.submit([5, 9, 2], eos_id=eos)
    _drain(eng)
    assert eng.result(s, timeout=60) == probe[:2]


def test_background_thread_and_blocking_submit(setup):
    isolated = setup[4]
    eng = _engine(setup, num_slots=2, max_prompt_len=16, max_new_tokens=3)
    stop = threading.Event()
    t = threading.Thread(target=eng.run_forever, args=(stop,), daemon=True)
    t.start()
    try:
        prompts = [[5, 9, 2], [7, 1, 3], [4, 4], [8, 8, 8, 8]]
        reqs = [eng.submit(p, timeout=120) for p in prompts]  # 3rd blocks
        for p, r in zip(prompts, reqs):
            assert eng.result(r, timeout=120) == isolated(p, 3)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()


def test_concurrent_submitters_against_the_ticker(setup):
    """Stress: more submitter threads than slots (and than cores), a short
    thread switch interval, the ticker on its own thread. Every request gets
    a distinct id and exactly its isolated greedy stream, and the engine
    ends with every slot free and no request state left behind."""
    import sys

    isolated = setup[4]
    eng = _engine(setup, num_slots=2, max_prompt_len=16, max_new_tokens=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, setup[1].vocab_size, int(n)).tolist()
               for n in rng.integers(1, 10, 12)]
    refs = [isolated(p, 3) for p in prompts]
    got = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            r = eng.submit(prompts[i], timeout=120)
            got[i] = (r, eng.pop_result(r))
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, e))

    stop = threading.Event()
    ticker = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ticker.start()
        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
    finally:
        sys.setswitchinterval(old)
        stop.set()
        ticker.join(timeout=30)
    assert not ticker.is_alive() and eng.failed is None
    assert not errors, errors
    assert len({r for r, _ in got}) == len(prompts)
    assert [out for _, out in got] == refs
    assert sorted(eng._free) == [0, 1] and not any(eng.active)
    assert not eng._results and not eng._done_ev and not eng._req_slot


def test_ticker_lets_blocked_lock_takers_in(setup):
    """A running ticker re-takes the engine lock right after each tick;
    Python's locks are not fair, so without the engine's yield a poller and
    a submitter's splice wait until the running request retires. Both must
    get in within a few ticks of a 64-token request.

    Only the ticks that run while the taker is blocked on the lock count:
    the test holds the lock until the taker (a ``peek``, then the splice of
    a ``submit`` whose prefill has already run outside the lock) and the
    ticker are both blocked on it, then lets go. Ticks of a prefill or of a
    poll's sleep are not counted, so the bound does not depend on the
    host's load."""
    eng = _engine(setup, num_slots=2, max_prompt_len=16, max_new_tokens=64)
    ticks, blocked_ticks = [0], [0]
    step = eng._tick

    def counted_step(*args):
        # Runs under the engine lock: a blocked count here is the taker's.
        ticks[0] += 1
        if eng.lock.blocked:
            blocked_ticks[0] += 1
        return step(*args)

    eng._tick = counted_step
    stop = threading.Event()
    ticker = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    ticker.start()

    def ticks_while_blocked(take):
        """Take the lock (this thread is a blocked taker too), start
        ``take`` on a thread, wait until it and the ticker are both blocked
        on the lock, let go. Returns the ticks that ran while this thread
        waited for the lock, those that ran while ``take`` did, and what
        ``take`` returned."""
        out = []
        blocked_ticks[0] = 0
        with eng.lock:
            held = blocked_ticks[0]
            taker = threading.Thread(target=lambda: out.append(take()),
                                     daemon=True)
            taker.start()
            deadline = time.monotonic() + 60
            while eng.lock.blocked < 2:
                assert time.monotonic() < deadline, eng.lock.blocked
                time.sleep(1e-3)
            blocked_ticks[0] = 0
        taker.join(timeout=120)
        assert not taker.is_alive() and len(out) == 1
        return held, blocked_ticks[0], out[0]

    try:
        a = eng.submit([5, 9, 2])
        while ticks[0] < 3:  # read without the lock: the ticker is running
            time.sleep(1e-3)
        for trial in range(3):
            held, n, seen = ticks_while_blocked(lambda: eng.peek(a))
            assert held <= 3 and n <= 3, ("peek", trial, held, n)
            assert len(seen) < 64, ("a retired first", trial, len(seen))
        held, n, b = ticks_while_blocked(lambda: eng.submit([7, 1, 3],
                                                            timeout=120))
        assert held <= 3 and n <= 3, ("splice", held, n)
        assert len(eng.result(a, timeout=120)) == 64
        assert len(eng.result(b, timeout=120)) == 64
    finally:
        stop.set()
        ticker.join(timeout=30)
    assert not ticker.is_alive() and eng.failed is None


def test_discard_releases_state_and_ticker_failure_surfaces(setup):
    isolated = setup[4]
    eng = _engine(setup, num_slots=1, max_prompt_len=16, max_new_tokens=4)
    r = eng.submit([5, 9, 2])
    eng.discard(r)
    eng.tick()
    assert not eng._results and r not in eng._req_slot
    r2 = eng.submit([7, 7], max_new_tokens=2)
    _drain(eng)
    assert eng.result(r2, timeout=60) == isolated([7, 7], 2)
    eng.pop_result(r2)
    assert not eng._results and not eng._done_ev

    # Ticker failure: waiters wake and result() raises instead of hanging.
    r3 = eng.submit([5, 9, 2])
    stop = threading.Event()
    eng._tick = lambda *a: (_ for _ in ()).throw(RuntimeError("device lost"))
    t = threading.Thread(target=eng.run_forever, args=(stop,), daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and eng.failed is not None
    with pytest.raises(RuntimeError, match="engine failed"):
        eng.result(r3, timeout=5)
    with pytest.raises(RuntimeError, match="engine failed"):
        eng.submit([1, 2], timeout=5)


def test_ticker_interrupt_wakes_waiters_and_propagates(setup):
    """An interrupt in the tick loop is recorded for the waiters like any
    failure, and still ends the loop by propagating."""
    eng = _engine(setup, num_slots=1, max_prompt_len=16, max_new_tokens=4)
    r = eng.submit([5, 9, 2])
    eng._tick = lambda *a: (_ for _ in ()).throw(KeyboardInterrupt())
    with pytest.raises(KeyboardInterrupt):
        eng.run_forever(threading.Event())
    assert isinstance(eng.failed, KeyboardInterrupt)
    with pytest.raises(RuntimeError, match="generation engine failed"):
        eng.result(r, timeout=5)


def test_abort_frees_slot_between_steps(setup):
    isolated = setup[4]
    eng = _engine(setup, num_slots=1, max_prompt_len=16, max_new_tokens=8)
    r1 = eng.submit([5, 9, 2])
    eng.tick()
    assert eng.abort(r1) is True
    assert r1 not in eng._req_slot and r1 not in eng._done_ev \
        and not eng._results
    assert eng.token_stats(r1)["abort_cause"] == "aborted"
    r2 = eng.submit([7, 7], max_new_tokens=2, timeout=0.5)
    assert eng.abort(r1) is False
    _drain(eng)
    assert eng.result(r2, timeout=60) == isolated([7, 7], 2)
    assert eng.abort(r2) is True
    assert not eng._results and not eng._done_ev
    assert eng.abort(r2) is False


def test_sampled_slots_vary_and_respect_budget(setup):
    outs = []
    for seed in (1, 2, 1):
        eng = _engine(setup, num_slots=2, max_prompt_len=16,
                      max_new_tokens=5, seed=seed)
        r = eng.submit([5, 9, 2], temperature=1.1)
        _drain(eng)
        outs.append(eng.result(r, timeout=60))
    assert all(len(o) == 5 for o in outs)
    assert all(0 <= t < setup[1].vocab_size for o in outs for t in o)
    assert outs[0] == outs[2], "one seed must give one stream"
    assert outs[0] != outs[1], "different seeds sampled identical streams"


def test_attach_prefilled_matches_submit(setup):
    """prefill_only on one engine -> attach_prefilled on another replays the
    exact greedy stream of a unified submit(). The handoff blob holds CPU
    tensors; numpy arrays are accepted too."""
    isolated = setup[4]
    prefiller = _engine(setup, num_slots=1, max_prompt_len=16,
                        max_new_tokens=6)
    decoder = _engine(setup, num_slots=2, max_prompt_len=16,
                      max_new_tokens=6)
    for prompt in ([5, 9, 2], [7, 1, 3, 3, 8, 1, 2, 2, 4]):
        r_ref = decoder.submit(prompt, max_new_tokens=6)
        _drain(decoder)
        ref = decoder.result(r_ref, timeout=60)
        decoder.discard(r_ref)

        k, v, length, logits = prefiller.prefill_only(prompt)
        assert length == len(prompt)
        assert isinstance(k, torch.Tensor) and k.device.type == "cpu"
        assert k.shape == (2, 8 if len(prompt) <= 8 else 16, 2, 32)
        got = []
        for blob in ((k, v, logits), (k.numpy(), v.numpy(), logits.numpy())):
            r = decoder.attach_prefilled(blob[0], blob[1], length, blob[2],
                                         max_new_tokens=6)
            _drain(decoder)
            got.append(decoder.result(r, timeout=60))
            decoder.discard(r)
        assert got[0] == got[1] == ref == isolated(prompt, 6), prompt


def test_attach_prefilled_validates_shapes(setup):
    eng = _engine(setup, num_slots=1, max_prompt_len=16, max_new_tokens=4)
    k, v, length, logits = eng.prefill_only([5, 9, 2])
    with pytest.raises(ValueError):
        eng.attach_prefilled(k[0], v, length, logits)  # ndim != 4
    with pytest.raises(ValueError):
        eng.attach_prefilled(k, v, 0, logits)  # empty prefix
    with pytest.raises(ValueError):
        eng.attach_prefilled(k, v, k.shape[1] + 1, logits)  # length > S


def test_idle_slots_tick_past_max_len(setup):
    """Long-lived engine under light traffic: the LIFO free list gives every
    request the same slot while the idle slots keep ticking, so their pos
    runs past max_len. The writes clamp (no error) and the outputs stay
    token-exact against the JAX engine driven the same way."""
    jcfg, tcfg, jparams, tparams, _ = setup
    kw = dict(num_slots=3, max_prompt_len=8, max_new_tokens=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (3, 5, 8, 2, 7, 4, 6, 1)]
    engines = (JEngine(jcfg, jparams, **kw),
               ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw))
    outs = []
    for eng in engines:
        got = []
        for p in prompts:
            r = eng.submit(p)
            _drain(eng)
            got.append(eng.pop_result(r))
        outs.append(got)
    assert outs[0] == outs[1]
    jpos = np.asarray(engines[0].cache.pos).tolist()
    tpos = engines[1].cache.pos.tolist()
    # 8 requests x 3 ticks each: the idle slots advance 24 times; the busy
    # slot holds the last prompt plus its 3 decoded tokens.
    assert tpos == jpos == [24, 24, len(prompts[-1]) + 3]
    assert max(tpos) > engines[1].max_len == 12


def test_token_timeline_and_stats(setup):
    eng = _engine(setup, num_slots=2, max_prompt_len=16, max_new_tokens=4)
    r = eng.submit([5, 9, 2])
    eng.tick()
    live = eng.token_stats(r)
    assert live["tokens"] == 2 and live["abort_cause"] == ""
    assert eng.last_token_age(r) >= 0.0
    assert eng.stats() == {"slots_busy": 1.0, "slots_total": 2.0,
                           "occupancy": 0.5, "queued": 0.0}
    _drain(eng)
    done = eng.token_stats(r)
    assert done["tokens"] == 4 and done["itl_max_s"] >= done["itl_p50_s"]
    assert eng.last_token_age(r) is None
    # A recycled slot starts a fresh timeline for its next request.
    r2 = eng.submit([5, 9, 2])
    assert eng.token_stats(r2)["tokens"] == 1
    assert eng.token_stats(r)["tokens"] == 4


def test_serve_hook_sees_ttft_tokens_and_stall(setup, monkeypatch):
    """The engine's seams to the serving plane: TTFT from request ARRIVAL
    on rtpu_serve_ttft_s, token counts, slot occupancy and gaps between
    tokens on its instruments, the serve.prefill and serve.engine_attach
    hops, and an exactly-once STREAM_STALLED event from peek()."""
    import time as _time

    from ray_tpu_torch.core import events

    seen = []

    class Recorder:
        def __init__(self, kind):
            self.kind = kind

        def observe(self, v, tags=None):
            seen.append((self.kind, v))

        inc = set = observe

    class Hop:
        attributes = {}

        def end(self, **attrs):
            pass

    monkeypatch.setattr(tengine, "_serve_metrics", lambda: {
        k: Recorder(k) for k in ("ttft", "tokens", "slots", "itl")})
    monkeypatch.setattr(tengine.serve_trace, "start_hop",
                        lambda name, **kw: seen.append((name, None))
                        or Hop())
    monkeypatch.setattr(events, "emit",
                        lambda *a, **kw: seen.append(("stall", kw)))
    eng = _engine(setup, num_slots=1, max_prompt_len=16, max_new_tokens=3)
    r = eng.submit([5, 9, 2], arrival_ts=_time.time() - 5.0)
    ttft = [v for k, v in seen if k == "ttft"]
    assert ttft and ttft[0] >= 5.0
    monkeypatch.setenv("RTPU_SERVE_STALL_S", "1e-9")
    eng.peek(r)
    eng.peek(r)
    assert [k for k, _ in seen].count("stall") == 1
    _drain(eng)
    tokens = sum(v for k, v in seen if k == "tokens")
    assert tokens == 3
    assert [v for k, v in seen if k == "slots"][-1] == 0
    kinds = {k for k, _ in seen}
    assert {"serve.prefill", "serve.engine_attach", "itl"} <= kinds


def test_engine_checks_device_of_params(setup):
    tcfg, tparams = setup[1], setup[3]
    with pytest.raises(ValueError, match="params live on"):
        ContinuousBatchingEngine(tcfg, tparams, device="meta")


def test_serve_metrics_reach_prometheus(setup):
    """The mirror of tests/test_llm_engine.py:162: a generate call records
    TTFT, decode-token and slot-occupancy metrics that surface on the
    serve controller's /metrics endpoint tagged by model, as the same
    lines the JAX test asserts on its controller's."""
    import urllib.request

    from ray_tpu_torch import serve
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.metrics import flush_metrics

    serve.start(http_port=0)
    try:
        eng = _engine(setup, num_slots=2, max_prompt_len=16,
                      max_new_tokens=3, model="tiny-test")
        r = eng.submit([5, 9, 2])
        _drain(eng)
        assert len(eng.result(r, timeout=60)) == 3
        flush_metrics()
        addr = state.metrics_address()
        assert addr, "the serve controller serves no metrics endpoint"
        with urllib.request.urlopen(f"http://{addr}/metrics",
                                    timeout=5) as resp:
            text = resp.read().decode()
    finally:
        serve.shutdown()
    assert '# TYPE rtpu_serve_ttft_s histogram' in text, text[-800:]
    assert 'rtpu_serve_ttft_s_bucket{model="tiny-test",le="+Inf"} 1' in text
    assert 'rtpu_serve_ttft_s_count{model="tiny-test"} 1' in text
    # 1 prefill token + 2 decode ticks = 3 tokens for the request.
    assert 'rtpu_serve_decode_tokens_total{model="tiny-test"} 3.0' in text
    # All slots idle again after the request retired.
    assert 'rtpu_serve_slots_busy{model="tiny-test"} 0.0' in text
