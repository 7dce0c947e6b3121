"""KV-cache decoding of the port (ray_tpu_torch/models/generate.py) against
the JAX package's (the mirror of tests/test_generate.py).

Same params (JAX init -> numpy -> params_from_numpy) and seeded tokens on
both sides, ``dtype=float32``. Tolerances: logits and cache within
atol/rtol 1e-4 (f32, another summation order); greedy tokens exact.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu.models.configs import llama_tiny as jllama_tiny
from ray_tpu_torch import convert
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models.configs import llama_tiny as tllama_tiny

# ray_tpu.models re-exports a function named `generate`, shadowing the
# module as an attribute of the package.
jgen = importlib.import_module("ray_tpu.models.generate")

ATOL = RTOL = 1e-4


def _setup(**kw):
    jcfg = jllama_tiny(remat=False, dtype=jnp.float32, **kw)
    tcfg = tllama_tiny(dtype=torch.float32, **kw)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)


def test_prefill_logits_and_cache_match_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    toks = _tokens(tcfg, 3, 5, 2)
    jl, jc = jgen.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, max_len=16)
    tl, tc = tgen.prefill(tp, torch.from_numpy(toks), tcfg, max_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        assert a.shape == b.shape == (2, 3, 16, 2, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    assert int(tc.pos) == int(jc.pos) == 5


def test_ragged_prefill_matches_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    toks = _tokens(tcfg, 3, 8, 3)
    lengths = np.asarray([3, 8, 1])
    jl, jc = jgen.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, 12,
                          lengths=jnp.asarray(lengths, jnp.int32))
    tl, tc = tgen.prefill(tp, torch.from_numpy(toks), tcfg, 12,
                          lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    assert tc.pos.tolist() == [3, 8, 1]


def test_decode_step_matches_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    toks = _tokens(tcfg, 2, 4, 3)
    jl, jc = jgen.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, max_len=8)
    tl, tc = tgen.prefill(tp, torch.from_numpy(toks), tcfg, max_len=8)
    tok = np.argmax(np.asarray(jl), -1)
    assert torch.equal(tl.argmax(-1), torch.from_numpy(tok))
    jl2, jc2 = jgen.decode_step(jp, jc, jnp.asarray(tok, jnp.int32), jcfg)
    assert float(tc.k[:, :, 4].abs().sum()) == 0
    tl2, tc2 = tgen.decode_step(tp, tc, torch.from_numpy(tok), tcfg)
    assert int(tc2.pos) == 5 and tl2.shape == (2, tcfg.vocab_size)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL,
                               rtol=RTOL)
    # The appended slot is written (in place: tc2 shares tc's tensors).
    assert float(tc2.k[:, :, 4].abs().sum()) > 0
    assert tc2.k is tc.k
    np.testing.assert_allclose(tc2.k.numpy(), np.asarray(jc2.k), atol=ATOL,
                               rtol=RTOL)


def test_ragged_decode_writes_then_attends(tiny):
    """Per-row positions: each row writes its own slot before attending,
    so a right-padded row's pad K/V is replaced, never read."""
    jcfg, tcfg, jp, tp = tiny
    toks = _tokens(tcfg, 2, 6, 5)
    lengths = np.asarray([2, 6])
    jl, jc = jgen.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, 10,
                          lengths=jnp.asarray(lengths, jnp.int32))
    tl, tc = tgen.prefill(tp, torch.from_numpy(toks), tcfg, 10,
                          lengths=torch.from_numpy(lengths))
    tok = np.argmax(np.asarray(jl), -1)
    jl2, _ = jgen.decode_step(jp, jc, jnp.asarray(tok, jnp.int32), jcfg)
    tl2, tc2 = tgen.decode_step(tp, tc, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL,
                               rtol=RTOL)
    assert tc2.pos.tolist() == [3, 7]


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_greedy_generate_matches_jax(kv_heads):
    jcfg, tcfg, jp, tp = _setup(n_kv_heads=kv_heads)
    toks = _tokens(tcfg, 2, 7, 1)
    ref = jgen.generate(jp, jnp.asarray(toks, jnp.int32), jcfg,
                        max_new_tokens=6)
    got = tgen.generate(tp, torch.from_numpy(toks), tcfg, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generate_ragged_matches_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    prompts = [[5, 9, 2], [7, 1, 3, 3, 8, 1], [4]]
    toks = np.zeros((3, 8), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lengths = np.asarray([len(p) for p in prompts])
    ref = jgen.generate_ragged(jp, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(lengths, jnp.int32), jcfg,
                               max_new_tokens=5)
    got = tgen.generate_ragged(tp, torch.from_numpy(toks),
                               torch.from_numpy(lengths), tcfg,
                               max_new_tokens=5)
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_eos_freezes_rows_like_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    toks = _tokens(tcfg, 2, 3, 4)
    # An eos the greedy stream actually emits, so the freeze is exercised.
    probe = tgen.generate(tp, torch.from_numpy(toks), tcfg, 8)
    eos = int(probe[0, 4])
    ref = jgen.generate(jp, jnp.asarray(toks, jnp.int32), jcfg,
                        max_new_tokens=8, eos_id=eos)
    got = tgen.generate(tp, torch.from_numpy(toks), tcfg, 8, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    gen = got.numpy()[0, 3:]
    hits = np.flatnonzero(gen == eos)
    assert hits.size and (gen[hits[0]:] == eos).all()


def test_sampled_generation_shape_and_seed(tiny):
    _, tcfg, _, tp = tiny
    toks = torch.from_numpy(_tokens(tcfg, 2, 4, 5))
    outs = [tgen.generate(tp, toks, tcfg, 5, temperature=0.8, top_k=5,
                          generator=torch.Generator().manual_seed(s))
            for s in (7, 8, 7)]
    assert outs[0].shape == (2, 9)
    assert torch.equal(outs[0][:, :4], toks)
    assert torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], outs[1])
    assert int(outs[0].max()) < tcfg.vocab_size


def test_ragged_per_row_temperature(tiny):
    _, tcfg, _, tp = tiny
    toks = torch.from_numpy(_tokens(tcfg, 2, 6, 3))
    lengths = torch.tensor([6, 6])
    temps = torch.tensor([0.0, 1.2])
    o1, o2 = (tgen.generate_ragged(
        tp, toks, lengths, tcfg, 6, temperature=temps,
        generator=torch.Generator().manual_seed(s)) for s in (1, 2))
    assert torch.equal(o1[0], o2[0])
    assert not torch.equal(o1[1], o2[1])
    greedy = tgen.generate(tp, toks[:1], tcfg, 6)
    assert torch.equal(o1[0], greedy[0, 6:])


def test_decode_step_overflow_raises_eagerly(tiny):
    _, tcfg, _, tp = tiny
    toks = torch.from_numpy(_tokens(tcfg, 1, 3, 9))
    logits, cache = tgen.prefill(tp, toks, tcfg, max_len=4)
    tok = logits.argmax(-1)
    _, cache = tgen.decode_step(tp, cache, tok, tcfg)  # fills slot 3
    with pytest.raises(ValueError, match="cache full"):
        tgen.decode_step(tp, cache, tok, tcfg)


def test_unchecked_decode_clamps_the_write(tiny):
    """The engine's tick path: past max_len the write lands on the last
    slot (dynamic_update_slice semantics) and nothing faults."""
    _, tcfg, _, tp = tiny
    toks = torch.from_numpy(_tokens(tcfg, 2, 4, 9))
    logits, cache = tgen.prefill(tp, toks, tcfg, 4,
                                 lengths=torch.tensor([4, 4]))
    tok = logits.argmax(-1)
    for _ in range(3):
        logits, cache = tgen._decode(tp, cache, tok, tcfg)
        tok = logits.argmax(-1)
    assert cache.pos.tolist() == [7, 7]
    assert torch.isfinite(logits).all()


def test_learned_positions_refuse_decode():
    from ray_tpu_torch.models.configs import gpt2_tiny
    from ray_tpu_torch.models.transformer import init_params

    cfg = gpt2_tiny(dtype=torch.float32)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, cache = tgen.prefill(p, torch.zeros(1, 3, dtype=torch.long), cfg, 6)
    with pytest.raises(NotImplementedError):
        tgen.decode_step(p, cache, torch.zeros(1, dtype=torch.long), cfg)


def test_slice_with_flash_matches_jax_engine(monkeypatch):
    """The whole slice on llama_tiny with RTPU_ATTN_IMPL=flash: the JAX
    engine's prefill runs the Pallas forward in interpret mode, the port's
    runs flash_attention (its plain version on the CPU); the greedy streams
    of both engines agree token for token."""
    from ray_tpu.serve.llm_engine import ContinuousBatchingEngine as JEngine
    from ray_tpu_torch.serve.llm_engine import \
        ContinuousBatchingEngine as TEngine

    monkeypatch.setenv("RTPU_ATTN_IMPL", "flash")
    jcfg, tcfg, jp, tp = _setup()
    kw = dict(num_slots=2, max_prompt_len=16, max_new_tokens=5)
    jeng = JEngine(jcfg, jp, **kw)
    teng = TEngine(tcfg, tp, device="cpu", **kw)
    prompts = [[5, 9, 2], [7, 1, 3, 3, 8, 1, 2, 2, 4], [4]]
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.submit(prompts[0])]
        eng.tick()
        reqs += [eng.submit(p) for p in prompts[1:2]]
        eng.tick()
        while eng.tick():
            pass
        reqs.append(eng.submit(prompts[2]))
        while eng.tick():
            pass
        outs.append([eng.result(r, timeout=60) for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 5 for o in outs[1])
