"""The port's transformer (ray_tpu_torch/models) against the JAX package's.

The same params (JAX ``init_params`` -> numpy -> ``params_from_numpy``) and
the same seeded tokens go through both sides with ``dtype=float32``.
Tolerance: logits within atol/rtol 1e-4 (f32, another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jconfigs
from ray_tpu.models import quantize as jquant
from ray_tpu.models import transformer as jtfm
from ray_tpu_torch import convert
from ray_tpu_torch.models import configs as tconfigs
from ray_tpu_torch.models import quantize as tquant
from ray_tpu_torch.models import transformer as ttfm

ATOL = RTOL = 1e-4


def _pair(name, **kw):
    jcfg = getattr(jconfigs, name)(remat=False, dtype=jnp.float32, **kw)
    tcfg = getattr(tconfigs, name)(dtype=torch.float32, **kw)
    return jcfg, tcfg


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", ["llama_tiny", "gpt2_tiny"])
def test_forward_logits_match_jax(name):
    jcfg, tcfg = _pair(name)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(_np_tree(jparams), tcfg, "cpu")
    toks = _tokens(tcfg, 2, 24, 1)
    ref = np.asarray(jtfm.forward(jparams, jnp.asarray(toks), jcfg))
    got = ttfm.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_forward_mqa_untied_head_matches_jax():
    """n_kv_heads=1 and an untied lm_head (the Llama-3 head layout)."""
    jcfg, tcfg = _pair("llama_tiny", n_kv_heads=1, tie_embeddings=False)
    jparams = jtfm.init_params(jax.random.key(3), jcfg)
    tparams = convert.params_from_numpy(_np_tree(jparams), tcfg, "cpu")
    assert "lm_head" in tparams
    toks = _tokens(tcfg, 1, 16, 2)
    ref = np.asarray(jtfm.forward(jparams, jnp.asarray(toks), jcfg))
    got = ttfm.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_int8_weights_match_jax():
    jcfg, tcfg = _pair("llama_tiny")
    jparams = jtfm.init_params(jax.random.key(1), jcfg)
    jq = jquant.quantize_params_int8(jparams)
    # The port's quantizer gives the same codes and scales...
    tq = tquant.quantize_params_int8(
        convert.params_from_numpy(_np_tree(jparams), tcfg, "cpu"))
    for name in ("wq", "wkv", "wo", "w_gate_up", "w_down"):
        assert tq["layers"][name].dtype == torch.int8
        np.testing.assert_array_equal(tq["layers"][name].numpy(),
                                      np.asarray(jq["layers"][name]))
        np.testing.assert_allclose(
            tq["layers"][name + "_q8_scale"].numpy(),
            np.asarray(jq["layers"][name + "_q8_scale"]), rtol=1e-6)
    # ... re-quantizing is an idempotent skip ...
    again = tquant.quantize_params_int8(tq)
    for name, w in tq["layers"].items():
        assert again["layers"][name] is w
    # ... and the dequantizing forward matches JAX's on the JAX int8 tree.
    tparams = convert.params_from_numpy(_np_tree(jq), tcfg, "cpu")
    toks = _tokens(tcfg, 2, 12, 4)
    ref = np.asarray(jtfm.forward(jq, jnp.asarray(toks), jcfg))
    got = ttfm.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["llama_tiny", "gpt2_tiny"])
def test_params_round_trip(name):
    jcfg, tcfg = _pair(name)
    tree = _np_tree(jquant.quantize_params_int8(
        jtfm.init_params(jax.random.key(2), jcfg)))
    back = convert.params_to_numpy(
        convert.params_from_numpy(tree, tcfg, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy_checks_names_and_shapes():
    jcfg, tcfg = _pair("llama_tiny")
    tree = _np_tree(jtfm.init_params(jax.random.key(0), jcfg))
    bad = dict(tree, layers=dict(tree["layers"]))
    bad["layers"]["wo"] = bad["layers"]["wo"][:, :-1]
    with pytest.raises(ValueError, match="wo"):
        convert.params_from_numpy(bad, tcfg, "cpu")
    missing = dict(tree)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_numpy(missing, tcfg, "cpu")


def test_bf16_leaves_carry_bits_exactly():
    _, tcfg = _pair("llama_tiny")
    jcfg = jconfigs.llama_tiny(remat=False, param_dtype=jnp.bfloat16)
    tree = _np_tree(jtfm.init_params(jax.random.key(5), jcfg))
    tparams = convert.params_from_numpy(tree, tcfg, "cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tparams["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))


@pytest.mark.parametrize("name", ["llama_tiny", "gpt2_tiny", "llama3_8b"])
def test_init_params_structure_matches_jax(name):
    """The port's own init builds the JAX structure: same names, shapes and
    scales (checked with jax.eval_shape for the full-size config)."""
    jcfg = getattr(jconfigs, name)(remat=False)
    tcfg = getattr(tconfigs, name)()
    want = jax.eval_shape(lambda: jtfm.init_params(jax.random.key(0), jcfg))
    spec = ttfm.param_spec(tcfg)
    got = {k: v[0] for k, v in spec.items() if k != "layers"}
    got["layers"] = {k: v[0] for k, v in spec["layers"].items()}
    assert jax.tree.map(lambda s: tuple(s.shape), want) == got
    if name == "llama3_8b":
        assert tcfg.num_params() == jcfg.num_params()
        return
    params = ttfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    for key in ("wo", "w_down", "wq" if "wq" in spec["layers"] else "wqkv"):
        np.testing.assert_allclose(
            float(params["layers"][key].std()),
            float(np.asarray(jparams["layers"][key]).std()), rtol=0.1)
    assert float(params["embed"].std()) == pytest.approx(0.02, rel=0.1)


def test_config_shapes_match_jax():
    for name in ("gpt2_125m", "llama3_8b", "llama_tiny", "gpt2_tiny",
                 "bench_350m", "moe_tiny"):
        j = getattr(jconfigs, name)()
        t = getattr(tconfigs, name)()
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "kv_heads", "head_dim", "ff_dim", "max_seq_len", "norm",
                  "activation", "positional", "rope_theta",
                  "tie_embeddings", "moe_num_experts"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.num_params() == j.num_params(), name
    assert tconfigs.llama3_8b(param_dtype=torch.bfloat16).param_dtype \
        == torch.bfloat16


def test_rope_and_norms_match_jax():
    """The parity traps: half-split RoPE with f32 angles, biased LayerNorm
    variance, eps 1e-6 (RMS) / 1e-5 (LayerNorm)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32)[None] + 100, (2, 5))
    ref = np.asarray(jtfm._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    got = ttfm._rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                     500000.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    h = rng.standard_normal((2, 5, 32), dtype=np.float32) * 1e-3
    w = rng.standard_normal(32, dtype=np.float32)
    b = rng.standard_normal(32, dtype=np.float32)
    for kind, bias in (("rmsnorm", None), ("layernorm", b)):
        ref = np.asarray(jtfm._norm(
            jnp.asarray(h), jnp.asarray(w),
            None if bias is None else jnp.asarray(bias), kind))
        got = ttfm._norm(torch.from_numpy(h), torch.from_numpy(w),
                         None if bias is None else torch.from_numpy(bias),
                         kind)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_moe_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        ttfm.param_spec(tconfigs.moe_tiny())
