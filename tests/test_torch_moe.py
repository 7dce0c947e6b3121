"""The port's MoE layer (``ray_tpu_torch/ops/moe.py``) and MoE configs on
one device against the JAX package (``ray_tpu/ops/moe.py``).

The same seeded numpy inputs and JAX-initialised params go through both
sides in f32. Tolerances: ``moe_ffn`` output and gradients within 1e-5
relative L2 (the same sums in another order; 1e-4 for the router's under
top-1, where the gate path cancels), its aux within 1e-6 absolute; the moe_tiny loss within 1e-5 relative and its gradients within
atol/rtol 1e-4, as ``tests/test_torch_train.py`` holds the dense model.
Greedy generation must give the same tokens. The routing is discrete, so a
near tie between two experts' probabilities could flip a choice and move
a gradient by far more than any bound; none of these seeded inputs comes
within 1e-4 of one (the test checks).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jconfigs
from ray_tpu.models import transformer as jtfm
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch import convert
from ray_tpu_torch.models import configs as tconfigs
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.ops import moe as tmoe

# The package exports a function named generate over its module.
jgen = importlib.import_module("ray_tpu.models.generate")

torch.set_num_threads(2)

REL_L2 = 1e-5
# Top-1 renormalises each chosen gate to exactly 1: its gradient is the
# difference of two equal terms, so the router's gradient is the aux
# term's alone plus what rounding leaves of that pair (2.5e-5 measured).
ROUTER_TOP1_REL_L2 = 1e-4

# name -> (B, S, d, E, F, k, capacity factor, group size)
FFN_CASES = {
    # One group of 64 tokens; capacity 20 of 64*2/8=16 a expert on
    # average, so the busiest experts drop choices.
    "drops": (2, 32, 16, 8, 24, 2, 1.25, 4096),
    # 4 groups of 16 (group_size caps the group), top-1.
    "groups_top1": (4, 16, 16, 4, 24, 1, 1.0, 16),
    # 30 tokens: the group is the largest power of two dividing them (2).
    "odd_tokens": (3, 10, 16, 4, 8, 2, 2.0, 4096),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _ffn_inputs(name):
    B, S, d, E, F, k, cf, gs = FFN_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    gu = (rng.standard_normal((E, d, 2, F)) / np.sqrt(d)).astype(np.float32)
    down = (rng.standard_normal((E, F, d)) / np.sqrt(F)).astype(np.float32)
    cot = rng.standard_normal((B, S, d)).astype(np.float32)
    return x, router, gu, down, cot


def _min_gap(x, router, k):
    """The smallest gap between a token's k-th and (k+1)-th expert."""
    p = np.sort(jax.nn.softmax(x.reshape(-1, x.shape[-1]) @ router,
                               axis=-1), axis=-1)[:, ::-1]
    return float(np.min(p[:, k - 1] - p[:, k]))


@pytest.mark.parametrize("name", list(FFN_CASES))
def test_moe_ffn_matches_jax(name):
    B, S, d, E, F, k, cf, gs = FFN_CASES[name]
    x, router, gu, down, cot = _ffn_inputs(name)
    assert _min_gap(x, router, k) > 1e-4
    kw = dict(experts_per_token=k, capacity_factor=cf, group_size=gs)

    def jloss(*args):
        out, aux = jmoe.moe_ffn(*args, dtype=jnp.float32, **kw)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(x, router, gu, down)
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (x, router, gu, down)]
    out, aux = tmoe.moe_ffn(*targs, dtype=torch.float32, **kw)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    assert _rel(out.detach(), jout) <= REL_L2
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6
    for t, g, what in zip(targs, jgrads, ("x", "router", "gate_up", "down")):
        bound = ROUTER_TOP1_REL_L2 if (what, k) == ("router", 1) else REL_L2
        assert _rel(t.grad, g) <= bound, what


def test_dropped_choices_are_those_of_jax():
    """Capacity and k-major priority: the same choices are kept."""
    B, S, d, E, F, k, cf, gs = FFN_CASES["drops"]
    x, router, *_ = _ffn_inputs("drops")
    T = B * S
    C = tmoe.expert_capacity(T, k, E, cf)
    probs = torch.softmax(torch.from_numpy(x).reshape(T, d)
                          @ torch.from_numpy(router), dim=-1)
    _, idx, pos, keep, _ = tmoe.route(probs[None], k, C)
    assert 0 < int((~keep).sum()) < T * k
    # The JAX package's own position computation on its own top-k.
    _, jidx = jax.lax.top_k(jax.nn.softmax(x.reshape(T, d) @ router), k)
    onehot = jax.nn.one_hot(jidx, E, dtype=jnp.int32)
    flat = onehot.transpose(1, 0, 2).reshape(k * T, E)
    jpos = (jnp.cumsum(flat, axis=0) - flat).reshape(k, T, E).transpose(
        1, 0, 2)
    jposition = (jpos * onehot).sum(-1)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos[0].numpy(), np.asarray(jposition))
    np.testing.assert_array_equal(keep[0].numpy(),
                                  np.asarray(jposition < C))


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    vals, idx = tmoe.top_k(torch.from_numpy(probs), 2)
    jvals, jidx = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# ------------------------------------------------------------- moe_tiny

@functools.lru_cache(maxsize=1)
def _moe_tiny():
    jcfg = jconfigs.moe_tiny(dtype=jnp.float32)
    tcfg = tconfigs.moe_tiny(dtype=torch.float32)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=1)
def _jax_loss_grads():
    jcfg, _, jparams, _ = _moe_tiny()
    tokens = _tokens((4, 33), 3)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtfm.loss_fn(
        p, {"tokens": tokens}, jcfg, shift_inputs=True)))(jparams)
    _, aux = jtfm.forward_with_aux(jparams, tokens[:, :-1], jcfg)
    return tokens, float(loss), jax.tree.map(np.asarray, grads), float(aux)


def _leaves(tree):
    out = [(k, v) for k, v in sorted(tree.items()) if k != "layers"]
    return out + [("layers." + k, v)
                  for k, v in sorted(tree["layers"].items())]


@pytest.mark.parametrize("policy", [None, "full", "dots", "dots_attn", "min",
                                    "half_dots", "half_full"])
def test_moe_tiny_loss_and_grads_match_jax(policy):
    """The loss (with its aux term) and every leaf's gradient, under each
    remat policy: the aux threads through the checkpointed layers and the
    half_* split."""
    _, tcfg, _, tree = _moe_tiny()
    tokens, jloss, jgrads, jaux = _jax_loss_grads()
    if policy is not None:
        tcfg = tconfigs.moe_tiny(dtype=torch.float32, remat=True,
                                 remat_policy=policy)
    params = convert.params_from_numpy(tree, tcfg, "cpu")
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    tb = {"tokens": torch.from_numpy(tokens).long()}
    loss = ttfm.loss_fn(params, tb, tcfg, shift_inputs=True)
    loss.backward()
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for name, g in _leaves(jgrads):
        np.testing.assert_allclose(leaves[name].grad.numpy(), g, atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    with torch.no_grad():
        _, aux = ttfm.forward_with_aux(params, tb["tokens"][:, :-1], tcfg)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-5)
    # Switch aux is about 1 a layer at uniform routing.
    assert 0.1 < float(aux) / tcfg.n_layers < 10.0


def test_moe_tiny_greedy_generation_matches_jax():
    """Prefill and decode through the MoE layer (decode routes the batch's
    B tokens as one group each step, as in the JAX package)."""
    jcfg, tcfg, jparams, tree = _moe_tiny()
    params = convert.params_from_numpy(tree, tcfg, "cpu")
    prompt = _tokens((2, 12), 9)
    want = jgen.generate(jparams, jnp.asarray(prompt), jcfg,
                         max_new_tokens=6)
    got = tgen.generate(params, torch.from_numpy(prompt).long(), tcfg,
                        max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_params_convert_with_checked_names_and_shapes():
    _, tcfg, _, tree = _moe_tiny()
    spec = ttfm.param_spec(tcfg)["layers"]
    assert {"router", "moe_w_gate_up", "moe_w_down"} <= set(spec)
    assert "w_gate_up" not in spec and "w_down" not in spec
    bad = {**tree, "layers": {**tree["layers"],
                              "router": tree["layers"]["router"][:, :, :2]}}
    with pytest.raises(ValueError, match="router"):
        convert.params_from_numpy(bad, tcfg, "cpu")
    specs = ttfm.param_logical_specs(tcfg)["layers"]
    assert specs["moe_w_gate_up"] == ("layers", "expert", "embed", None,
                                      "mlp")
