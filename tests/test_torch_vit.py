"""The port's ViT (ray_tpu_torch/models/vit.py) against the JAX package's.

The same params (JAX ``init_params`` -> numpy -> ``vit_params_from_numpy``)
and the same seeded images go through both sides. Tolerances: f32 logits
within atol/rtol 1e-4 (another summation order), as the decoder's
(tests/test_torch_models.py). bf16 logits within BF16_REL_L2 relative L2:
each side rounds the activations to bf16 (8 bits of mantissa, 3.9e-3 a
rounding) after every product, norm and residual add, and the two sides'
products sum in other orders, so their roundings differ by an ulp here and
there; 2 layers and the f32 head carry that to a few ulps of the logits'
scale (6.7e-3 to 9.0e-3 at d_model 128 over seeds 0-3, where each side
lies 8.6e-3 to 1.2e-2 from the f32 forward), and 2e-2 leaves room for
about five.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import quantize as jquant
from ray_tpu.models import vit as jvit
from ray_tpu_torch import convert, flags
from ray_tpu_torch.models import quantize as tquant
from ray_tpu_torch.models import vit as tvit

torch.set_num_threads(2)

ATOL = RTOL = 1e-4
BF16_REL_L2 = 2e-2


def _pair(dtype=None, **kw):
    jcfg = jvit.vit_tiny(dtype=dtype or jnp.float32, **kw)
    tcfg = tvit.vit_tiny(dtype=torch.bfloat16 if dtype else torch.float32,
                         **kw)
    return jcfg, tcfg


def _images(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_patchify_is_exact():
    cfg = tvit.vit_tiny()
    x = _images(cfg, 2, 0)
    got = tvit.patchify(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(jvit.patchify(jnp.asarray(x), jvit.vit_tiny()))
    assert got.shape == (2, cfg.num_patches, cfg.patch_dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"d_model": 128, "n_heads": 2}],
                         ids=["d16", "d64"])
def test_f32_logits_match_jax(kw):
    """vit_tiny at head dim 16, and at 64 (ViT-L's) with 2 heads."""
    jcfg, tcfg = _pair(**kw)
    jparams = jvit.init_params(jax.random.key(0), jcfg)
    tparams = convert.vit_params_from_numpy(_np_tree(jparams), tcfg, "cpu")
    x = _images(tcfg, 3, 1)
    want = np.asarray(jvit.forward(jparams, jnp.asarray(x), jcfg))
    with torch.inference_mode():
        got = tvit.forward(tparams, x, tcfg)
    assert got.dtype == torch.float32
    assert got.shape == (3, tcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_f32_logits_through_the_kernels_plain_version():
    """RTPU_ATTN_IMPL=flash: attention through flash_attention (on the CPU,
    K1's plain version, no mask), as the card runs K1 itself."""
    jcfg, tcfg = _pair(d_model=128, n_heads=2)
    jparams = jvit.init_params(jax.random.key(2), jcfg)
    tparams = convert.vit_params_from_numpy(_np_tree(jparams), tcfg, "cpu")
    x = _images(tcfg, 2, 3)
    want = np.asarray(jvit.forward(jparams, jnp.asarray(x), jcfg))
    with flags.scoped({"RTPU_ATTN_IMPL": "flash"}), torch.inference_mode():
        got = tvit.forward(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_bf16_logits_match_jax():
    """The default compute dtype: bf16 activations, f32 params and head."""
    jcfg, tcfg = _pair(dtype=jnp.bfloat16, d_model=128, n_heads=2)
    jparams = jvit.init_params(jax.random.key(4), jcfg)
    tparams = convert.vit_params_from_numpy(_np_tree(jparams), tcfg, "cpu")
    x = _images(tcfg, 4, 5)
    want = np.asarray(jvit.forward(jparams, jnp.asarray(x), jcfg))
    with torch.inference_mode():
        got = tvit.forward(tparams, x, tcfg)
    assert got.dtype == torch.float32
    assert _rel_l2(got.numpy(), want) < BF16_REL_L2


def test_int8_weights_match_jax():
    """Both quantizers give the same codes and scales, and the int8 forward
    (weights read through maybe_dequant) agrees as f32 does."""
    jcfg, tcfg = _pair()
    jparams = jvit.init_params(jax.random.key(6), jcfg)
    jq = jquant.quantize_params_int8(jparams)
    tq = tquant.quantize_params_int8(
        convert.vit_params_from_numpy(_np_tree(jparams), tcfg, "cpu"))
    for name in ("wqkv", "wo", "w_up", "w_down"):
        assert tq["layers"][name].dtype == torch.int8
        np.testing.assert_array_equal(tq["layers"][name].numpy(),
                                      np.asarray(jq["layers"][name]))
    # The JAX int8 tree carries across with its scales.
    carried = convert.vit_params_from_numpy(_np_tree(jq), tcfg, "cpu")
    assert carried["layers"]["wqkv_q8_scale"].shape == (2, 1, 3, 4, 16)
    x = _images(tcfg, 2, 7)
    want = np.asarray(jvit.forward(jq, jnp.asarray(x), jcfg))
    with torch.inference_mode():
        got = tvit.forward(carried, x, tcfg)
        own = tvit.forward(tq, x, tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(own.numpy(), want, atol=ATOL, rtol=RTOL)


def test_params_carry_across_and_back():
    """Names and shapes match the JAX init tree; vit_params_from_numpy and
    params_to_numpy round-trip it; a wrong shape or name is refused."""
    jcfg, tcfg = _pair()
    tree = _np_tree(jvit.init_params(jax.random.key(8), jcfg))
    mine = tvit.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")

    def shapes(t):
        out = {k: tuple(v.shape) for k, v in t.items() if k != "layers"}
        out.update({("layers", k): tuple(v.shape)
                    for k, v in t["layers"].items()})
        return out

    assert shapes(mine) == shapes(tree)
    assert sum(v.size for k, v in tree.items() if k != "layers") + sum(
        v.size for v in tree["layers"].values()) == tcfg.num_params()
    back = convert.params_to_numpy(
        convert.vit_params_from_numpy(tree, tcfg, "cpu"))
    for k, v in tree.items():
        if k == "layers":
            for n, w in v.items():
                np.testing.assert_array_equal(back["layers"][n], w)
        else:
            np.testing.assert_array_equal(back[k], v)
    bad = dict(tree, head=tree["head"][:, :5])
    with pytest.raises(ValueError, match="head"):
        convert.vit_params_from_numpy(bad, tcfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "cls_token"}
    with pytest.raises(ValueError, match="cls_token"):
        convert.vit_params_from_numpy(missing, tcfg, "cpu")


def test_vit_l16_config_matches_jax():
    j, t = jvit.vit_l16(), tvit.vit_l16()
    assert (t.num_patches, t.patch_dim, t.num_params()) == (
        j.num_patches, j.patch_dim, j.num_params())
    assert t.num_patches + 1 == 197 and t.d_model // t.n_heads == 64
    assert tvit.param_logical_specs(t) == jvit.param_logical_specs(j)
