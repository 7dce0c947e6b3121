"""Fault C6 settled: the port's data=4 mesh step (``ShardedTrainStep``,
``RULES_DP``, 4 gloo ranks) takes the one-device step's 12 AdamW steps of
GPT-2's recipe in f32 (plain attention) at f32 rounding, and the JAX
package's data=4 step on 4 virtual devices too.

``tools/c6_dp_f32_check.py`` runs it (and, on four cards, GPT-2 125M);
the ranks import that module again, so it keeps jax out of its top.
Tolerance: each loss within 1e-5 relative of the other two runs'; the
largest gap measured here, for any pair, is 6.8e-7, and on four H100s at
GPT-2 125M, from ``train_glue``'s init, the mesh lay 3.7e-7 from one
device through the loss spike, where bf16 lies 0.121 away.
"""
import pathlib
import sys


sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))

import c6_dp_f32_check  # noqa: E402

LOSS_RTOL = 1e-5


def test_data4_mesh_step_matches_one_device_and_the_jax_mesh_in_f32():
    out = c6_dp_f32_check.compare("cpu", "gpt2_tiny", world=4, rows=4,
                                  seq=64, steps=12, jax=True)
    assert out["ranks_agree_f32"]
    assert len(out["mesh_f32"]) == 12
    assert out["mesh_f32"][-1] < out["mesh_f32"][0]  # it trains
    for pair in ("gap_mesh_vs_one_device_f32", "gap_mesh_vs_jax_mesh_f32",
                 "gap_jax_mesh_vs_one_device_f32"):
        assert max(out[pair]) <= LOSS_RTOL, (pair, out[pair])
