"""The port's mesh train step over the ``expert`` and ``pipe`` axes (MoE
and the GPipe pipeline) and the repaired refusals C2(a) and C2(b), against
the JAX package and the port's one-device step, with the machinery and
tolerances of ``tests/test_torch_seq_parallel.py`` (4 gloo ranks started
once for the module; the first loss within 1e-4 and the first step's
gradients within 1e-5 relative L2 per leaf, f32 everywhere).

- A dense config on expert=2 x data=2, given ``pipeline_microbatches`` on
  a mesh whose pipe is 1: the work is replicated over ``expert`` (no
  dense name maps to it) and the microbatches are ignored, as in the JAX
  package.
- MoE on expert=2 x data=2: moe_tiny at B=8, S=16 routes one group of 128
  tokens that spans both batch shards, so positions, capacity and the aux
  loss need the other shard's routing.
- The pipeline on pipe=2 x data=2 and pipe=2 x fsdp=2 (dense) and pipe=2 x
  expert=2 (MoE), M=4. Its one-device reference is the mean of the
  one-device losses of the M microbatches (MoE routes within a
  microbatch, as the JAX pipeline does); for a dense stack that is the
  whole batch's loss.
- The microbatches that do not split over the batch shards (fault C4,
  once refused): pipe=2 x data=2 at B=8, M=8 holds 4 whole microbatches
  a shard (dense) or replicates each over data (MoE, whose routing group
  must stay the microbatch); at B=3, M=3 neither B/M nor M divides over
  data, and the microbatches are replicated. Both again on pipe=2 x
  fsdp=2, where the params are sharded over the batch axis.
"""
import dataclasses

import pytest
import torch

from test_torch_seq_parallel import (B, assert_layout_matches, make_inputs,
                                  run_port)

M = 4

# name -> (mesh axes, rules, model, batch, shift, env, microbatches)
LAYOUTS = {
    "dense_expert2_data2": (dict(expert=2, data=2), "RULES_TP",
                            "llama_tiny", "masked", False, {}, M),
    "moe_expert2_data2": (dict(expert=2, data=2), "RULES_TP", "moe_tiny",
                          "plain", True, {}, None),
    "pipe2_data2": (dict(pipe=2, data=2), "RULES_TP", "llama_tiny", "plain",
                    True, {}, M),
    "pipe2_fsdp2": (dict(pipe=2, fsdp=2), "RULES_TP", "llama_tiny",
                    "plain", True, {}, M),
    "moe_pipe2_expert2": (dict(pipe=2, expert=2), "RULES_TP", "moe_tiny",
                          "plain", True, {}, M),
    "pipe2_data2_m8_whole": (dict(pipe=2, data=2), "RULES_TP", "llama_tiny",
                             "plain", True, {}, 8),
    "moe_pipe2_data2_m8_replicated": (dict(pipe=2, data=2), "RULES_TP",
                                      "moe_tiny", "plain", True, {}, 8),
    "pipe2_data2_b3_m3_replicated": (dict(pipe=2, data=2), "RULES_TP",
                                     "llama_tiny", "plain3", True, {}, 3),
    # The same two layouts with the params sharded over fsdp, whose
    # gradients come back through DTensor's backward of the gather.
    "pipe2_fsdp2_m8_whole": (dict(pipe=2, fsdp=2), "RULES_TP", "llama_tiny",
                             "plain", True, {}, 8),
    "pipe2_fsdp2_b3_m3_replicated": (dict(pipe=2, fsdp=2), "RULES_TP",
                                     "llama_tiny", "plain3", True, {}, 3),
}


def fused_ce_under_pipe():
    """The refusal's message, or None if the step was built."""
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.train.step import transformer_train_step

    mesh = make_mesh(MeshSpec(pipe=2, data=2), "cpu")
    try:
        transformer_train_step(configs.llama_tiny(fused_ce=True), mesh)
    except NotImplementedError as e:
        return str(e)
    return None


@pytest.fixture(scope="module")
def inputs():
    return make_inputs(LAYOUTS, ("llama_tiny", "moe_tiny"),
                       {"fused_ce_under_pipe": fused_ce_under_pipe})


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    return run_port(inputs, str(tmp_path_factory.mktemp("moe_pipe")))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_matches_jax_and_one_device(name, port, inputs):
    attention = None if "pipe2" in name else "reference_attention"
    assert_layout_matches(port[name], LAYOUTS[name], inputs, attention)


def test_fused_ce_under_pipe_raises(port):
    """As in the JAX package: the pipelined loss would skip the fused
    epilogue."""
    assert "fused_ce" in (port["fused_ce_under_pipe"] or "")


def test_moe_pipe_aux_reaches_the_loss(port, inputs):
    """The pipelined MoE loss carries the aux term: without it the
    microbatched loss is further from the pipeline's than the tolerance."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models import transformer as ttfm

    cfg = dataclasses.replace(configs.moe_tiny(dtype=torch.float32),
                              moe_aux_coef=0.0)
    params = convert.params_from_numpy(inputs["params"]["moe_tiny"], cfg,
                                       "cpu")
    tokens = torch.from_numpy(inputs["batches"]["plain"]["tokens"]).long()
    rows = B // M
    with torch.no_grad():
        no_aux = float(sum(ttfm.loss_fn(
            params, {"tokens": tokens[m * rows:(m + 1) * rows]}, cfg,
            shift_inputs=True) for m in range(M)) / M)
    assert abs(port["moe_pipe2_expert2"]["losses"][0] - no_aux) > 1e-3
