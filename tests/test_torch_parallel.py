"""The port's mesh and sharding layer (``ray_tpu_torch/parallel``) against
the JAX package's (``ray_tpu/parallel``), mirroring tests/test_parallel.py.

The port's meshes here are ``DeviceMesh``es over a simulated world of 8
processes (torch's in-process "fake" process group: this process is rank
0, collectives do nothing), so the layer's bookkeeping runs without
spawning ranks; the JAX side uses the conftest's 8 virtual CPU devices.
Training on real ranks is tests/test_torch_train_sharded.py.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from ray_tpu import parallel as jpar
from ray_tpu.models import configs as jconfigs
from ray_tpu.models import transformer as jtfm
from ray_tpu.parallel import sharding as jshd
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import configs as tconfigs
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel import sharding as tshd
from ray_tpu_torch.train.step import transformer_train_step

torch.set_num_threads(2)

WORLD = 8
SPECS = [dict(data=8), dict(fsdp=8), dict(fsdp=4, tensor=2),
         dict(data=2, fsdp=2, tensor=2), dict(data=2, fsdp=4)]
RULES = ["RULES_DP", "RULES_FSDP", "RULES_TP"]


@pytest.fixture(scope="module")
def world():
    """A simulated world of 8 ranks for the module."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    yield
    dist.destroy_process_group()


def _mesh(**spec):
    return tpar.make_mesh(tpar.MeshSpec(**spec), "cpu")


def test_mesh_spec_resolve():
    spec = tpar.MeshSpec(data=-1, tensor=2).resolve(8)
    assert spec.data == 4 and spec.tensor == 2
    with pytest.raises(ValueError):
        tpar.MeshSpec(data=3).resolve(8)
    with pytest.raises(ValueError):
        tpar.MeshSpec(data=-1, fsdp=-1).resolve(8)
    for n, kw in ((8, dict(want_fsdp=True, want_tensor=2)), (6, {})):
        assert (tpar.best_effort_spec(n, **kw).sizes()
                == jpar.best_effort_spec(n, **kw).sizes())


def test_make_mesh_axis_order(world):
    mesh = _mesh(data=2, fsdp=2, tensor=2)
    assert tpar.AXIS_ORDER == jpar.AXIS_ORDER
    assert mesh.mesh_dim_names == tpar.AXIS_ORDER
    shape = tpar.mesh.mesh_shape(mesh)
    jmesh = jpar.make_mesh(jpar.MeshSpec(data=2, fsdp=2, tensor=2))
    assert shape == dict(jmesh.shape)
    assert mesh.size() == 8
    # DTensors live on the axes of size > 1.
    assert tshd.dtensor_mesh(mesh).mesh_dim_names == ("data", "fsdp",
                                                      "tensor")
    assert tshd.dtensor_mesh(_mesh(fsdp=8)).mesh_dim_names == ("fsdp",)
    # Every axis of size 1 needs a world of one process.
    with pytest.raises(ValueError, match="needs 1 devices, have 8"):
        tpar.single_device_mesh("cpu")


def test_logical_to_mesh_spec_drops_size1_axes(world):
    mesh = _mesh(data=8)
    # tensor axis is size 1 -> mlp must map to None under DP.
    assert tshd.logical_to_mesh_spec(("embed", "mlp"), tshd.RULES_TP,
                                     mesh) == (None, None)
    assert tshd.logical_to_mesh_spec(("batch", None), tshd.RULES_DP,
                                     mesh) == ("data", None)
    assert tshd.placements(("batch", None), tshd.RULES_DP, mesh) == (
        Shard(0),)


def test_logical_no_double_axis_use(world):
    mesh = _mesh(data=2, fsdp=2, tensor=2)
    spec = tshd.logical_to_mesh_spec(("batch", "embed"), tshd.RULES_TP,
                                     mesh)
    assert spec == (("data", "fsdp"), None)
    # The batch dim split over data then fsdp, as a PartitionSpec tuple.
    assert tshd.placements(("batch", "embed"), tshd.RULES_TP, mesh) == (
        Shard(0), Shard(0), Replicate())


def test_rule_tables_and_param_specs_match_jax(world):
    """The same tables, the same logical specs for every param, and the
    same mesh axes per dim for every param under every table and mesh."""
    for name in RULES + ["DEFAULT_RULES"]:
        assert getattr(tshd, name) == getattr(jshd, name), name
    for model, over in (("llama_tiny", {}), ("gpt2_tiny", {}),
                        ("llama_tiny", {"tie_embeddings": False})):
        jspecs = jtfm.param_logical_specs(getattr(jconfigs, model)(**over))
        tspecs = ttfm.param_logical_specs(getattr(tconfigs, model)(**over))
        assert tspecs == jspecs
        leaves = [v for k, v in tspecs.items() if k != "layers"]
        leaves += list(tspecs["layers"].values())
        leaves += [("batch", "seq_act", "heads", None),
                   ("batch", "seq_act", "embed"), ("batch",)]
        for spec in SPECS:
            tmesh = _mesh(**spec)
            jmesh = jpar.make_mesh(jpar.MeshSpec(**spec))
            for rules in RULES:
                for logical in leaves:
                    want = tuple(jshd.logical_to_mesh_spec(
                        logical, getattr(jshd, rules), jmesh))
                    got = tshd.logical_to_mesh_spec(
                        logical, getattr(tshd, rules), tmesh)
                    assert got == want, (model, spec, rules, logical)


def test_shard_batch_places_on_mesh(world):
    tokens = np.arange(16 * 4, dtype=np.int32).reshape(16, 4)
    mesh = _mesh(data=2, fsdp=4)
    batch = tshd.shard_batch(mesh, {"tokens": tokens, "n": np.int32(3)})
    t = batch["tokens"]
    assert isinstance(t, DTensor)
    assert t.placements == (Shard(0), Shard(0))
    assert t.shape == (16, 4)
    # Rank 0 holds the first of 8 row blocks, as jax puts it on device 0.
    np.testing.assert_array_equal(t.to_local().numpy(), tokens[:2])
    jbatch = jshd.shard_batch(jpar.make_mesh(jpar.MeshSpec(data=2, fsdp=4)),
                              {"tokens": tokens})
    assert jbatch["tokens"].sharding.spec == P(("data", "fsdp"), None)
    assert batch["n"].placements == (Replicate(), Replicate())


def test_maybe_constrain_is_a_noop_outside_a_context(world):
    x = torch.ones(4, 4)
    assert tshd.maybe_constrain(x, ("batch", None)) is x
    mesh = _mesh(data=8)
    d = tshd.replicated(mesh).distribute(torch.ones(8, 4))
    with tshd.sharding_ctx(mesh, tshd.RULES_DP):
        out = tshd.maybe_constrain(d, ("batch", None))
        assert out.placements == (Shard(0),)
        assert tshd.current_sharding_ctx() == (mesh, tshd.RULES_DP)
        with tshd.no_sharding_ctx():
            assert tshd.maybe_constrain(d, ("batch", None)) is d
    assert tshd.current_sharding_ctx() is None


@pytest.mark.parametrize("axis", ["pipe", "seq", "expert"])
def test_unported_axes_raise(world, axis):
    cfg = tconfigs.llama_tiny(dtype=torch.float32)
    mesh = _mesh(data=4, **{axis: 2})
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        transformer_train_step(cfg, mesh=mesh, rules=tshd.RULES_TP)


def test_train_step_options_without_a_mesh(world):
    cfg = tconfigs.llama_tiny(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        transformer_train_step(cfg, device="cpu", pipeline_microbatches=4)
    with pytest.raises(ValueError, match="need a mesh"):
        transformer_train_step(cfg, device="cpu", rules=tshd.RULES_DP)
    with pytest.raises(ValueError, match="mesh decides"):
        transformer_train_step(cfg, device="cpu", mesh=_mesh(data=8))


def _qkv(mesh, rules, H, KVH):
    spec = ("batch", "seq_act", "heads", None)
    kv_spec = ("batch", "seq_act", "kv_heads", None)
    q = tshd.named_sharding(mesh, spec, rules).distribute(
        torch.zeros(8, 4, H, 8))
    kv = tshd.named_sharding(mesh, kv_spec, rules).distribute(
        torch.zeros(8, 4, KVH, 8))
    return q, kv, kv


def test_attention_on_a_mesh_checks_its_split(world):
    """A seq axis > 1 waits for ring/Ulysses attention; the kv heads must
    split over the tensor axis, and both head names must map to the same
    axes (else a rank's query heads would read another rank's kv
    heads)."""
    mesh = _mesh(data=4, seq=2)
    with tshd.sharding_ctx(mesh, tshd.RULES_TP), pytest.raises(
            NotImplementedError, match="ROADMAP A4"):
        attention(*_qkv(mesh, tshd.RULES_TP, 4, 2))
    mesh = _mesh(data=2, tensor=4)
    with tshd.sharding_ctx(mesh, tshd.RULES_TP), pytest.raises(
            ValueError, match="2 kv heads do not split over 4"):
        attention(*_qkv(mesh, tshd.RULES_TP, 8, 2))
    rules = dict(tshd.RULES_TP, kv_heads=None)
    with tshd.sharding_ctx(mesh, rules), pytest.raises(
            ValueError, match="another rank's kv heads"):
        attention(*_qkv(mesh, rules, 8, 4))


def test_device_follows_local_rank_in_a_process_group(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")
