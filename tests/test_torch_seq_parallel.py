"""Sequence parallelism in the port, against the JAX package: ring and
Ulysses attention over the ``seq`` mesh axis op by op, the choice
``RTPU_SP_MODE`` makes, and the mesh train step over ``seq`` (ring and
Ulysses attention, MoE with its tokens split over seq) with the dense
fallbacks of its attention. ``tests/test_torch_train_moe_pipe.py`` runs
the ``expert`` and ``pipe`` cases with the same machinery, defined here.

The port side runs in 4 processes, one gloo rank each, under one process
group started once for the module (``tests/test_torch_train_sharded.py``
does the same for data, fsdp and tensor). Each rank takes 2 AdamW steps of
every train case with ``transformer_train_step(cfg, mesh, rules=...)``,
the mesh passed positionally as in the JAX package (C1), and then runs
every op case. The parent meanwhile computes the JAX side on 4 virtual
devices (the Pallas kernels in interpret mode; the port's kernels run
their plain versions on the CPU): the loss and gradients of every train
case (its sharded ``loss_fn``, or ``pipeline_loss_fn``) and every op under
``shard_map``; then the port's one-device steps. Tolerances (f32 on every
side):

- ops: ``ring_attention`` and ``ulysses_attention`` on the chunks of one
  sequence split over the 4 ranks, causal and not, MHA and GQA: the output
  and dq/dk/dv for the same seeded cotangent within 1e-5 relative L2;
- train: the first loss within 1e-4 absolute of the JAX one, and both
  losses of the one-device run's; each leaf's gradient in the first step
  within 1e-5 relative L2 of the other side's. A gradient shows what the
  params hide (AdamW cancels a constant factor on a gradient): a
  reduction that sums where it should average, or a share counted on
  every pipe or expert rank, moves it by the world size.

The train cases: the ring in the [B, S+1] shift convention (the target of
a chunk's last position lies in the next chunk), Ulysses in the masked
in-place one, MoE with its tokens split over seq and its experts over
``expert``, and the dense fallbacks (C2(c)): rules that leave the sequence
whole (RULES_FSDP on seq=2), and ``RTPU_ATTN_IMPL=xla``.
"""
import multiprocessing
import traceback

import numpy as np
import pytest
import torch

from ray_tpu_torch.flags import scoped
from test_torch_train_sharded import (PORT_TIMEOUT_S, _assert_grads_close,
                                      _grads, collect)

torch.set_num_threads(2)

WORLD = 4
# The ops in f32 on both sides: relative L2 of each output.
OP_REL_L2 = 1e-5

# name -> (causal, H, KVH); D = 16, one sequence of 64 split in 4.
OPS = {"causal_mha": (True, 4, 4), "causal_gqa": (True, 8, 4),
       "full_mha": (False, 4, 4), "full_gqa": (False, 8, 4)}
OP_B, OP_S, OP_D = 2, 64, 16


def _op_inputs(name):
    _, H, KVH = OPS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    shapes = [(OP_B, OP_S, H, OP_D), (OP_B, OP_S, KVH, OP_D),
              (OP_B, OP_S, KVH, OP_D), (OP_B, OP_S, H, OP_D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


STEPS = 2
B, S = 8, 16
LOSS_ATOL = 1e-4

# name -> (mesh axes, rules, model, batch, shift, env, microbatches)
LAYOUTS = {
    "ring_seq2_data2": (dict(seq=2, data=2), "RULES_TP", "llama_tiny",
                        "plain", True, {"RTPU_SP_MODE": "ring"}, None),
    "ulysses_seq2_data2": (dict(seq=2, data=2), "RULES_TP", "llama_tiny",
                           "masked", False, {"RTPU_SP_MODE": "ulysses"},
                           None),
    "moe_seq2_expert2": (dict(seq=2, expert=2), "RULES_TP", "moe_tiny",
                         "plain", True, {}, None),
    "dense_seq2_fsdp_rules": (dict(seq=2, fsdp=2), "RULES_FSDP",
                              "llama_tiny", "plain", True, {}, None),
    "xla_seq2_data2": (dict(seq=2, data=2), "RULES_TP", "llama_tiny",
                       "plain", True, {"RTPU_ATTN_IMPL": "xla"}, None),
}
MODELS = ("llama_tiny", "moe_tiny")

# The attention each layout's layers run (2 layers, once a step).
ATTENTION = {
    "ring_seq2_data2": "ring_attention",
    "ulysses_seq2_data2": "ulysses_attention",
    "moe_seq2_expert2": "ring_attention",
    "dense_seq2_fsdp_rules": "reference_attention",
    "xla_seq2_data2": "reference_attention",
}


def _batches():
    rng = np.random.default_rng(5)
    return {
        "plain": {"tokens": rng.integers(0, 512, (B, S + 1)).astype(
            np.int32)},
        "masked": {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
                   "mask": (rng.random((B, S)) > 0.2).astype(np.int32)},
        # 3 rows: split over no batch shards of 2, by rows or microbatches.
        "plain3": {"tokens": rng.integers(0, 512, (3, S + 1)).astype(
            np.int32)},
    }


def _pipelined(layout) -> bool:
    return layout[0].get("pipe", 1) > 1


# ------------------------------------------------------------ port ranks

def _run_op(scheme, name, mesh):
    """One op on this rank's chunk; the output and gradients gathered
    whole over the seq group."""
    import torch.distributed as dist

    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.ops.ulysses_attention import ulysses_attention

    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[scheme]
    causal = OPS[name][0]
    group = mesh.get_group("seq")
    r, n = dist.get_rank(group), dist.get_world_size(group)
    chunk = OP_S // n
    q, k, v, w = (torch.from_numpy(a[:, r * chunk:(r + 1) * chunk].copy())
                  for a in _op_inputs(name))
    for t in (q, k, v):
        t.requires_grad_(True)
    o = fn(q, k, v, group, causal=causal)
    (o * w).sum().backward()
    out = {}
    for key, t in (("o", o), ("dq", q.grad), ("dk", k.grad),
                   ("dv", v.grad)):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.detach().contiguous(), group=group)
        out[key] = torch.cat(parts, dim=1).numpy()
    return out


def run_ops():
    """Every op case on this rank, on a seq=4 mesh."""
    from ray_tpu_torch.parallel import MeshSpec, make_mesh

    seq4 = make_mesh(MeshSpec(seq=WORLD), "cpu")
    return {(scheme, name): _run_op(scheme, name, seq4)
            for scheme in ("ring", "ulysses") for name in OPS}


def _count_attention():
    """Record which attention function each layer runs, by name."""
    from ray_tpu_torch.ops import attention as att

    seen = []
    for name in ("ring_attention", "ulysses_attention", "flash_attention",
                 "reference_attention"):
        fn = getattr(att, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            seen.append(_name)
            return _fn(*args, **kw)
        setattr(att, name, counted)
    return seen


def _run_layout(layout, inputs, seen):
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.train.step import transformer_train_step

    spec, rules, model, batch, shift, env, micro = layout
    with scoped(env):
        mesh = make_mesh(MeshSpec(**spec), "cpu")
        cfg = getattr(configs, model)(dtype=torch.float32)
        rules = getattr(shd, rules)
        ts = transformer_train_step(cfg, mesh, rules=rules,
                                    shift_inputs=shift,
                                    pipeline_microbatches=micro)
        params = convert.params_to_mesh(inputs["params"][model], cfg, mesh,
                                        rules)
        opt = ts.init_opt_state(params)
        sharded = ts.shard_batch(inputs["batches"][batch])
        seen.clear()
        losses, grads = [], None
        for _ in range(STEPS):
            params, opt, loss = ts.step(params, opt, sharded)
            losses.append(float(loss))
            grads = grads or _grads(params)
    return {"losses": losses, "grads": grads, "calls": list(seen),
            "step": type(ts).__name__}


def _rank_main(rank, init, inputs, results):
    """One rank: join the group, run every case, hand rank 0's results
    back. Imports nothing of jax or the JAX package."""
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from ray_tpu_torch.parallel import MeshBootstrap

        MeshBootstrap(init, WORLD, rank, device_type="cpu").initialize()
        seen = _count_attention()
        out = {name: _run_layout(layout, inputs, seen)
               for name, layout in inputs["layouts"].items()}
        for name, fn in inputs["extra"].items():
            out[name] = fn()
        dist.destroy_process_group()
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))


def make_inputs(layouts, models, extra=None):
    """The JAX init params of ``models`` (as numpy), the batches, and the
    cases the ranks run."""
    import jax

    from ray_tpu.models import configs as jconfigs
    from ray_tpu.models import transformer as jtfm

    params = {m: jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.key(0), getattr(jconfigs, m)(dtype=jax.numpy.float32)))
        for m in models}
    return {"params": params, "batches": _batches(), "layouts": layouts,
            "extra": extra or {}}


def run_port(inputs, tmp):
    """Every case on 4 gloo ranks; the JAX side of every train case runs
    here meanwhile."""
    procs, results = spawn_ranks(_rank_main, inputs, tmp)
    try:
        for layout in inputs["layouts"].values():
            _jax_run(layout, inputs)
    finally:
        got = collect(procs, results)
    return got


def spawn_ranks(target, inputs, tmp):
    """Start ``target(rank, init, inputs, results)`` in 4 spawned
    processes that meet at a ``file://`` rendezvous in ``tmp``; returns
    what ``collect`` waits on."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target,
                         args=(r, f"file://{tmp}/rendezvous", inputs,
                               results), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs, results


@pytest.fixture(scope="module")
def inputs():
    return make_inputs(LAYOUTS, MODELS, {"ops": run_ops})


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """The ranks' results. The JAX side of the op cases runs meanwhile in
    a process of its own (tracing the ring's interpreted Pallas kernels is
    the longest part of the module), the train cases' in this one."""
    ctx = multiprocessing.get_context("spawn")
    ops = ctx.Queue()
    child = ctx.Process(target=_jax_ops_main, args=(ops,), daemon=True)
    child.start()
    try:
        got = run_port(inputs, str(tmp_path_factory.mktemp("seq")))
        status, payload = ops.get(timeout=PORT_TIMEOUT_S)
    finally:
        child.join(timeout=10)
        if child.is_alive():
            child.terminate()
    if status == "error":
        raise RuntimeError(f"the JAX op cases failed:\n{payload}")
    _JAX_OPS.update(payload)
    return got


# --------------------------------------------------------------- JAX side

_JAX = {}


def _jax_run(layout, inputs):
    """The JAX package's loss and gradients on 4 virtual devices (what its
    sharded step takes its first update from), as numpy."""
    key = repr(layout)
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import configs as jconfigs
    from ray_tpu.models import transformer as jtfm
    from ray_tpu.parallel import MeshSpec, make_mesh
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu.parallel.pipeline import pipeline_loss_fn

    spec, rules, model, batch, shift, env, micro = layout
    with scoped(env):
        mesh = make_mesh(MeshSpec(**spec), devices=jax.devices()[:WORLD])
        jcfg = getattr(jconfigs, model)(dtype=jnp.float32)
        rules = getattr(jshd, rules)
        params = jax.device_put(inputs["params"][model], jshd.tree_shardings(
            mesh, jtfm.param_logical_specs(jcfg), rules))
        host = inputs["batches"][batch]
        if len(host["tokens"]) % (mesh.shape["data"] * mesh.shape["fsdp"]):
            # The JAX package places no batch whose rows do not divide
            # over the batch shards; GSPMD lays it out inside the step.
            sharded = jax.device_put(host, jshd.replicated(mesh))
        else:
            sharded = jshd.shard_batch(mesh, host)
        if _pipelined(layout):
            loss_fn = pipeline_loss_fn(jcfg, mesh, rules=rules,
                                       num_microbatches=micro,
                                       shift_inputs=shift)
        else:
            def loss_fn(p, b):
                with jshd.sharding_ctx(mesh, rules):
                    return jtfm.loss_fn(p, b, jcfg, shift_inputs=shift)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, sharded)
    _JAX[key] = {"losses": [float(loss)],
                 "grads": jax.tree.map(np.asarray, grads)}
    return _JAX[key]


def _one_device_run(layout, inputs):
    """The port's one-device loss, gradients and AdamW steps on the same
    params and batch; for a pipelined case the loss is the mean of its
    microbatches' losses."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models import transformer as ttfm
    from ray_tpu_torch.train.step import default_optimizer, param_leaves

    _, _, model, batch, shift, _, micro = layout
    cfg = getattr(configs, model)(dtype=torch.float32)
    params = convert.params_from_numpy(inputs["params"][model], cfg, "cpu")
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = default_optimizer(leaves)
    tb = {k: torch.from_numpy(v).long()
          for k, v in inputs["batches"][batch].items()}
    parts = micro if _pipelined(layout) else 1
    rows = len(tb["tokens"]) // parts
    losses, grads = [], None
    for _ in range(STEPS):
        opt.zero_grad(set_to_none=True)
        loss = sum(ttfm.loss_fn(
            params, {k: v[m * rows:(m + 1) * rows] for k, v in tb.items()},
            cfg, shift_inputs=shift) for m in range(parts)) / parts
        loss.backward()
        grads = grads or _grads(params)
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": grads}


def assert_layout_matches(got, layout, inputs, attention=None):
    """One case against the JAX loss and gradients and the port's
    one-device steps."""
    assert got["step"] == "ShardedTrainStep"
    want = _jax_run(layout, inputs)
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               atol=LOSS_ATOL, rtol=0)
    _assert_grads_close(got["grads"], want["grads"])
    one = _one_device_run(layout, inputs)
    np.testing.assert_allclose(got["losses"], one["losses"], atol=LOSS_ATOL,
                               rtol=0)
    _assert_grads_close(got["grads"], one["grads"])
    assert got["losses"][1] < got["losses"][0]
    if attention is not None:
        assert got["calls"] == [attention] * 2 * STEPS


_JAX_OPS = {}


def _jax_ops_main(results):
    """Every op case's JAX side, in a spawned process: on 4 of 8 virtual
    CPU devices, set up as the conftest does before jax is imported."""
    try:
        from ray_tpu.util.jaxenv import cpu_mesh_env

        cpu_mesh_env(8)
        results.put(("ok", {(scheme, name): _jax_op(scheme, name)
                            for scheme in ("ring", "ulysses")
                            for name in OPS}))
    except BaseException:
        results.put(("error", traceback.format_exc()))


def _jax_op(scheme, name):
    key = (scheme, name)
    if key not in _JAX_OPS:
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, PartitionSpec as P

        from ray_tpu.ops.ring_attention import ring_attention
        from ray_tpu.ops.ulysses_attention import ulysses_attention

        fn = {"ring": ring_attention, "ulysses": ulysses_attention}[scheme]
        causal = OPS[name][0]
        mesh = Mesh(np.array(jax.devices()[:WORLD]), ("seq",))
        spec = P(None, "seq", None, None)
        sharded = jax.shard_map(
            lambda q, k, v: fn(q, k, v, "seq", causal=causal),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False)
        q, k, v, w = map(jnp.asarray, _op_inputs(name))

        @jax.jit
        def run(q, k, v, w):
            o, vjp = jax.vjp(sharded, q, k, v)
            return (o,) + vjp(w)

        _JAX_OPS[key] = dict(zip(("o", "dq", "dk", "dv"),
                             map(np.asarray, run(q, k, v, w))))
    return _JAX_OPS[key]


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_jax(scheme, name, port):
    """The output and dq/dk/dv of one sequence over 4 ranks."""
    got, want = port["ops"][(scheme, name)], _jax_op(scheme, name)
    for key in ("o", "dq", "dk", "dv"):
        rel = (np.linalg.norm(got[key] - want[key])
               / np.linalg.norm(want[key]))
        assert rel <= OP_REL_L2, (key, rel)


def test_sp_mode_selects_as_the_reference():
    """RTPU_SP_MODE: ring | ulysses | auto, with Ulysses only where the
    heads a rank holds divide the seq axis (an explicit ulysses that cannot
    divide runs the ring); checked through the dispatch's choice on a fake
    4-rank world (no collective runs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel import sharding as shd

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        chosen = []
        old = att.local_map

        def spy(body, **kw):
            chosen.append(getattr(body, "func", body).__name__)
            return lambda *a: a[0]
        att.local_map = spy
        try:
            for mesh_spec, H, KVH, mode, want in (
                    (dict(seq=4), 8, 4, "ring", "ring_attention"),
                    (dict(seq=4), 8, 4, "auto", "ulysses_attention"),
                    (dict(seq=4), 8, 4, "ulysses", "ulysses_attention"),
                    (dict(seq=4), 8, 2, "ulysses", "ring_attention"),
                    (dict(seq=4), 8, 2, "auto", "ring_attention"),
                    # 8 heads over tensor=2: 4 a rank, 2 kv heads a rank.
                    (dict(seq=2, tensor=2), 8, 4, "auto",
                     "ulysses_attention"),
                    (dict(seq=2, tensor=2), 8, 2, "auto", "ring_attention")):
                mesh = make_mesh(MeshSpec(**mesh_spec), "cpu")
                q = torch.zeros(1, 8, H, 4)
                k = torch.zeros(1, 8, KVH, 4)
                with scoped({"RTPU_SP_MODE": mode}):
                    with shd.sharding_ctx(mesh, shd.RULES_TP):
                        att.attention(q, k, k)
                assert chosen[-1] == want, (mesh_spec, H, KVH, mode)
        finally:
            att.local_map = old
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_matches_jax_and_one_device(name, port, inputs):
    assert_layout_matches(port[name], LAYOUTS[name], inputs,
                          ATTENTION[name])
