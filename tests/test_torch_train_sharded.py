"""The port's mesh training path (``transformer_train_step(cfg, mesh=...,
rules=...)``: DTensor params placed by the rule tables, flash attention and
the fused CE on local shards through ``local_map``, sharded checkpoints)
against the JAX package's sharded step and the port's one-device step.

The JAX side runs ``ray_tpu.train.step.transformer_train_step`` on 4 of the
conftest's 8 virtual CPU devices. The port side runs in 4 processes, one
gloo rank each, under one process group started once for the module (a
``file://`` rendezvous in a temporary directory, so parallel test workers
never share a port); the ranks run every case in turn and rank 0 hands the
results back. A spawned rank imports this module again, so the module
imports neither jax nor the JAX package at the top: the JAX side imports
them inside its functions.

Both sides start from the same params (JAX ``init_params`` -> numpy ->
``convert.params_to_mesh``) and the same seeded batch, in f32, and take 3
AdamW steps (a remat case takes one: a policy changes the backward alone,
which the first step's gradients show). Tolerances: each loss within 1e-4
absolute; each leaf's gradient in the first step within 1e-5 relative L2
of the other side's; each param leaf after the steps within 1e-4 relative
L2, and each leaf's update (after minus before) within 1e-3 relative L2
(the bound of tests/test_torch_train.py: Adam's m / sqrt(v) turns
last-digit gradient differences near 0 into up to a step of lr).

The gradients are compared because the params are blind to a constant
factor on a leaf's gradient: AdamW's m / sqrt(v) cancels it. A reduction
that sums where it should average, or a wrong share of the fused CE's
head gradient, moves no loss and no param beyond its bound, and moves the
gradient by the world size.
"""
import multiprocessing
import os
import queue
import traceback

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

WORLD = 4
STEPS = 3
B, S = 8, 16
LOSS_ATOL = 1e-4
# f32 on both sides, summed in other orders: the largest gap measured
# over every case, against either side, is 1.3e-6.
GRAD_REL_L2 = 1e-5
PARAM_REL_L2 = 1e-4
UPDATE_REL_L2 = 1e-3
# Spawning 4 ranks and running every case takes under a minute on an idle
# 8-core CPU; the bound leaves room for a loaded one.
PORT_TIMEOUT_S = 420

# name -> (mesh axes, rules table, model, config overrides, batch, shift)
LAYOUTS = {
    "dp4": (dict(data=4), "RULES_DP", "gpt2_tiny", {}, "masked", False),
    "fsdp4": (dict(fsdp=4), "RULES_FSDP", "llama_tiny", {}, "masked",
              False),
    "fsdp2xtp2": (dict(fsdp=2, tensor=2), "RULES_TP", "llama_tiny", {},
                  "masked", False),
    "fsdp2xtp2_mha": (dict(fsdp=2, tensor=2), "RULES_FSDP", "gpt2_tiny",
                      {}, "masked", False),
    "dp2xfsdp2": (dict(data=2, fsdp=2), "RULES_TP", "llama_tiny",
                  {"tie_embeddings": False}, "masked", False),
    # The fused lm-head + CE, in the shift convention, with a mask that
    # leaves the four batch shards different numbers of valid tokens.
    "fused_ce_unequal": (dict(data=2, fsdp=2), "RULES_FSDP", "llama_tiny",
                         {"fused_ce": True}, "unequal", True),
}
REMAT = [None, "full", "dots", "dots_attn", "min", "half_dots",
         "half_full"]
for _p in REMAT:
    LAYOUTS[f"remat_{_p}"] = (dict(fsdp=2, tensor=2), "RULES_TP",
                              "llama_tiny",
                              {"remat": _p is not None,
                               "remat_policy": _p or "dots"},
                              "masked", False)
MODELS = {"gpt2_tiny": {}, "llama_tiny": {},
          "llama_tiny_untied": {"tie_embeddings": False}}


def _model_key(model, over):
    return model + ("_untied" if over.get("tie_embeddings") is False else "")


def _batches():
    rng = np.random.default_rng(11)
    masked = {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
              "mask": (rng.random((B, S)) > 0.2).astype(np.int32)}
    mask = np.ones((B, S + 1), np.int32)
    mask[0, 4:] = 0     # shard 0 (rows 0-1): 3 + 16 valid targets
    mask[3, 9:] = 0     # shard 1 (rows 2-3): 16 + 8
    unequal = {"tokens": rng.integers(0, 512, (B, S + 1)).astype(np.int32),
               "mask": mask}
    return {"masked": masked, "unequal": unequal}


# ------------------------------------------------------------ port ranks

def _count_kernels(tfa):
    """Wrap the flash entry points the autograd Function calls, counting
    calls and recording the q shapes they see."""
    seen = {"fwd": [], "dq": [], "dkv": []}
    for key, name in (("fwd", "flash_attention_fwd"), ("dq", "flash_bwd_dq"),
                      ("dkv", "flash_bwd_dkv")):
        fn = getattr(tfa, name)

        def counted(q, *args, _fn=fn, _key=key):
            seen[_key].append(tuple(q.shape))
            return _fn(q, *args)
        setattr(tfa, name, counted)
    return seen


def _steps(name):
    return 1 if name.startswith("remat_") else STEPS


def _grads(params):
    """The gradient of every param leaf as numpy, gathered whole."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.parallel import sharding as shd

    return convert.params_to_numpy(shd.tree_map(lambda t: t.grad, params))


def _run_layout(name, inputs):
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.train.step import transformer_train_step

    spec, rules, model, over, batch, shift = LAYOUTS[name]
    mesh = make_mesh(MeshSpec(**spec), "cpu")
    cfg = getattr(configs, model)(dtype=torch.float32, **over)
    rules = getattr(shd, rules)
    ts = transformer_train_step(cfg, mesh=mesh, rules=rules,
                                shift_inputs=shift)
    params = convert.params_to_mesh(
        inputs["params"][_model_key(model, over)], cfg, mesh, rules)
    opt = ts.init_opt_state(params)
    batch = ts.shard_batch(inputs["batches"][batch])
    seen = inputs["seen"]
    for v in seen.values():
        v.clear()
    losses, grads = [], None
    for _ in range(_steps(name)):
        params, opt, loss = ts.step(params, opt, batch)
        assert not isinstance(loss, torch.distributed.tensor.DTensor)
        losses.append(float(loss))
        # The step leaves each leaf's gradient in its placements.
        grads = grads or _grads(params)
    return {"losses": losses, "grads": grads,
            "params": convert.params_to_numpy(params),
            "calls": {k: list(v) for k, v in seen.items()}}


def _run_checkpoint(inputs, path):
    """Two steps under fsdp2xtp2 and a save; then a third step (the
    uninterrupted run), and the same third step after a restore under dp4
    (which reshards every leaf)."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = configs.llama_tiny(dtype=torch.float32)
    tree = inputs["params"]["llama_tiny"]
    batch = inputs["batches"]["masked"]
    out = {}
    ts = transformer_train_step(
        cfg, mesh=make_mesh(MeshSpec(fsdp=2, tensor=2), "cpu"),
        rules=shd.RULES_TP)
    params = convert.params_to_mesh(tree, cfg, ts.mesh, ts.rules)
    opt = ts.init_opt_state(params)
    sharded = ts.shard_batch(batch)
    for _ in range(2):
        params, opt, _ = ts.step(params, opt, sharded)
    ckpt = Checkpoint.save_sharded(ts.state_tree(params, opt), path)
    params, opt, loss = ts.step(params, opt, sharded)
    out["uninterrupted"] = (float(loss), convert.params_to_numpy(params))

    ts = transformer_train_step(cfg, mesh=make_mesh(MeshSpec(data=4), "cpu"),
                                rules=shd.RULES_DP)
    # Other params and a fresh optimizer: the restore overwrites both.
    params, opt = ts.init(torch.Generator().manual_seed(5))
    ckpt.load_sharded(ts.state_tree(params, opt))
    params, opt, loss = ts.step(params, opt, ts.shard_batch(batch))
    out["restored"] = (float(loss), convert.params_to_numpy(params))
    out["files"] = sorted(os.listdir(os.path.join(ckpt.path, "state")))
    return out


def _run_init(inputs):
    """ShardedTrainStep.init against the one-device init_params."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = configs.llama_tiny(dtype=torch.float32)
    ts = transformer_train_step(
        cfg, mesh=make_mesh(MeshSpec(fsdp=2, tensor=2), "cpu"),
        rules=shd.RULES_TP)
    params, opt = ts.init(torch.Generator().manual_seed(3))
    placements = {k: [repr(p) for p in v.placements]
                  for k, v in params["layers"].items()}
    local = {k: tuple(v.to_local().shape)
             for k, v in params["layers"].items()}
    one = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    return {"sharded": convert.params_to_numpy(params),
            "one_device": convert.params_to_numpy(one),
            "placements": placements, "local_shapes": local,
            "state": sorted(opt.state[params["embed"]])}


def _rank_main(rank, init, inputs, ckpt_dir, results):
    """One rank: join the group, run every case, hand rank 0's results
    back. Imports nothing of jax or the JAX package."""
    try:
        torch.set_num_threads(1)
        os.environ["RTPU_ATTN_IMPL"] = "flash"
        import torch.distributed as dist

        from ray_tpu_torch.ops import flash_attention as tfa
        from ray_tpu_torch.parallel import MeshBootstrap

        MeshBootstrap(init, WORLD, rank, device_type="cpu").initialize()
        inputs["seen"] = _count_kernels(tfa)
        out = {name: _run_layout(name, inputs) for name in LAYOUTS}
        out["checkpoint"] = _run_checkpoint(inputs, ckpt_dir)
        out["init"] = _run_init(inputs)
        dist.destroy_process_group()
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))


@pytest.fixture(scope="module")
def inputs():
    import jax

    from ray_tpu.models import configs as jconfigs
    from ray_tpu.models import transformer as jtfm

    params = {}
    for key, over in MODELS.items():
        jcfg = getattr(jconfigs, key.replace("_untied", ""))(
            dtype=jax.numpy.float32, **over)
        params[key] = jax.tree.map(
            np.asarray, jtfm.init_params(jax.random.key(0), jcfg))
    return {"params": params, "batches": _batches()}


def start_ranks(inputs, tmp):
    """Spawn the 4 ranks on every case; returns what :func:`collect`
    waits on."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, f"file://{tmp}/rendezvous", inputs,
                               os.path.join(tmp, "ckpt"), results),
                         daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs, results


def collect(procs, results):
    """Rank 0's results; raises with a rank's traceback if one failed."""
    got, errors = None, []
    try:
        for _ in range(WORLD):
            status, rank, payload = results.get(timeout=PORT_TIMEOUT_S)
            if status == "error":
                errors.append(f"rank {rank}:\n{payload}")
                break
            if rank == 0:
                got = payload
    except queue.Empty:
        errors.append(f"the ranks did not finish in {PORT_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return got


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """Every case on 4 gloo ranks, run once for the module; the JAX side
    of every case runs here meanwhile."""
    ranks = start_ranks(inputs, str(tmp_path_factory.mktemp("mesh")))
    try:
        for name in LAYOUTS:
            _jax_run(name, inputs)
    finally:
        got = collect(*ranks)
    return got


# --------------------------------------------------------------- JAX side

_JAX = {}


def _jax_run(name, inputs):
    """The JAX package's sharded step on 4 virtual devices, as numpy:
    losses, the first step's gradients, params after the steps. Cached:
    the remat cases share one layout."""
    spec, rules, model, over, batch, shift = LAYOUTS[name]
    over = {k: v for k, v in over.items() if not k.startswith("remat")}
    key = (repr(spec), rules, model, repr(over), batch, shift)
    if key not in _JAX:
        _JAX[key] = _jax_steps(spec, rules, model, over, batch, shift,
                               inputs)
    return _JAX[key]


def _jax_steps(spec, rules, model, over, batch, shift, inputs):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import configs as jconfigs
    from ray_tpu.parallel import MeshSpec, make_mesh
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu.train.step import transformer_train_step

    # The step's default AdamW, behind a stage that keeps the gradients it
    # is handed in its state and passes them on unchanged.
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    mesh = make_mesh(MeshSpec(**spec), devices=jax.devices()[:WORLD])
    jcfg = getattr(jconfigs, model)(dtype=jnp.float32, **over)
    ts = transformer_train_step(
        jcfg, mesh, rules=getattr(jshd, rules), shift_inputs=shift,
        optimizer=optax.chain(keep, optax.adamw(3e-4, weight_decay=0.0)))
    tree = inputs["params"][_model_key(model, over)]
    params = jax.device_put(tree, ts.param_shardings)
    opt = jax.jit(ts.optimizer.init)(params)
    sharded = ts.shard_batch(inputs["batches"][batch])
    losses, grads = [], None
    for _ in range(STEPS):
        params, opt, loss = ts.step(params, opt, sharded)
        losses.append(float(loss))
        # A copy: the next step donates this state's buffers.
        grads = grads or jax.tree.map(np.array, opt[0])
    return {"losses": losses, "grads": grads,
            "params": jax.tree.map(np.asarray, params)}


def _one_device_run(name, inputs):
    """The port's one-device step on the same params and batch."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.train.step import transformer_train_step

    spec, rules, model, over, batch, shift = LAYOUTS[name]
    cfg = getattr(configs, model)(dtype=torch.float32, **over)
    params = convert.params_from_numpy(
        inputs["params"][_model_key(model, over)], cfg, "cpu")
    ts = transformer_train_step(cfg, device="cpu", shift_inputs=shift)
    opt = ts.init_opt_state(params)
    tb = {k: torch.from_numpy(v).long()
          for k, v in inputs["batches"][batch].items()}
    losses, grads = [], None
    for _ in range(STEPS):
        params, opt, loss = ts.step(params, opt, tb)
        losses.append(float(loss))
        grads = grads or _grads(params)
    return {"losses": losses, "grads": grads,
            "params": convert.params_to_numpy(params)}


def _leaves(tree):
    out = [(k, v) for k, v in sorted(tree.items()) if k != "layers"]
    return out + [("layers." + k, v)
                  for k, v in sorted(tree["layers"].items())]


def _assert_grads_close(got, want):
    want = dict(_leaves(want))
    assert sorted(dict(_leaves(got))) == sorted(want)
    for name, g in _leaves(got):
        w = np.asarray(want[name])
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL_L2, (name, rel)


def _assert_matches(got, want, start):
    """A mesh run against another run from the same params and batch: its
    losses, its first step's gradients, its params after the steps."""
    n = len(got["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"][:n],
                               atol=LOSS_ATOL, rtol=0)
    _assert_grads_close(got["grads"], want["grads"])
    if n == STEPS:
        _assert_params_close(got["params"], want["params"], start)


def _assert_params_close(got, want, start):
    want = dict(_leaves(want))
    start = dict(_leaves(start))
    assert sorted(dict(_leaves(got))) == sorted(want)
    for name, g in _leaves(got):
        w = np.asarray(want[name])
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= PARAM_REL_L2, (name, rel)
        moved, ref = g - start[name], w - start[name]
        upd = np.linalg.norm(moved - ref) / np.linalg.norm(ref)
        assert upd <= UPDATE_REL_L2, (name, upd)


def _start(inputs, name):
    _, _, model, over, _, _ = LAYOUTS[name]
    return inputs["params"][_model_key(model, over)]


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("name", [n for n in LAYOUTS
                                  if not n.startswith("remat_")])
def test_layout_matches_jax_and_one_device(name, port, inputs):
    got = port[name]
    _assert_matches(got, _jax_run(name, inputs), _start(inputs, name))
    _assert_matches(got, _one_device_run(name, inputs), _start(inputs, name))
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("policy", REMAT)
def test_remat_policy_on_the_mesh(policy, port, inputs):
    """Every remat policy under fsdp2xtp2 gives the JAX package's loss and
    gradients in one step, and runs the flash forward (K1's entry) and
    backward (K2's and K3's) as often a step as on one device (2 layers:
    L, 2L or 3L/2 forwards as in tests/test_torch_train.py, L of each
    backward) on each rank's local shards: q [B/fsdp, S, H/tensor, D]."""
    name = f"remat_{policy}"
    got = port[name]
    assert len(got["losses"]) == 1
    _assert_matches(got, _jax_run(name, inputs), _start(inputs, name))
    L = 2
    fwd = {None: L, "min": L, "full": 2 * L, "dots": 2 * L,
           "dots_attn": 2 * L}.get(policy, L + L // 2)
    calls = got["calls"]
    assert len(calls["fwd"]) == fwd
    assert len(calls["dq"]) == len(calls["dkv"]) == L
    local_q = (B // 2, S, 4 // 2, 128 // 4)
    assert set(calls["fwd"]) | set(calls["dq"]) | set(calls["dkv"]) == {
        local_q}


def test_fused_ce_takes_the_global_mean_over_unequal_shards(port, inputs):
    """The batch shards hold 19, 24, 32 and 32 valid targets. The mesh
    loss is the global mean (what the JAX package and one device give),
    which differs from the mean of the shards' means."""
    from ray_tpu_torch.models import configs
    from ray_tpu_torch.models import transformer as ttfm
    from ray_tpu_torch import convert

    got = port["fused_ce_unequal"]
    mask = inputs["batches"]["unequal"]["mask"][:, 1:]
    counts = mask.reshape(WORLD, -1).sum(1)
    assert sorted(counts) == [19, 24, 32, 32]
    cfg = configs.llama_tiny(dtype=torch.float32, fused_ce=True)
    params = convert.params_from_numpy(inputs["params"]["llama_tiny"], cfg,
                                       "cpu")
    tokens = torch.from_numpy(inputs["batches"]["unequal"]["tokens"]).long()
    tmask = torch.from_numpy(inputs["batches"]["unequal"]["mask"]).long()
    shard_means = [float(ttfm.loss_fn(
        params, {"tokens": tokens[2 * i:2 * i + 2],
                 "mask": tmask[2 * i:2 * i + 2]}, cfg, shift_inputs=True))
        for i in range(WORLD)]
    assert abs(np.mean(shard_means) - got["losses"][0]) > 1e-3
    want = _jax_run("fused_ce_unequal", inputs)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=LOSS_ATOL, rtol=0)
    # The head's gradient is each shard's partial sum, rescaled by its
    # count over the global count.
    _assert_grads_close(got["grads"], want["grads"])


def test_checkpoint_restores_into_another_layout(port):
    """Saved under fsdp2xtp2 after two steps, restored under dp4 (every
    leaf resharded, the AdamW state too): the third step's loss and params
    are the uninterrupted run's. Each rank wrote its own shards."""
    got = port["checkpoint"]
    loss, params = got["uninterrupted"]
    rloss, rparams = got["restored"]
    assert abs(rloss - loss) <= 1e-5
    for name, g in _leaves(rparams):
        w = dict(_leaves(params))[name]
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-6, name
    assert sum(f.endswith(".distcp") for f in got["files"]) == WORLD


def test_sharded_init_is_the_one_device_init(port):
    """ShardedTrainStep.init draws the same params as init_params from the
    same seed, places each leaf as the rules say, and makes the AdamW
    state at once."""
    got = port["init"]
    for name, v in _leaves(got["one_device"]):
        np.testing.assert_array_equal(dict(_leaves(got["sharded"]))[name],
                                      v, err_msg=name)
    assert got["placements"]["wq"] == ["Shard(dim=1)", "Shard(dim=2)"]
    assert got["placements"]["attn_norm"] == ["Replicate()", "Replicate()"]
    # wq [L, d, H, hd] = [2, 128, 4, 32]: d over fsdp, heads over tensor.
    assert got["local_shapes"]["wq"] == (2, 64, 2, 32)
    assert got["state"] == ["exp_avg", "exp_avg_sq", "step"]
