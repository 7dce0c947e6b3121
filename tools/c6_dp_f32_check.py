#!/usr/bin/env python3
"""The data=W mesh step against the one-device step, in f32 (fault C6).

GPT-2's training recipe (``train_glue``'s: ``shift_inputs``, "dots" remat,
the step's default AdamW, lr 3e-4) for ``--steps`` steps from one seeded
init and one seeded token batch (``chip_smoke._train_tokens``), with the
config's dtype f32 and the plain attention (``RTPU_ATTN_IMPL=xla``), run
three ways:

- the port's ``ShardedTrainStep`` with ``RULES_DP`` on ``data=W``: W
  spawned ranks (gloo on the CPU, NCCL one card a rank), each on its
  ``--rows`` rows;
- the port's one-device ``TrainStep`` on all ``W * rows`` rows (in this
  process: on the CPU while the ranks run, on card 0 after them);
- with ``--jax`` (CPU only), the JAX package's sharded step on ``data=W``
  over W virtual CPU devices, from the same numpy params and batch.

On the card the init is ``train_glue``'s: each run's ``ts.init`` from a
generator on its card seeded with ``SEED``. On the CPU it is a CPU
generator's draw, handed to every run as numpy (the JAX run too). With
``--also-bf16`` the data=W and one-device runs are repeated in the
model's own bf16 compute with the flash kernels: at GPT-2 125M on four
cards that is ``train_glue``'s own run, in which the gap was first
seen.

Prints one JSON line: each run's losses and, per step, the relative gap of
each pair. Run from the repo root:

    JAX_PLATFORMS=cpu python tools/c6_dp_f32_check.py --device cpu \\
        --model gpt2_tiny --rows 4 --seq 64 --jax
    python tools/c6_dp_f32_check.py --device cuda --model gpt2_125m \\
        --also-bf16            # four cards: one rank a card
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Any, Dict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SEED = 0


def _cfg(model, dtype_name):
    import torch

    from ray_tpu_torch.models import configs

    over = {"remat": True, "remat_policy": "dots"}
    if dtype_name == "f32":
        over["dtype"] = torch.float32
    return getattr(configs, model)(**over)


def _params_numpy(cfg):
    """The seeded init, made on the CPU, as the JAX layout's numpy tree:
    the same on every rank and in every run."""
    import torch

    from ray_tpu_torch import convert
    from ray_tpu_torch.models.transformer import init_params

    return convert.params_to_numpy(
        init_params(cfg, torch.Generator().manual_seed(SEED), "cpu"))


def _tokens(cfg, rows, seq):
    import chip_smoke

    return chip_smoke._train_tokens(cfg, rows, seq, "cpu").numpy()


def _init(ts, cfg, job, place):
    """The run's params and optimizer: ``place(numpy tree)`` puts the CPU
    init where the step wants it."""
    import torch

    if job["device"] == "cuda":
        return ts.init(torch.Generator(device=ts.device).manual_seed(SEED))
    params = place(_params_numpy(cfg))
    return params, ts.init_opt_state(params)


def _impl(dtype_name):
    # f32 runs use the plain attention; bf16 runs the model's own path.
    return "xla" if dtype_name == "f32" else "auto"


def _mesh_losses(rank, world, device_type, job):
    import torch

    from ray_tpu_torch import convert, flags
    from ray_tpu_torch.parallel import RULES_DP, MeshSpec, make_mesh
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = _cfg(job["model"], job["dtype"])
    with flags.scoped({"RTPU_ATTN_IMPL": _impl(job["dtype"])}):
        mesh = make_mesh(MeshSpec(data=world), device_type)
        ts = transformer_train_step(cfg, mesh, rules=RULES_DP,
                                    shift_inputs=True)
        params, opt = _init(ts, cfg, job, lambda tree: convert.params_to_mesh(
            tree, cfg, mesh, RULES_DP))
        tokens = torch.from_numpy(
            _tokens(cfg, job["rows"] * world, job["seq"])).to(ts.device)
        batch = ts.shard_batch({"tokens": tokens})
        losses = []
        for _ in range(job["steps"]):
            params, opt, loss = ts.step(params, opt, batch)
            losses.append(float(loss))
    return {"rank": rank, "losses": losses}


def mesh_rank(rank, world, addr, device_type, jobs, results=None):
    """One rank: every job's data=world steps in one process group."""
    import chip_smoke

    def work():
        if device_type == "cpu":
            import torch

            torch.set_num_threads(1)
        out = {"rank": rank}
        for job in jobs:
            out[job["dtype"]] = _mesh_losses(rank, world, device_type,
                                             job)["losses"]
        return out

    return chip_smoke._in_world(rank, world, addr, device_type, results,
                                work)


def one_device_losses(job, world, device):
    import torch

    from ray_tpu_torch import convert, flags
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = _cfg(job["model"], job["dtype"])
    with flags.scoped({"RTPU_ATTN_IMPL": _impl(job["dtype"])}):
        ts = transformer_train_step(cfg, device=device, shift_inputs=True)
        params, opt = _init(ts, cfg, job, lambda tree: convert.params_from_numpy(
            tree, cfg, device))
        batch = {"tokens": torch.from_numpy(
            _tokens(cfg, job["rows"] * world, job["seq"])).to(device)}
        losses = []
        for _ in range(job["steps"]):
            params, opt, loss = ts.step(params, opt, batch)
            losses.append(float(loss))
    return losses


def jax_mesh_losses(job, world):
    """The JAX package's data=world step on virtual CPU devices."""
    from ray_tpu.util.jaxenv import cpu_mesh_env

    cpu_mesh_env(max(8, world))
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import configs as jconfigs
    from ray_tpu.parallel import MeshSpec, make_mesh
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu.train.step import transformer_train_step

    cfg = _cfg(job["model"], job["dtype"])
    jcfg = getattr(jconfigs, job["model"])(dtype=jnp.float32, remat=True,
                                           remat_policy="dots")
    from ray_tpu_torch import flags

    # Both packages read the flag from the environment at call time.
    with flags.scoped({"RTPU_ATTN_IMPL": "xla"}):
        mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
        ts = transformer_train_step(jcfg, mesh, rules=jshd.RULES_DP,
                                    shift_inputs=True)
        params = jax.device_put(_params_numpy(cfg), ts.param_shardings)
        opt = jax.jit(ts.optimizer.init)(params)
        batch = ts.shard_batch({"tokens": _tokens(
            cfg, job["rows"] * world, job["seq"]).astype("int32")})
        losses = []
        for _ in range(job["steps"]):
            params, opt, loss = ts.step(params, opt, batch)
            losses.append(float(loss))
    return losses


def rel_gaps(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def compare(device: str, model: str, world: int, rows: int, seq: int,
            steps: int, jax: bool = False, also_bf16: bool = False
            ) -> Dict[str, Any]:
    """Every run, its losses and the relative gaps of each pair."""
    import chip_smoke

    dtypes = ["f32"] + (["bf16"] if also_bf16 else [])
    jobs = [{"model": model, "dtype": d, "rows": rows, "seq": seq,
             "steps": steps, "device": device} for d in dtypes]
    if device == "cuda":
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        if torch.cuda.device_count() < world:
            raise SystemExit(f"{world} ranks need {world} cards")
        if also_bf16:
            fa.build()
    t0 = time.perf_counter()
    out: Dict[str, Any] = {"model": model, "world": world, "rows": rows,
                           "seq": seq, "steps": steps, "device": device}
    if device == "cpu":
        # The ranks run in spawned processes; the references run here
        # meanwhile.
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        results = ctx.Queue()
        addr = f"localhost:{chip_smoke._free_port()}"
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, world, addr, "cpu", jobs, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for job in jobs:
                out[f"one_device_{job['dtype']}"] = one_device_losses(
                    job, world, "cpu")
            if jax:
                out["jax_mesh_f32"] = jax_mesh_losses(jobs[0], world)
            ranks = [results.get(timeout=1800) for _ in procs]
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
        errors = [r["error"] for r in ranks if "error" in r]
        if errors:
            raise RuntimeError(errors[0])
    else:
        ranks = chip_smoke.run_dist_ranks(world, "cuda", jobs,
                                          timeout_s=1800,
                                          rank_fn=mesh_rank)
        import torch

        chip_smoke.gc_collect()
        for job in jobs:
            out[f"one_device_{job['dtype']}"] = one_device_losses(
                job, world, torch.device("cuda", 0))
        out["card"] = chip_smoke.card_line()
    ranks = sorted(ranks, key=lambda r: r["rank"])
    for d in dtypes:
        out[f"mesh_{d}"] = ranks[0][d]
        out[f"ranks_agree_{d}"] = all(r[d] == ranks[0][d] for r in ranks)
        out[f"gap_mesh_vs_one_device_{d}"] = rel_gaps(
            out[f"mesh_{d}"], out[f"one_device_{d}"])
    if jax:
        out["gap_mesh_vs_jax_mesh_f32"] = rel_gaps(out["mesh_f32"],
                                                   out["jax_mesh_f32"])
        out["gap_jax_mesh_vs_one_device_f32"] = rel_gaps(
            out["jax_mesh_f32"], out["one_device_f32"])
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--model", default="gpt2_125m")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--rows", type=int, default=8, help="rows a rank")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--jax", action="store_true",
                    help="also the JAX package's data=W step (CPU)")
    ap.add_argument("--also-bf16", action="store_true")
    args = ap.parse_args()
    print(json.dumps(compare(args.device, args.model, args.world, args.rows,
                             args.seq, args.steps, args.jax,
                             args.also_bf16)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
