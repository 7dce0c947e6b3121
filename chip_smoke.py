#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit; the hand-written kernels are built from the
checkout's sources at first use (into ``ray_tpu_torch/_build/``). It imports
nothing of JAX or of the JAX package. Each phase prints one JSON line:

1. ``build``: builds the flash-attention kernels (K1, the forward,
   replacing the Pallas ``_fwd_kernel``; K2 and K3, the backward, replacing
   ``_dq_kernel`` and ``_dkv_kernel``), one nvcc per source at once, and
   prints the build seconds; then a raw line with the card's name and
   power limit, as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. ``kernel_check`` (twice): K1, then K2 and K3, against their plain
   PyTorch versions on the card, in bf16, on seeded numpy inputs: causal
   and not, MHA and GQA (K3 also with groups wider than one thread-block
   cluster), head dims 32, 64 and 128, sequence lengths with a ragged tail
   and below one tile, q/k/v as strided views of a fused projection and as
   views whose rows past S hold NaN, every prefill bucket the serving slice
   runs and the training shape.
3. ``slice``: the main path. Llama-3-8B at full width and depth (bf16
   weights, random from a seed) behind a ``ContinuousBatchingEngine`` with
   4 slots, ticking on its ``run_forever`` thread; 6 greedy requests, the
   later ones attaching mid-flight and the last two blocking for a slot.
   Checks every budget, token range and logit, that K1 ran 32 times per
   prefill, and that one prefill's logits with K1 agree with the same
   prefill under the plain attention. Prints tokens/s, and the decode-tick
   time at 4 busy slots, timed after the run with the ticker stopped.
4. ``prefill_time`` and ``profile``: each prefill bucket's time; the
   device busy time and idle share of a decode tick and of two prefills
   (torch.profiler).
5. ``train``: the training main path. ``bench_350m(remat=True,
   remat_policy="dots")`` at full width and depth (f32 params, bf16
   compute) through ``transformer_train_step`` with the default AdamW:
   batch 8, seq 1024, ``shift_inputs``, one seeded token batch; 2 warm-up
   and 10 timed steps. Checks finite, falling losses, the first near
   ln(vocab), and that each step launched K1 48 times (24 layers, and
   again under "dots" remat) and K2 and K3 24 times each. Prints step ms,
   tokens/s, an MFU-style share, peak memory, and one profiled step.
6. ``dist_train``: the mesh training path. The same model, batch and
   seed through ``transformer_train_step(cfg, mesh=make_mesh(
   MeshSpec(fsdp=-1)), rules=RULES_FSDP)``: params and AdamW state as
   DTensors, K1/K2/K3 on each rank's local shards through ``local_map``.
   One rank per visible card, up to 4: with one card it runs in this
   process on a world-1 NCCL group, with more it spawns one process a
   card. 2 warm-up and 3 timed steps. Checks 48/24/24 K1/K2/K3 launches a
   step and that the 5 losses equal the first 5 of ``train`` (bit for bit
   on one card; within 1e-3 relative on more, where the batch shards'
   gradients are summed in another order). Prints step ms beside
   ``train``'s (the host cost of DTensor dispatch), peak memory per rank
   and one profiled step.
7. ``train_grad_check``: one step's gradients of bench_350m at depth 2,
   batch 2, seq 1024 with the kernels (bf16), with the plain attention
   (bf16) and with the plain attention in f32, compared per leaf.
8. ``kernel_time``: K1, K2, K3 and K2+K3 together (each with its
   achieved TFLOP/s) at the serving and training shapes beside their plain
   versions, the SDPA forward or backward (the yardstick, never used by
   the port: device time on contiguous copies, each backend that takes
   them pinned in turn, the fastest reported) and their bounds.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. A
failed phase raises: the script exits non-zero and prints no result line.

Without a CUDA card, or outside a checkout of the repo, it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time

SEED = 0
# Prompt lengths of the slice's requests: buckets 8, 128, 1024, 2048, 2048
# and 64, so every attach shape from the smallest bucket to a full prompt.
PROMPT_LENS = (5, 100, 700, 1500, 2048, 37)
NUM_SLOTS, MAX_PROMPT, MAX_NEW = 4, 2048, 64
# K1's timed serving shapes: buckets the slice runs (8, 64, 128, 1024 and
# 2048 in all).
TIMED_SEQ = (128, 1024, 2048)
DECODE_TICKS = 16  # timed ticks at 4 busy slots (< MAX_NEW - 1)
# Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): dense
# bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel against plain: p is rounded to bf16 before p.v (as on the TPU),
# so o agrees to a few bf16 ulps; lse is kept in f32.
O_ATOL = O_RTOL = 2e-2
LSE_ATOL = 1e-3
# K2/K3 against the plain f32 backward, per tensor (dq, dk, dv): relative
# L2. p and ds are rounded to bf16 before their products, as on the TPU.
GRAD_REL_L2 = 2e-2
# The training phase: bench_350m at full width and depth.
TRAIN_BATCH, TRAIN_SEQ, WARM_STEPS, TIMED_STEPS = 8, 1024, 2, 10
# dist_train: steps on the mesh, at most this many ranks, and its losses
# against train's first ones. On one card the mesh path runs the same bf16
# model on the same whole batch, so its losses must be train's exactly; on
# more it sums the batch shards' gradients in another order, and they must
# agree within DIST_LOSS_RTOL (relative).
DIST_WARM_STEPS, DIST_TIMED_STEPS, DIST_MAX_RANKS = 2, 3, 4
DIST_LOSS_RTOL = 1e-3
# train_grad_check: one step's gradients, per leaf. The kernel run against
# the plain-attention bf16 run (relative L2), and the kernel run may lie at
# most 1.5 times as far from the f32 run as the plain bf16 run does.
GRAD_CHECK_LAYERS, GRAD_CHECK_BATCH = 2, 2
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_GRAD_F32_RATIO = 1.5
# One prefill's last-position logits (relative L2). K1 and the plain
# attention run the same bf16 model and differ only in the attention's
# rounding, a few bf16 ulps of o in each of 32 layers; through 32 layers of
# random weights that reaches about 2e-2 (measured on the H100), so the
# bound is 5e-2. And K1's bf16 run may lie at most 1.5 times as far from
# the same prefill in f32 as the plain attention's bf16 run does.
LOGITS_REL_L2 = 5e-2
LOGITS_F32_RATIO = 1.5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_flops(B, S, H, D, causal):
    """q.k^T and p.v at 2 flops a multiply-add over the (query, key) pairs
    the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4.0 * B * H * D * pairs


def flash_bound(B, S, H, KVH, D, causal):
    """Least time for one forward: q.k^T and p.v at 2 flops a multiply-add
    over the (query, key) pairs the mask keeps, against q/k/v read once and
    o/lse written once. Returns (ms, "operations" | "bytes")."""
    flops = flash_flops(B, S, H, D, causal)
    nbytes = 2.0 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 4.0 * B * H * S
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def attn_inputs(seed, B, S, H, KVH, D, device, fused=""):
    """Seeded bf16 q/k/v [B, S, heads, D]. With ``fused="kv"`` k and v are
    views into one [B, S, 2, KVH, D] tensor, the layout the model's fused
    k/v projection (``wkv``, GQA) hands to attention; with ``fused="qkv"``
    q, k and v are views into one [B, S, 3, H, D] tensor, that of the fused
    ``wqkv`` projection (MHA, the training model); with ``fused="nan"``
    each is the [:, :S] view of a [B, S + 64, heads, D] tensor whose rows
    past S hold NaN."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, torch.bfloat16)

    if fused == "nan":
        out = []
        for heads in (H, KVH, KVH):
            x = t((B, S + 64, heads, D))
            x[:, S:] = float("nan")
            out.append(x[:, :S])
        return tuple(out)
    if fused == "qkv":
        qkv = t((B, S, 3, H, D))
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = t((B, S, H, D))
    if fused == "kv":
        kv = t((B, S, 2, KVH, D))
        return q, kv[:, :, 0], kv[:, :, 1]
    return q, t((B, S, KVH, D)), t((B, S, KVH, D))


def phase_kernel_check(fa, bucket_len, device):
    import torch

    cases = []
    for H, KVH, D in ((16, 16, 64), (32, 8, 128)):
        for S in (96, 192, 2048):
            for causal in (True, False):
                cases.append((2 if S < 2048 else 1, S, H, KVH, D, causal,
                              ""))
    cases.append((1, 100, 4, 2, 32, True, ""))
    # Ragged lengths: below one 128-key tile, and tails past a multiple of
    # it; MHA, GQA 32/8 and 4/2 at each head dim.
    for H, KVH, D in ((16, 16, 64), (32, 8, 128), (4, 2, 32)):
        for S in (5, 37, 130, 1000):
            cases.append((2, S, H, KVH, D, True, ""))
    buckets = sorted({bucket_len(n, MAX_PROMPT) for n in PROMPT_LENS})
    cases += [(1, S, 32, 8, 128, True, "kv") for S in buckets]
    # The training shape, q/k/v as views of the fused wqkv projection.
    cases.append((TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, True, "qkv"))
    # q/k/v as [:, :S] views of [B, S + 64, heads, D] tensors whose rows
    # past S hold NaN: the kernel must never read past S.
    cases += [(2, 100, H, KVH, D, True, "nan")
              for H, KVH, D in ((32, 8, 128), (16, 16, 64), (4, 2, 32))]
    worst_o = worst_lse = 0.0
    rows = []
    for i, (B, S, H, KVH, D, causal, fused) in enumerate(cases):
        q, k, v = attn_inputs(100 + i, B, S, H, KVH, D, device, fused)
        o, lse = fa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
        o, po = o.float(), po.float()
        o_err = float((o - po).abs().max())
        lse_err = float((lse - plse).abs().max())
        o_ok = bool(((o - po).abs() <= O_ATOL + O_RTOL * po.abs()).all()
                    and torch.isfinite(o).all() and torch.isfinite(lse).all())
        rows.append({"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                     "causal": causal, "fused": fused,
                     "o_err": o_err, "lse_err": lse_err})
        if not (o_ok and lse_err <= LSE_ATOL):
            emit("kernel_check", ok=False, failed=rows[-1])
            raise AssertionError(f"K1 disagrees with its plain version: "
                                 f"{rows[-1]}")
        worst_o, worst_lse = max(worst_o, o_err), max(worst_lse, lse_err)
    emit("kernel_check", kernel="flash_fwd", ok=True, cases=rows,
         o_atol=O_ATOL, o_rtol=O_RTOL,
         lse_atol=LSE_ATOL, max_o_err=worst_o, max_lse_err=worst_lse)
    return worst_o


def bwd_inputs(seed, B, S, H, KVH, D, causal, device, fused=""):
    """Seeded bf16 q/k/v/do and f32 lse/delta for the backward. With
    ``fused="qkv"`` q, k and v are views into one [B, S, H + 2 KVH, D]
    tensor, the layout of the model's fused projection; with
    ``fused="nan"`` q, k, v and do are the [:, :S] views of [B, S + 64,
    heads, D] tensors whose rows past S hold NaN. lse and delta come from
    the plain forward, so kernel and plain version get the same inputs."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, torch.bfloat16)

    def nan_tail(heads):
        x = t((B, S + 64, heads, D))
        x[:, S:] = float("nan")
        return x[:, :S]

    if fused == "nan":
        q, k, v, do = nan_tail(H), nan_tail(KVH), nan_tail(KVH), nan_tail(H)
    else:
        if fused == "qkv":
            qkv = t((B, S, H + 2 * KVH, D))
            q, k, v = (qkv[:, :, :H], qkv[:, :, H:H + KVH],
                       qkv[:, :, H + KVH:])
        else:
            q, k, v = t((B, S, H, D)), t((B, S, KVH, D)), t((B, S, KVH, D))
        do = t((B, S, H, D))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
    return q, k, v, do, lse, fa.attention_delta(do, o)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_kernel_check_bwd(fa, device):
    """K2 (dq) and K3 (dk, dv) against the plain backward, per tensor."""
    import torch

    # K1's grid: lengths below one tile and ragged tails past it, each head
    # dim, MHA and GQA groups of 4 and 2 (K3 spreads a group over a
    # cluster), causal and not.
    cases = [(2, S, H, KVH, D, causal, "")
             for H, KVH in ((16, 16), (32, 8), (4, 2))
             for D in (32, 64, 128)
             for S in (5, 37, 130, 1000)
             for causal in (True, False)]
    # Groups past the portable cluster size: 16/1 takes 2 heads a block on
    # clusters of 8, 24/2 2 heads a block on clusters of 6.
    cases += [(1, 300, 16, 1, 64, True, ""), (1, 300, 24, 2, 128, False, "")]
    # q/k/v as views of the fused projection, and views whose rows past S
    # hold NaN (the kernels must never read past S); the training shape.
    cases += [(2, 130, 16, 16, 64, True, "qkv"),
              (1, 192, 32, 8, 128, False, "qkv")]
    cases += [(2, 100, H, KVH, D, causal, "nan")
              for H, KVH, D in ((32, 8, 128), (16, 16, 64), (4, 2, 32))
              for causal in (True, False)]
    cases.append((TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, True, "qkv"))
    rows = []
    worst = {"dq": 0.0, "dkv": 0.0}
    for i, (B, S, H, KVH, D, causal, fused) in enumerate(cases):
        args = bwd_inputs(200 + i, B, S, H, KVH, D, causal, device, fused)
        got = fa.flash_bwd_core(*args, scale=D ** -0.5, causal=causal)
        want = fa.flash_attention_bwd_plain(*args, D ** -0.5, causal)
        row = {"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
               "causal": causal, "fused": fused}
        ok = True
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.float() - w.float()).abs().max())
            rel = rel_l2(g, w)
            row[name + "_max_abs"], row[name + "_rel_l2"] = err, rel
            ok &= bool(torch.isfinite(g).all()) and rel <= GRAD_REL_L2
            key = "dq" if name == "dq" else "dkv"
            worst[key] = max(worst[key], err)
        rows.append(row)
        if not ok:
            emit("kernel_check", kernel="flash_bwd", ok=False, failed=row)
            raise AssertionError(f"K2/K3 disagree with their plain "
                                 f"version: {row}")
    emit("kernel_check", kernel="flash_bwd", ok=True, cases=rows,
         rel_l2_tol=GRAD_REL_L2, max_dq_err=worst["dq"],
         max_dkv_err=worst["dkv"],
         max_rel_l2={n: max(r[n + "_rel_l2"] for r in rows)
                     for n in ("dq", "dk", "dv")})
    return worst


def phase_slice(device):
    """The main path: the engine serving 6 requests on Llama-3-8B."""
    import numpy as np
    import torch

    from ray_tpu_torch.models.configs import llama3_8b
    from ray_tpu_torch.models.generate import prefill
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm_engine import (ContinuousBatchingEngine,
                                                bucket_len)

    cfg = llama3_8b(param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ContinuousBatchingEngine(
        cfg, params, num_slots=NUM_SLOTS, max_prompt_len=MAX_PROMPT,
        max_new_tokens=MAX_NEW, seed=SEED, model="llama3_8b", device=device)

    # Instrumentation around the engine's own units, no change to them:
    # tick times (host clock; a tick ends by reading its tokens, which
    # waits for the device), each prefill's logits, and a device-side
    # running check that every decode logit is finite.
    ticks = []
    prefills = []
    finite = torch.ones((), dtype=torch.bool, device=device)
    tick, step, prefill_one = eng.tick, eng._tick, eng._prefill_one

    def timed_tick():
        active = sum(eng.active)
        t = time.perf_counter()
        n = tick()
        if active:
            ticks.append((active, time.perf_counter() - t))
        return n

    def checked_step(*args):
        nxt, logits, cache = step(*args)
        finite.logical_and_(torch.isfinite(logits).all())
        return nxt, logits, cache

    def recorded_prefill(p, tokens, length):
        out = prefill_one(p, tokens, length)
        prefills.append((int(tokens.shape[1]), int(length[0]), out[0]))
        return out

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    eng.tick, eng._tick, eng._prefill_one = (timed_tick, checked_step,
                                             recorded_prefill)
    stop = threading.Event()
    ticker = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    fa.flash_attention_fwd.launches = 0  # count the main path alone
    ticker.start()
    try:
        t0 = time.perf_counter()
        reqs = []
        for prompt in prompts:
            ticks_before = len(ticks)
            r = eng.submit(prompt, timeout=600)
            # A slot frees only when a request retires: a submit that
            # returns after an earlier request is done waited for a slot.
            reqs.append({"req": r, "prompt_len": len(prompt),
                         "bucket": bucket_len(len(prompt), MAX_PROMPT),
                         "ticks_before_attach": len(ticks),
                         "ticks_during_submit": len(ticks) - ticks_before,
                         "earlier_done_at_attach": sum(
                             eng.is_done(x["req"]) for x in reqs)})
        outs = [eng.result(x["req"], timeout=600) for x in reqs]
        wall = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches
    finally:
        stop.set()
        ticker.join(timeout=60)
    if ticker.is_alive() or eng.failed is not None:
        raise RuntimeError(f"engine ticker did not stop cleanly: "
                           f"{eng.failed!r}")
    eng.tick, eng._tick, eng._prefill_one = tick, step, prefill_one

    failures = []
    for x, out in zip(reqs, outs):
        x["tokens"] = len(out)
        if len(out) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                          for t in out):
            failures.append(f"request {x['req']}: {len(out)} tokens, "
                            f"first {out[:8]}")
    if not bool(finite):
        failures.append("a decode tick produced NaN or inf logits")
    for S, n, logits in prefills:
        if not bool(torch.isfinite(logits).all()):
            failures.append(f"prefill S={S} produced non-finite logits")
    if len(prefills) != len(PROMPT_LENS) or launches != (
            cfg.n_layers * len(prefills)):
        failures.append(f"K1 launched {launches} times for {len(prefills)} "
                        f"prefills of {cfg.n_layers} layers")
    mid_flight = sum(x["ticks_before_attach"] > 0 for x in reqs)
    waited = sum(x["earlier_done_at_attach"] > 0 for x in reqs)
    if mid_flight < 2 or waited < 2:
        failures.append(f"expected >= 2 mid-flight attaches and >= 2 slot "
                        f"waits, got {mid_flight} and {waited}")

    # One prompt's prefill logits with K1 (from the engine's run) against
    # the same prefill under the plain attention, and both against the same
    # prefill computed in f32 (the bf16 weights cast up at use), which
    # shows how far apart two bf16 runs of this model fall anyway.
    S_ref, n_ref, k1_logits = next(p for p in prefills if p[1] == 700)
    tokens = torch.zeros((1, S_ref), dtype=torch.int64, device=device)
    tokens[0, :n_ref] = torch.tensor(prompts[PROMPT_LENS.index(700)])
    length = torch.tensor([n_ref], device=device)
    old = os.environ.get("RTPU_ATTN_IMPL")
    os.environ["RTPU_ATTN_IMPL"] = "xla"
    try:
        plain_logits = prefill(params, tokens, cfg, S_ref,
                               lengths=length)[0][0]
        f32_logits = prefill(params, tokens,
                             dataclasses.replace(cfg, dtype=torch.float32),
                             S_ref, lengths=length)[0][0]
    finally:
        if old is None:
            os.environ.pop("RTPU_ATTN_IMPL")
        else:
            os.environ["RTPU_ATTN_IMPL"] = old

    k1_vs_plain = rel_l2(k1_logits, plain_logits)
    k1_vs_f32 = rel_l2(k1_logits, f32_logits)
    plain_vs_f32 = rel_l2(plain_logits, f32_logits)
    if not (k1_vs_plain <= LOGITS_REL_L2
            and k1_vs_f32 <= LOGITS_F32_RATIO * plain_vs_f32):
        failures.append(f"prefill logits: K1 vs plain {k1_vs_plain} (tol "
                        f"{LOGITS_REL_L2}); vs f32 K1 {k1_vs_f32}, plain "
                        f"{plain_vs_f32} (ratio tol {LOGITS_F32_RATIO})")

    # Which ticks of the run above had every slot busy depends on how the
    # prefills on the submitting thread interleave with the ticker, so the
    # gap between tokens at 4 busy slots is timed apart: 4 requests
    # attached, the ticker stopped, no prefill alongside. A tick ends by
    # reading its tokens to the host, so the host clock spans its device
    # work.
    run_four = [dt for active, dt in ticks if active == NUM_SLOTS]
    held = [eng.submit(p) for p in prompts[:NUM_SLOTS]]
    eng.tick()  # warm
    four = []
    for _ in range(DECODE_TICKS):
        t = time.perf_counter()
        if eng.tick() != NUM_SLOTS:
            failures.append("a timed decode tick had a slot retire")
        four.append(time.perf_counter() - t)
    for r in held:
        eng.abort(r)
    tick_ms = statistics.median(four) * 1e3
    emit("slice", ok=not failures, failures=failures, model="llama3_8b",
         param_dtype=str(cfg.param_dtype).replace("torch.", ""),
         n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
         n_kv_heads=cfg.kv_heads, d_ff=cfg.ff_dim, vocab=cfg.vocab_size,
         num_params=cfg.num_params(), init_s=init_s,
         num_slots=NUM_SLOTS, max_prompt_len=MAX_PROMPT,
         max_new_tokens=MAX_NEW, requests=reqs, prefills=len(prefills),
         k1_launches=launches, ticks=len(ticks),
         run_ticks_at_4_slots=len(run_four),
         run_tick_ms_4_slots_median=(statistics.median(run_four) * 1e3
                                     if run_four else None),
         decode_ticks_timed=len(four),
         decode_tick_ms_4_slots_median=tick_ms,
         decode_tokens_per_s_4_slots=(NUM_SLOTS * 1e3 / tick_ms
                                      if tick_ms else None),
         wall_s=wall, tokens=sum(len(o) for o in outs),
         tokens_per_s=sum(len(o) for o in outs) / wall,
         prefill_logits={
             "prompt_len": n_ref, "bucket": S_ref,
             "k1_vs_plain_rel_l2": k1_vs_plain, "tol": LOGITS_REL_L2,
             "k1_vs_f32_rel_l2": k1_vs_f32,
             "plain_vs_f32_rel_l2": plain_vs_f32,
             "f32_ratio_tol": LOGITS_F32_RATIO,
             "k1_vs_plain_max_abs": float(
                 (k1_logits - plain_logits).abs().max()),
             "same_argmax_k1_plain_f32": [
                 int(k1_logits.argmax()), int(plain_logits.argmax()),
                 int(f32_logits.argmax())]},
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    if failures:
        raise AssertionError("; ".join(failures))
    return cfg, params, prompts, launches, eng, tick_ms / 1e3


def phase_prefill_time(cfg, params, prompts, device):
    import torch

    from ray_tpu_torch.models.generate import prefill
    from ray_tpu_torch.serve.llm_engine import bucket_len

    rows = []
    for prompt in sorted(prompts, key=len):
        S = bucket_len(len(prompt), MAX_PROMPT)
        if any(r["bucket"] == S for r in rows):
            continue
        tokens = torch.zeros((1, S), dtype=torch.int64, device=device)
        tokens[0, :len(prompt)] = torch.tensor(prompt)
        length = torch.tensor([len(prompt)], device=device)
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(params, tokens, cfg, S, lengths=length)
            torch.cuda.synchronize()
            if i:  # the first call warms up
                times.append((time.perf_counter() - t) * 1e3)
        rows.append({"bucket": S, "prompt_len": len(prompt),
                     "ms_median": statistics.median(times), "ms": times})
    emit("prefill_time", model="llama3_8b", rows=rows)


def _device_profile(fn):
    """Run ``fn`` under torch.profiler; returns (device busy ms, every
    kernel as [name, ms], by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    return busy_us / 1e3, [[e.key[:80], e.self_device_time_total / 1e3]
                           for e in kernels]


def phase_profile(cfg, params, prompts, eng, tick_s, device):
    """Device busy time of one decode tick at 4 busy slots and of one
    prefill per bucket, from torch.profiler, against the same work timed
    without the profiler: idle share = 1 - busy / unprofiled time."""
    import torch

    from ray_tpu_torch.models.generate import prefill
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm_engine import bucket_len

    reqs = [eng.submit(p) for p in prompts[:NUM_SLOTS]]
    eng.tick()  # warm
    busy, top = _device_profile(lambda: [eng.tick() for _ in range(3)])
    # A profiler that records no device time gives None, not an idle card.
    tick = {"busy_ms": busy / 3, "unprofiled_ms": tick_s * 1e3,
            "idle_share": 1 - busy / 3 / (tick_s * 1e3) if busy else None,
            "top_kernels_ms_per_3_ticks": top[:6]}
    for r in reqs:
        eng.abort(r)
    rows = []
    for n in (5, 2048):
        S = bucket_len(n, MAX_PROMPT)
        tokens = torch.zeros((1, S), dtype=torch.int64, device=device)
        tokens[0, :n] = torch.tensor(prompts[PROMPT_LENS.index(n)])
        length = torch.tensor([n], device=device)
        run = lambda: prefill(params, tokens, cfg, S, lengths=length)
        run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        busy, top = _device_profile(run)
        k1_ms = sum(ms for name, ms in top if "flash_fwd" in name)
        rows.append({"bucket": S, "busy_ms": busy, "unprofiled_ms": wall_ms,
                     "idle_share": 1 - busy / wall_ms if busy else None,
                     "k1_share_of_busy": k1_ms / busy if busy else None,
                     "top_kernels_ms": top[:6]})
    emit("profile", decode_tick_4_slots=tick, prefill=rows)


def _launch_counts(fa):
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _zero_launch_counts(fa):
    fa.flash_attention_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def _train_tokens(cfg, B, S, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))).to(
        device)


def phase_train(fa, device):
    """The training main path: bench_350m, full width and depth."""
    import math

    import torch

    from ray_tpu_torch.models.configs import bench_350m
    from ray_tpu_torch.train.step import transformer_train_step

    cfg = bench_350m(remat=True, remat_policy="dots")
    ts = transformer_train_step(cfg, device=device, shift_inputs=True)
    torch.cuda.reset_peak_memory_stats(device)
    params, opt = ts.init(torch.Generator(device=device).manual_seed(SEED))
    batch = {"tokens": _train_tokens(cfg, TRAIN_BATCH, TRAIN_SEQ, device)}
    losses = []
    _zero_launch_counts(fa)  # count the main path alone
    for _ in range(WARM_STEPS):
        params, opt, loss = ts.step(params, opt, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        params, opt, loss = ts.step(params, opt, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = _launch_counts(fa)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    losses = [float(x) for x in losses]

    steps = WARM_STEPS + TIMED_STEPS
    want = {"flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    failures = []
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"non-finite loss: {losses}")
    elif abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        failures.append(f"first loss {losses[0]} is not within 0.5 of "
                        f"ln({cfg.vocab_size})")
    elif not losses[-1] < losses[0]:
        failures.append(f"loss did not fall: {losses}")
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")

    # One profiled step: device busy time against the unprofiled step.
    busy, top = _device_profile(lambda: ts.step(params, opt, batch))
    shares = {name: (sum(ms for k, ms in top if name + "_kernel" in k) / busy
                     if busy else None)
              for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / step_s
    emit("train", ok=not failures, failures=failures, model="bench_350m",
         n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
         vocab=cfg.vocab_size, num_params=cfg.num_params(),
         remat_policy=cfg.remat_policy, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         warm_steps=WARM_STEPS, timed_steps=TIMED_STEPS, losses=losses,
         launches=launches, launches_per_step={
             k: v / steps for k, v in launches.items()},
         step_ms=step_s * 1e3, tokens_per_s=tok_s,
         mfu_bf16_dense=tok_s * cfg.flops_per_token(TRAIN_SEQ)
         / PEAK_BF16_FLOPS,
         flops_per_token=cfg.flops_per_token(TRAIN_SEQ),
         peak_mem_gib=peak_gib,
         profile={"busy_ms": busy, "unprofiled_ms": step_s * 1e3,
                  "idle_share": 1 - busy / (step_s * 1e3) if busy else None,
                  "kernel_share_of_busy": shares,
                  "top_kernels_ms": top[:10]})
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, losses, step_s


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dist_train_rank(rank, world, addr, device_type, cfg, batch, seq,
                    results=None):
    """One rank of ``dist_train``: join the world, train on the fsdp mesh,
    return (or put on ``results``) this rank's numbers. Launch counts are
    read around the steps alone."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (RULES_FSDP, MeshBootstrap, MeshSpec,
                                        make_mesh)
    from ray_tpu_torch.train.step import transformer_train_step

    try:
        MeshBootstrap(addr, world, rank, local_rank=rank,
                      device_type=device_type).initialize()
        try:
            mesh = make_mesh(MeshSpec(fsdp=-1), device_type)
            ts = transformer_train_step(cfg, mesh=mesh, rules=RULES_FSDP,
                                        shift_inputs=True)
            device = ts.device
            cuda = device.type == "cuda"
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            gen = torch.Generator(device=device).manual_seed(SEED)
            params, opt = ts.init(gen)
            tokens = _train_tokens(cfg, batch, seq, device)
            sharded = ts.shard_batch({"tokens": tokens})
            local_batch = tuple(sharded["tokens"].to_local().shape)
            losses = []
            _zero_launch_counts(fa)  # count the main path alone
            for _ in range(DIST_WARM_STEPS):
                params, opt, loss = ts.step(params, opt, sharded)
                losses.append(loss)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DIST_TIMED_STEPS):
                params, opt, loss = ts.step(params, opt, sharded)
                losses.append(loss)
            if cuda:
                torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / DIST_TIMED_STEPS
            launches = _launch_counts(fa)
            out = {"rank": rank, "world": world, "losses":
                   [float(x) for x in losses], "step_s": step_s,
                   "launches": launches, "local_tokens": local_batch,
                   "placements": {k: repr(tuple(v.placements)) for k, v in
                                  params["layers"].items()}}
            if cuda:
                out["peak_mem_gib"] = (torch.cuda.max_memory_allocated(device)
                                       / 2 ** 30)
                busy, top = _device_profile(
                    lambda: ts.step(params, opt, sharded))
                # NCCL work shows twice (its "nccl:" annotation and its
                # kernel), and a collective's kernel waits for its peers:
                # it is reported apart, and compute alone is busy time.
                nccl = sum(ms for k, ms in top if k.startswith("ncclDev"))
                busy -= sum(ms for k, ms in top if k.startswith("nccl"))
                out["profile"] = {
                    "compute_busy_ms": busy, "nccl_kernel_ms": nccl,
                    "unprofiled_ms": step_s * 1e3,
                    "idle_share": 1 - busy / (step_s * 1e3) if busy else None,
                    "top_kernels_ms": top[:12]}
        finally:
            dist.destroy_process_group()
    except BaseException:
        if results is None:
            raise
        import traceback
        results.put({"rank": rank, "error": traceback.format_exc()})
        return None
    if results is not None:
        results.put(out)
    return out


def phase_dist_train(device, train_losses, train_step_s):
    """The mesh training path: bench_350m on an fsdp mesh of every visible
    card (up to 4)."""
    import multiprocessing

    import torch

    from ray_tpu_torch.models.configs import bench_350m

    cfg = bench_350m(remat=True, remat_policy="dots")
    world = min(torch.cuda.device_count(), DIST_MAX_RANKS)
    addr = f"localhost:{_free_port()}"
    args = (world, addr, "cuda", cfg, TRAIN_BATCH, TRAIN_SEQ)
    if world == 1:
        ranks = [dist_train_rank(0, *args)]
    else:
        ctx = multiprocessing.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=dist_train_rank, args=(r, *args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            ranks = [results.get(timeout=600) for _ in range(world)]
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
        errors = [r["error"] for r in ranks if "error" in r]
        if errors:
            raise RuntimeError("a dist_train rank failed:\n" + errors[0])
        ranks.sort(key=lambda r: r["rank"])
    lead = ranks[0]
    steps = DIST_WARM_STEPS + DIST_TIMED_STEPS
    want = {"flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    ref = train_losses[:steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(lead["losses"], ref)]
    rtol = DIST_LOSS_RTOL if world > 1 else 0.0
    failures = []
    for r in ranks:
        if r["launches"] != want:
            failures.append(f"rank {r['rank']} launches {r['launches']}, "
                            f"expected {want}")
        if r["losses"] != lead["losses"]:
            failures.append(f"rank {r['rank']} losses {r['losses']} differ "
                            f"from rank 0's")
    if not max(rel) <= rtol:
        failures.append(f"losses {lead['losses']} against train's {ref}: "
                        f"relative {rel} (tol {rtol})")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit("dist_train", ok=not failures, failures=failures,
         model="bench_350m", n_layers=cfg.n_layers,
         remat_policy=cfg.remat_policy, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         mesh={"fsdp": world}, rules="RULES_FSDP", world=world,
         local_tokens=lead["local_tokens"], placements=lead["placements"],
         warm_steps=DIST_WARM_STEPS, timed_steps=DIST_TIMED_STEPS,
         losses=lead["losses"], train_losses=ref, loss_rel_diff=rel,
         loss_rtol=rtol, launches=lead["launches"],
         launches_per_step={k: v / steps for k, v in lead["launches"].items()},
         step_ms=lead["step_s"] * 1e3, train_step_ms=train_step_s * 1e3,
         step_ratio=lead["step_s"] / train_step_s,
         tokens_per_s=tokens / lead["step_s"],
         peak_mem_gib_per_rank=[r["peak_mem_gib"] for r in ranks],
         profile=lead["profile"])
    if failures:
        raise AssertionError("; ".join(failures))
    return lead["launches"]


def phase_train_grad_check(device):
    """One step's gradients of bench_350m (depth 2) three ways: kernels in
    bf16, plain attention in bf16, plain attention in f32."""
    import torch

    from ray_tpu_torch.models.configs import bench_350m
    from ray_tpu_torch.models.transformer import init_params, loss_fn
    from ray_tpu_torch.train.step import param_leaves

    cfg = bench_350m(remat=True, remat_policy="dots",
                     n_layers=GRAD_CHECK_LAYERS)
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    leaves = param_leaves(params)
    names = ([k for k in params if k != "layers"]
             + ["layers." + k for k in params["layers"]])
    for t in leaves:
        t.requires_grad_(True)
    batch = {"tokens": _train_tokens(cfg, GRAD_CHECK_BATCH, TRAIN_SEQ,
                                     device)}

    def grads(impl, c):
        old = os.environ.get("RTPU_ATTN_IMPL")
        os.environ["RTPU_ATTN_IMPL"] = impl
        try:
            loss = loss_fn(params, batch, c, shift_inputs=True)
            return torch.autograd.grad(loss, leaves)
        finally:
            if old is None:
                os.environ.pop("RTPU_ATTN_IMPL")
            else:
                os.environ["RTPU_ATTN_IMPL"] = old

    kernel = grads("auto", cfg)
    plain = grads("xla", cfg)
    f32 = grads("xla", dataclasses.replace(cfg, dtype=torch.float32))
    rows, failures = [], []
    for name, g_k, g_p, g_f in zip(names, kernel, plain, f32):
        row = {"leaf": name, "kernel_vs_plain": rel_l2(g_k, g_p),
               "kernel_vs_f32": rel_l2(g_k, g_f),
               "plain_vs_f32": rel_l2(g_p, g_f)}
        rows.append(row)
        if not (row["kernel_vs_plain"] <= TRAIN_GRAD_REL_L2
                and row["kernel_vs_f32"]
                <= TRAIN_GRAD_F32_RATIO * row["plain_vs_f32"]):
            failures.append(row)
    emit("train_grad_check", ok=not failures, model="bench_350m",
         n_layers=cfg.n_layers, batch=GRAD_CHECK_BATCH, seq=TRAIN_SEQ,
         rel_l2_tol=TRAIN_GRAD_REL_L2, f32_ratio_tol=TRAIN_GRAD_F32_RATIO,
         leaves=rows, failures=failures)
    if failures:
        raise AssertionError(f"gradients disagree: {failures}")


def bwd_flops(B, S, H, D, causal, products):
    """K2 (3 products) or K3 (4): 2 flops a multiply-add over the (query,
    key) pairs the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2.0 * products * B * H * D * pairs


def bwd_bound(B, S, H, KVH, D, causal, products, writes_q):
    """Least time for K2 (3 products, writes dq) or K3 (4 products, writes
    dk and dv): 2 flops a multiply-add over the (query, key) pairs the mask
    keeps, against q/k/v/do read once, lse/delta read once, outputs
    written once. Returns (ms, "operations" | "bytes")."""
    flops = bwd_flops(B, S, H, D, causal, products)
    nbytes = (2.0 * (2 * B * S * H * D + 2 * B * S * KVH * D)
              + 8.0 * B * H * S
              + 2.0 * (B * S * H * D if writes_q else 2 * B * S * KVH * D))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn``: the kernel time torch.profiler records
    over ``iters`` calls, without the host's gaps between them. A profile
    that records no device time at all (once in about ten runs on the
    H100, for an SDPA call) is taken again, up to three times."""
    fn()  # warm
    for _ in range(3):
        busy, _ = _device_profile(lambda: [fn() for _ in range(iters)])
        if busy:
            return busy / iters
    raise RuntimeError("torch.profiler recorded no device time")


def sdpa_times(q, k, v, scale, do=None, iters=20):
    """The library yardstick: ``F.scaled_dot_product_attention`` on
    contiguous [B, H, S, D] copies of q/k/v, pinned in turn to each backend
    that takes them; with ``do``, its backward alone on a retained graph
    (one call computes dq, dk and dv). Device time (``device_ms``): a
    Python autograd call is host-bound at these sizes, and its host time
    moved 0.29-0.90 ms between calls. Returns {backend: ms}."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    grad = do is not None
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(grad)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous() if grad else None
    gqa = k.shape[2] != q.shape[2]
    times = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def fwd(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale, enable_gqa=gqa)

        def bwd(out):
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
        try:  # a backend that does not take these inputs raises
            out = fwd()
            if grad:
                bwd(out)
        except RuntimeError:
            continue
        times[backend.name] = device_ms(
            (lambda: bwd(out)) if grad else fwd, iters)
    if not times:
        raise RuntimeError(f"no fast SDPA backend takes q {tuple(qt.shape)}, "
                           f"k {tuple(kt.shape)}")
    return times


def _library_fields(times):
    best = min(times, key=times.get)
    return {"library_ms": times[best], "library_backend": best,
            "library_ms_by_backend": times}


def phase_kernel_time(fa, device):
    # K1 at the serving shapes, then at the training one (q/k/v as views of
    # the fused wqkv projection, as the training path hands them over).
    # ms: CUDA events over back-to-back launches; device_ms: profiler.
    rows = []
    shapes = [(1, S, 32, 8, 128, "kv") for S in TIMED_SEQ]
    shapes.append((TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, "qkv"))
    for B, S, H, KVH, D, fused in shapes:
        q, k, v = attn_inputs(7, B, S, H, KVH, D, device, fused=fused)
        scale = D ** -0.5
        iters = 50 if B * S <= 2048 else 20
        kernel = lambda: fa.flash_attention_fwd(q, k, v, scale, True)
        ms = cuda_ms(kernel, iters=iters)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_fwd_plain(q, k, v, scale, True),
            iters=10 if B * S <= 2048 else 3)
        bound_ms, bound_by = flash_bound(B, S, H, KVH, D, True)
        rows.append({"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                     "causal": True, "ms": ms,
                     "device_ms": device_ms(kernel, iters),
                     "plain_ms": plain_ms,
                     **_library_fields(sdpa_times(q, k, v, scale,
                                                  iters=iters)),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "roofline_share": bound_ms / ms})
        # Achieved rate: the operations the mask keeps over device time.
        rows[-1]["tflops"] = flash_flops(B, S, H, D, True) / (
            rows[-1]["device_ms"] * 1e9)
    serve_row = rows[len(TIMED_SEQ) - 1]
    emit("kernel_time", kernel="flash_fwd", l2_flushed=False, rows=rows)

    # K2 and K3 at the training shape and at Llama-3-8B's prefill shape,
    # beside the SDPA backward (dq, dk and dv together).
    bwd_rows = []
    for i, (B, S, H, KVH, D) in enumerate(((TRAIN_BATCH, TRAIN_SEQ, 16, 16,
                                            64), (1, 2048, 32, 8, 128))):
        args = bwd_inputs(300 + i, B, S, H, KVH, D, True, device,
                          fused="qkv" if KVH != H else "")
        scale = D ** -0.5
        library = _library_fields(sdpa_times(*args[:3], scale, do=args[3]))
        both = lambda: (fa.flash_bwd_dq(*args, scale, True),
                        fa.flash_bwd_dkv(*args, scale, True))
        # K2 and K3 one after the other, as the backward runs them, beside
        # the one SDPA call that computes all three gradients; the bound is
        # the sum of theirs.
        for name, kernel, plain, products in (
                ("flash_bwd_dq", lambda: fa.flash_bwd_dq(*args, scale, True),
                 fa.flash_bwd_dq_plain, (3,)),
                ("flash_bwd_dkv",
                 lambda: fa.flash_bwd_dkv(*args, scale, True),
                 fa.flash_bwd_dkv_plain, (4,)),
                ("flash_bwd_dq+dkv", both, fa.flash_attention_bwd_plain,
                 (3, 4))):
            ms = cuda_ms(kernel, iters=20)
            plain_ms = cuda_ms(lambda: plain(*args, scale, True), iters=3)
            bounds = [bwd_bound(B, S, H, KVH, D, True, n, n == 3)
                      for n in products]
            bound_ms = sum(b[0] for b in bounds)
            dev_ms = device_ms(kernel, 20)
            bwd_rows.append({
                "kernel": name, "B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                "causal": True, "ms": ms, "device_ms": dev_ms,
                "tflops": sum(bwd_flops(B, S, H, D, True, n)
                              for n in products) / (dev_ms * 1e9),
                "plain_ms": plain_ms, **library,
                "library": "sdpa backward (dq, dk, dv together)",
                "bound_ms": bound_ms,
                "bound_by": "+".join(b[1] for b in bounds),
                "roofline_share": bound_ms / ms})
    emit("kernel_time", kernel="flash_bwd", l2_flushed=False, rows=bwd_rows)
    # The kernels line: K1 at its serving shape, K2/K3 at the training one.
    return serve_row, {r["kernel"]: r for r in bwd_rows if r["S"] == TRAIN_SEQ}


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm_engine import bucket_len

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    fa.build()
    emit("build", ok=True, kernels=["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"],
         seconds=time.perf_counter() - t0, torch=torch.__version__,
         cuda=torch.version.cuda)
    print(card_line(), flush=True)

    max_err = phase_kernel_check(fa, bucket_len, device)
    bwd_err = phase_kernel_check_bwd(fa, device)
    cfg, params, prompts, serve_launches, eng, tick_s = phase_slice(device)
    phase_prefill_time(cfg, params, prompts, device)
    phase_profile(cfg, params, prompts, eng, tick_s, device)
    # The serving model (16 GB) leaves the card before training starts.
    del cfg, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_losses, train_step_s = phase_train(fa, device)
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches = phase_dist_train(device, train_losses, train_step_s)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_grad_check(device)
    fwd_timed, bwd_timed = phase_kernel_time(fa, device)

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:47",
        "launches": (serve_launches + train_launches["flash_fwd"]
                     + dist_launches["flash_fwd"]),
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches["flash_fwd"],
                             "dist_train": dist_launches["flash_fwd"]},
        "max_abs_err": max_err,
        "ms": fwd_timed["ms"],
        "device_ms": fwd_timed["device_ms"],
        "plain_ms": fwd_timed["plain_ms"],
        "bound_ms": fwd_timed["bound_ms"],
        "bound_by": fwd_timed["bound_by"],
        "library_ms": fwd_timed["library_ms"],
        "library_backend": fwd_timed["library_backend"],
    }]
    for name, line, err in (("flash_bwd_dq", 157, bwd_err["dq"]),
                            ("flash_bwd_dkv", 207, bwd_err["dkv"])):
        timed = bwd_timed[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name] + dist_launches[name],
            "launches_by_path": {"train": train_launches[name],
                                 "dist_train": dist_launches[name]},
            "max_abs_err": err,
            "ms": timed["ms"],
            "device_ms": timed["device_ms"],
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "library_backend": timed["library_backend"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
