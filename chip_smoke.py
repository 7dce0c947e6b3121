#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit; the hand-written kernels are built from the
checkout's sources at first use (into ``ray_tpu_torch/_build/``). It imports
nothing of JAX or of the JAX package. Each phase prints one JSON line:

1. ``build``: builds the flash-attention forward kernel (K1, replacing the
   Pallas ``_fwd_kernel``) and prints the build seconds; then a raw line
   with the card's name and power limit, as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. ``kernel_check``: K1 against its plain PyTorch version on the card, in
   bf16, on seeded numpy inputs: causal and not, MHA and GQA, sequence
   lengths with a ragged tail, and every prefill bucket the slice runs.
3. ``slice``: the main path. Llama-3-8B at full width and depth (bf16
   weights, random from a seed) behind a ``ContinuousBatchingEngine`` with
   4 slots, ticking on its ``run_forever`` thread; 6 greedy requests, the
   later ones attaching mid-flight and the last two blocking for a slot.
   Checks every budget, token range and logit, that K1 ran 32 times per
   prefill, and that one prefill's logits with K1 agree with the same
   prefill under the plain attention. Prints tokens/s, and the decode-tick
   time at 4 busy slots, timed after the run with the ticker stopped.
4. ``prefill_time``, ``profile`` and ``kernel_time``: each prefill bucket's
   time; the device busy time and idle share of a decode tick and of two
   prefills (torch.profiler); K1 at the slice's shapes beside its plain
   version, SDPA (the yardstick, never used by the port) and its bound.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. A
failed phase raises: the script exits non-zero and prints no result line.
Without a CUDA card, or outside a checkout of the repo, it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
TIMED_SEQ = (128, 512, 2048)
DECODE_TICKS = 16  # timed ticks at 4 busy slots (< MAX_NEW - 1)
# Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): dense
# bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel against plain: p is rounded to bf16 before p.v (as on the TPU),
# so o agrees to a few bf16 ulps; lse is kept in f32.
O_ATOL = O_RTOL = 2e-2
LSE_ATOL = 1e-3
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
    return out.strip().splitlines()[0]


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


def flash_bound(B, S, H, KVH, D, causal):
    """Least time for one forward: q.k^T and p.v at 2 flops a multiply-add
    over the (query, key) pairs the mask keeps, against q/k/v read once and
    o/lse written once. Returns (ms, "operations" | "bytes")."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * H * D * pairs
    nbytes = 2.0 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 4.0 * B * H * S
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def attn_inputs(seed, B, S, H, KVH, D, device, fused_kv=False):
    """Seeded bf16 q/k/v [B, S, heads, D]. With ``fused_kv`` k and v are
    views into one [B, S, 2, KVH, D] tensor, the layout the model's fused
    k/v projection hands to attention."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, torch.bfloat16)

    q = t((B, S, H, D))
    if fused_kv:
        kv = t((B, S, 2, KVH, D))
        return q, kv[:, :, 0], kv[:, :, 1]
    return q, t((B, S, KVH, D)), t((B, S, KVH, D))


def phase_kernel_check(fa, bucket_len, device):
    cases = []
    for H, KVH, D in ((16, 16, 64), (32, 8, 128)):
        for S in (96, 192, 2048):
            for causal in (True, False):
                cases.append((2 if S < 2048 else 1, S, H, KVH, D, causal,
                              False))
    cases.append((1, 100, 4, 2, 32, True, False))
    buckets = sorted({bucket_len(n, MAX_PROMPT) for n in PROMPT_LENS})
    cases += [(1, S, 32, 8, 128, True, True) for S in buckets]
    worst_o = worst_lse = 0.0
    rows = []
    for i, (B, S, H, KVH, D, causal, fused) in enumerate(cases):
        q, k, v = attn_inputs(100 + i, B, S, H, KVH, D, device, fused)
        o, lse = fa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
        o, po = o.float(), po.float()
        o_err = float((o - po).abs().max())
        lse_err = float((lse - plse).abs().max())
        o_ok = bool(((o - po).abs() <= O_ATOL + O_RTOL * po.abs()).all())
        rows.append({"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                     "causal": causal, "fused_kv": fused,
                     "o_err": o_err, "lse_err": lse_err})
        if not (o_ok and lse_err <= LSE_ATOL):
            emit("kernel_check", ok=False, failed=rows[-1])
            raise AssertionError(f"K1 disagrees with its plain version: "
                                 f"{rows[-1]}")
        worst_o, worst_lse = max(worst_o, o_err), max(worst_lse, lse_err)
    emit("kernel_check", ok=True, cases=rows, o_atol=O_ATOL, o_rtol=O_RTOL,
         lse_atol=LSE_ATOL, max_o_err=worst_o, max_lse_err=worst_lse)
    return worst_o


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

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

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


def phase_kernel_time(fa, device):
    import torch
    import torch.nn.functional as F

    rows = []
    H, KVH, D = 32, 8, 128
    for S in TIMED_SEQ:
        q, k, v = attn_inputs(7, 1, S, H, KVH, D, device, fused_kv=True)
        scale = D ** -0.5
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, scale, True),
                     iters=50)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_fwd_plain(q, k, v, scale, True),
            iters=10)
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True),
            iters=50)
        bound_ms, bound_by = flash_bound(1, S, H, KVH, D, True)
        rows.append({"B": 1, "S": S, "H": H, "KVH": KVH, "D": D,
                     "causal": True, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "roofline_share": bound_ms / ms})
    emit("kernel_time", kernel="flash_fwd", l2_flushed=False, rows=rows)
    return rows[-1]


def main() -> int:
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
    emit("build", ok=True, kernels=["flash_fwd"],
         seconds=time.perf_counter() - t0, torch=torch.__version__,
         cuda=torch.version.cuda)
    card = card_line()
    print(card, flush=True)

    max_err = phase_kernel_check(fa, bucket_len, device)
    cfg, params, prompts, launches, eng, tick_s = phase_slice(device)
    phase_prefill_time(cfg, params, prompts, device)
    phase_profile(cfg, params, prompts, eng, tick_s, device)
    timed = phase_kernel_time(fa, device)

    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:47",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
