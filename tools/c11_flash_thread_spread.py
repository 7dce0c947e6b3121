#!/usr/bin/env python3
"""Where the spread of ``tests/test_torch_flash_attention.py::
test_forward_and_lse_match_pallas[True-4-4-256-128]`` comes from (CPU).

The case's inputs (seed S + H + KVH, f32, B=1, S=256, H=KVH=4, D=32,
causal, block 128) go through both sides in fresh processes, each pinned
to ``t`` CPUs (``os.sched_setaffinity``, before anything sizes a thread
pool) with ``torch.set_num_threads(t)``, for t = 1..8:

- the port's ``flash_attention_fwd`` (its plain version on the CPU);
- the JAX package's ``_flash_fwd`` (Pallas, interpreted on the CPU).

Each side's o and lse are held to an f64 answer of the same inputs
(numpy, the exact softmax), and the two sides to each other with the
test's criterion (``|a - b| <= 2e-5 + 2e-5 |b|``). Prints one JSON line a
run and a summary: which side moves, the worst excess over the test's
bound, each side's worst distance from f64, and that distance over an
a-priori bound of f32 rounding in any summation order
(:func:`rounding_bound`). Run from the repo root: ``python3
tools/c11_flash_thread_spread.py`` (about two minutes). ``--repeats N``
(default 3) runs each side N times at each thread count, each in a fresh
process; the summary counts the distinct results a side gave. With
``MKL_CBWR=COMPATIBLE`` in the environment (MKL's conditional numerical
reproducibility, which the children inherit) the port's side gave one
result in 32 of 32 runs on the test machine's CPU.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, H, KVH, D, BLOCK, CAUSAL = 1, 256, 4, 4, 32, 128, True
ATOL = RTOL = 2e-5

_CHILD = r"""
import os, sys
os.sched_setaffinity(0, set(range({t})))
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads({t})
q, k, v = (np.load({path!r} + n + ".npy") for n in "qkv")
scale = {D} ** -0.5
if {side!r} == "jax":
    import jax.numpy as jnp
    from ray_tpu.ops.flash_attention import _flash_fwd
    o, lse = _flash_fwd(*(jnp.asarray(x.transpose(0, 2, 1, 3))
                          for x in (q, k, v)), scale, {causal}, {block},
                        {block})
    o = np.asarray(o).transpose(0, 2, 1, 3)
    lse = np.asarray(lse)
else:
    from ray_tpu_torch.ops import flash_attention as tfa
    o, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x)
                                       for x in (q, k, v)), scale,
                                     {causal})
    o, lse = o.numpy(), lse.numpy()
np.save({out!r} + "o.npy", o)
np.save({out!r} + "lse.npy", lse)
"""


def inputs():
    """The test's ``_qkv(S + H + KVH, ...)``."""
    rng = np.random.default_rng(S + H + KVH)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KVH, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KVH, D), dtype=np.float32)
    return q, k, v


def f64_answer(q, k, v):
    """o [B,S,H,D] and lse [B,H,S,1] in f64 (kv head h // (H/KVH))."""
    g = H // KVH
    qf = q.astype(np.float64).transpose(0, 2, 1, 3)
    kf = np.repeat(k.astype(np.float64).transpose(0, 2, 1, 3), g, axis=1)
    vf = np.repeat(v.astype(np.float64).transpose(0, 2, 1, 3), g, axis=1)
    s = qf @ kf.transpose(0, 1, 3, 2) * D ** -0.5
    if CAUSAL:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    return (p @ vf / l).transpose(0, 2, 1, 3), m + np.log(l)


def rounding_bound(q, k, v):
    """An a-priori bound, elementwise, on the distance from the exact o of
    the plain version's f32 algorithm (two products, a softmax over whole
    rows) in ANY summation order (Higham's gamma_n = n u / (1 - n u)):
    the score error gamma_D |q||k| scale moves each weight by a relative
    eta (twice it, through the row max, plus the exp's own rounding), which
    moves o by at most 2 eta max|v|; the row sums add gamma_S of
    (|p| @ |v|) / l and of |o|."""
    u = 2.0 ** -24
    g = H // KVH

    def gamma(n):
        return n * u / (1 - n * u)

    qf = q.astype(np.float64).transpose(0, 2, 1, 3)
    kf = np.repeat(k.astype(np.float64).transpose(0, 2, 1, 3), g, axis=1)
    vf = np.repeat(v.astype(np.float64).transpose(0, 2, 1, 3), g, axis=1)
    scale = D ** -0.5
    s = qf @ kf.transpose(0, 1, 3, 2) * scale
    keep = np.tril(np.ones((S, S), bool))
    ds = gamma(D) * (np.abs(qf) @ np.abs(kf).transpose(0, 1, 3, 2)) * scale
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    l = p.sum(-1, keepdims=True)
    o = p @ vf / l
    eta = 2 * np.where(keep, ds, 0).max(-1, keepdims=True) + 4 * u
    vmax = np.abs(vf).max(-2, keepdims=True)
    bound = (2 * eta * vmax
             + gamma(S) * (p @ np.abs(vf) / l + np.abs(o)))
    return bound.transpose(0, 2, 1, 3)


def excess(a, b):
    """The worst ``|a - b| - (atol + rtol |b|)`` (> 0: the test fails)."""
    return float(np.max(np.abs(a - b) - (ATOL + RTOL * np.abs(b))))


def run(side, t, path, td):
    out = os.path.join(td, f"{side}-{t}-")
    code = _CHILD.format(t=t, repo=REPO, path=path, side=side, D=D,
                         causal=CAUSAL, block=BLOCK, out=out)
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return np.load(out + "o.npy"), np.load(out + "lse.npy")


def main() -> int:
    repeats = 3
    if "--repeats" in sys.argv:
        repeats = int(sys.argv[sys.argv.index("--repeats") + 1])
    q, k, v = inputs()
    o64, lse64 = f64_answer(q, k, v)
    bound = rounding_bound(q, k, v)
    td = tempfile.mkdtemp(prefix="c11-")
    path = os.path.join(td, "in-")
    for n, x in zip("qkv", (q, k, v)):
        np.save(path + n + ".npy", x)
    threads = [t for t in range(1, 9) if t <= os.cpu_count()]
    distinct = {"port": {}, "jax": {}}
    outliers, worst, worst64 = [], -1.0, {"port": 0.0, "jax": 0.0}
    of_bound = {"port": 0.0, "jax": 0.0}
    by_threads = {"port": {}, "jax": {}}
    for t in threads:
        for r in range(repeats):
            got = {side: run(side, t, path, td) for side in ("port", "jax")}
            (po, pl), (jo, jl) = got["port"], got["jax"]
            for side, (o, lse) in got.items():
                key = (o.tobytes(), lse.tobytes())
                distinct[side][key] = distinct[side].get(key, 0) + 1
                by_threads[side].setdefault(t, set()).add(key)
                worst64[side] = max(worst64[side],
                                    float(np.max(np.abs(o - o64))))
                of_bound[side] = max(of_bound[side], float(np.max(
                    np.abs(o - o64) / bound)))
            ex = max(excess(po, jo), excess(pl, jl))
            worst = max(worst, ex)
            if ex > 0:
                outliers.append((t, r))
            print(json.dumps({
                "threads": t, "repeat": r,
                "port_vs_jax_o_max_abs": float(np.max(np.abs(po - jo))),
                "port_vs_jax_lse_max_abs": float(np.max(np.abs(pl - jl))),
                "test_excess_o": excess(po, jo),
                "test_excess_lse": excess(pl, jl),
                "port_o_vs_f64": float(np.max(np.abs(po - o64))),
                "jax_o_vs_f64": float(np.max(np.abs(jo - o64))),
                "port_lse_vs_f64": float(np.max(np.abs(pl - lse64))),
                "jax_lse_vs_f64": float(np.max(np.abs(jl - lse64)))}),
                flush=True)
    print(json.dumps({
        "summary": True, "runs_per_side": len(threads) * repeats,
        # A side "moves" where two runs, at one thread count or at two,
        # gave different bits.
        "moves": {side: len(d) > 1 for side, d in distinct.items()},
        "distinct_results": {side: sorted(d.values())
                             for side, d in distinct.items()},
        "distinct_at_one_thread_count": {
            side: {t: len(keys) for t, keys in d.items() if len(keys) > 1}
            for side, d in by_threads.items()},
        "runs_past_the_test_bound": outliers,
        "worst_test_excess": worst, "worst_o_vs_f64": worst64,
        # Above 1: farther from f64 than any summation order of the f32
        # algorithm can take it.
        "worst_o_error_over_rounding_bound": of_bound,
        "rounding_bound_o_max": float(bound.max()),
        "rounding_bound_o_median": float(np.median(bound))}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
