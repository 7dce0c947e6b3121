#!/usr/bin/env python3
"""Whether torch.profiler records every kernel, read before and after
each of ``chip_smoke.py``'s phases from ``ppo_train`` to ``train_glue``
(the phases ``kernel_time`` runs after), and in a fresh process at the
end; or, with ``--idle S``, before and after S seconds in which the
process does nothing, then after ``ppo_train`` and ``ppo_remote``; or,
with ``--clock S``, every 30 s for S s (then one probe): which of 20 K1
launches the profiler recorded, each recorded kernel's start less its
launch's start on the host (by correlation id), in a window padded 0.1 s
a side and in one opened by ``chip_smoke``'s preface, and the six cases'
device time from CUDA events with the card held while the host queues
(``chip_smoke.held_ms``).

A probe profiles 20 calls each of K1, K2 and SDPA's cuDNN and flash
forwards at the training shape (8, 1024, 16/16, 64, causal) and of K1 and
SDPA's flash forward at ViT-L's (64, 197, 16/16, 64, no mask), three times
each, in a window that closes as the last kernel ends (pad 0), in one
padded 0.1 s a side, and in one opened by the smoke's preface of spin
kernels (``chip_smoke._profiled``): per case the profiler's
device time a call, the CUDA events' time a call, the kernels recorded a
number of times that is not a multiple of 20, and the least time the
card could take (``floor_ms``). One JSON line a probe and pad; a phase
that fails is named and the probes go on. Run from the repo root on a
card:

    python3 tools/profiler_probe.py > probe.txt 2>&1
    python3 tools/profiler_probe.py --idle 180 > idle.txt 2>&1
    python3 tools/profiler_probe.py --clock 240 > clock.txt 2>&1
    python3 tools/profiler_probe.py --probe-only   # one probe, no phases
"""
import json
import subprocess
import sys
import time
import traceback

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

T0 = time.perf_counter()
PAD_S = 0.1


def raw_profile(pad_s):
    """A torch.profiler window with no preface, ``pad_s`` of host sleep on
    either side of the block."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    @contextlib.contextmanager
    def window():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            yield prof
            torch.cuda.synchronize()
            time.sleep(pad_s)
    return window()


def profile_calls(fn, iters, window):
    """``iters`` calls of ``fn`` in the profiler ``window``, with CUDA
    events around them: the device time it records a call (``device_ms``,
    a preface left out), the events' time a call (``event_ms``), and the
    kernels recorded a number of times that is not a multiple of ``iters``
    (``partial``: a record lost)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with window as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    kernels = cs._device_kernels(prof)
    return {"device_ms": sum(e.self_device_time_total
                             for e in kernels) / 1e3 / iters,
            "event_ms": start.elapsed_time(end) / iters,
            "partial": sorted([e.key[:60], e.count] for e in kernels
                              if e.count % iters)}


def cases(fa, device):
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = []
    for B, S, causal in ((cs.TRAIN_BATCH, cs.TRAIN_SEQ, True),
                         (cs.VIT_BATCHES[0], cs.VIT_SEQ, False)):
        H, D = 16, 64
        q, k, v = cs.attn_inputs(7, B, S, H, H, D, device, fused="qkv")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        scale = D ** -0.5
        fwd_floor = (cs.flash_flops(B, S, H, D, causal)
                     / cs.PEAK_BF16_FLOPS * 1e3)
        out.append((f"K1 {(B, S)}", fwd_floor,
                    lambda q=q, k=k, v=v, s=scale, c=causal:
                    fa.flash_attention_fwd(q, k, v, s, c)))
        for backend in ((SDPBackend.CUDNN_ATTENTION,) if causal else ()) + (
                SDPBackend.FLASH_ATTENTION,):
            def sdpa(b=backend, q=qt, k=kt, v=vt, s=scale, c=causal):
                with sdpa_kernel(b):
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=c, scale=s)
            out.append((f"sdpa {backend.name} {(B, S)}", fwd_floor, sdpa))
        if causal:
            args = cs.bwd_inputs(300, B, S, H, H, D, causal, device)
            out.append((f"K2 {(B, S)}",
                        cs.bwd_bound(B, S, H, H, D, causal, 3, True)[0],
                        lambda a=args, s=scale, c=causal:
                        fa.flash_bwd_dq(*a, s, c)))
    return out


def probe(tag, fa, device):
    for pad_s in (0.0, PAD_S, None):
        def window():
            return cs._profiled() if pad_s is None else raw_profile(pad_s)
        rows = {}
        for name, floor_ms, fn in cases(fa, device):
            fn()
            rows[name] = {"floor_ms": floor_ms,
                          "runs": [profile_calls(fn, 20, window())
                                   for _ in range(3)]}
        whole = all(r["device_ms"] and not r["partial"]
                    and row["floor_ms"] <= r["device_ms"] <= r["event_ms"]
                    for row in rows.values() for r in row["runs"])
        print(json.dumps({"probe": tag,
                          "pad_s": "preface" if pad_s is None else pad_s,
                          "t_s": time.perf_counter() - T0, "whole": whole,
                          "cases": rows}), flush=True)


def launches(fa, device, window):
    """One profile of 20 K1 calls at the training shape in ``window``: per
    host launch (in order), whether its kernel was recorded and the
    kernel's start less the launch's start, in microseconds."""
    q, k, v = cs.attn_inputs(7, cs.TRAIN_BATCH, cs.TRAIN_SEQ, 16, 16, 64,
                             device, fused="qkv")
    fa.flash_attention_fwd(q, k, v, 0.125, True)
    with window as prof:
        for _ in range(20):
            fa.flash_attention_fwd(q, k, v, 0.125, True)
    events = list(prof.profiler.kineto_results.events())
    device = {e.correlation_id(): e for e in events
              if e.device_type() != cs_cpu()}
    # K1 launches once a call, after the preface's launches.
    host = sorted((e for e in events if e.device_type() == cs_cpu()
                   and "Launch" in e.name()),
                  key=lambda e: e.start_ns())[-20:]
    out = []
    for e in host:
        kernel = device.get(e.correlation_id())
        out.append(None if kernel is None
                   else (kernel.start_ns() - e.start_ns()) / 1e3)
    return out


def cs_cpu():
    import torch

    return torch.autograd.DeviceType.CPU


def phase(tag, fn, *args):
    try:
        return fn(*args)
    except Exception:  # noqa: BLE001 — reported, the probes go on
        print(json.dumps({"phase_failed": tag,
                          "error": traceback.format_exc()[-2000:]}),
              flush=True)
        return None


if __name__ == "__main__":
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fa.build()
    if sys.argv[1:] == ["--probe-only"]:
        probe("a fresh process", fa, dev)
        sys.exit(0)
    print(cs.card_line(), flush=True)
    if sys.argv[1:2] == ["--clock"]:
        for _ in range(int(float(sys.argv[2]) // 30) + 1):
            t = time.perf_counter()
            held = {}
            for name, floor_ms, fn in cases(fa, dev):
                fn()
                held[name] = [cs.held_ms(fn, 20) for _ in range(3)]
            print(json.dumps({
                "t_s": t - T0,
                "launches": launches(fa, dev, raw_profile(PAD_S)),
                "prefaced": launches(fa, dev, cs._profiled()),
                "held": held}), flush=True)
            time.sleep(max(0.0, 30 - (time.perf_counter() - t)))
        probe(f"after {sys.argv[2]} s", fa, dev)
        sys.exit(0)
    probe("fresh", fa, dev)
    if sys.argv[1:2] == ["--idle"]:
        idle_s = float(sys.argv[2])
        time.sleep(idle_s)
        probe(f"after {idle_s} s idle", fa, dev)
        in_process = phase("ppo_train", cs.phase_ppo_train, dev)
        probe("after ppo_train", fa, dev)
        phase("ppo_remote", cs.phase_ppo_remote, dev, in_process)
        probe("after ppo_remote", fa, dev)
        sys.exit(0)
    in_process = phase("ppo_train", cs.phase_ppo_train, dev)
    probe("after ppo_train", fa, dev)
    phase("ppo_remote", cs.phase_ppo_remote, dev, in_process)
    cs.gc_collect()
    probe("after ppo_remote", fa, dev)
    phase("impala_async", cs.phase_impala_async, dev)
    cs.gc_collect()
    probe("after impala_async", fa, dev)
    phase("dqn_train", cs.phase_dqn_train, dev)
    sac = phase("sac_train", cs.phase_sac_train, dev)
    probe("after dqn_train and sac_train", fa, dev)
    phase("offline_train", cs.phase_offline_train, dev, sac)
    phase("multi_agent_train", cs.phase_multi_agent_train, dev)
    cs.gc_collect()
    probe("after offline_train and multi_agent_train", fa, dev)
    phase("train_glue", cs.phase_train_glue, dev)
    cs.gc_collect()
    probe("after train_glue", fa, dev)
    sys.stdout.flush()
    subprocess.run([sys.executable, __file__, "--probe-only"], check=False)
