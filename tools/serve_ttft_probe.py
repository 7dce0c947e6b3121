#!/usr/bin/env python3
"""Why concurrent requests' first tokens come late on a serving replica.

Run from the repo root on a machine with a card: ``python3
tools/serve_ttft_probe.py``. In one process on card 0, Llama-3-8B (bf16,
from chip_smoke's seed) and chip_smoke's prompts:

1. ``prefill``: the engine's prefill of the 4 first prompts, one after
   another and then from 4 threads at once (each thread's seconds): as
   they come, one at a time under one lock, and at an interpreter switch
   interval of 0.5 ms, with the caching allocator's cudaMalloc calls and
   retries in the free-for-all; all with the kernel library loaded as
   ctypes loads it (``CDLL``: the interpreter lock released for each
   launch) and as a ``PyDLL`` (held);
2. ``engine``: a 4-slot ``ContinuousBatchingEngine`` ticking on its
   thread, the same 4 prompts submitted from 4 threads at once: each
   submit's seconds and TTFT, for both libraries;
3. ``tick``: the decode tick at 4 busy slots alone, and with 4 threads
   polling ``peek`` every 5 ms as the streaming deployment's generators
   do, at the interpreter's default switch interval and at 0.5 ms.

Each prints one JSON line; the card's name and power limit come first.
"""
import ctypes
import json
import os
import statistics
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _concurrent(fn, args_list):
    """Run fn(*args) on one thread each, all at once; each one's seconds."""
    out = [None] * len(args_list)
    barrier = threading.Barrier(len(args_list))

    def run(i):
        barrier.wait()
        t = time.perf_counter()
        fn(*args_list[i])
        out[i] = time.perf_counter() - t

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(args_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def main() -> int:
    import numpy as np
    import torch

    from ray_tpu_torch.models.configs import llama3_8b
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm_engine import ContinuousBatchingEngine

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fa.build()
    print(chip_smoke.card_line(), flush=True)
    cfg = llama3_8b(param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        chip_smoke.SEED), device)
    rng = np.random.default_rng(chip_smoke.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in chip_smoke.PROMPT_LENS][:4]
    eng = ContinuousBatchingEngine(
        cfg, params, num_slots=4, max_prompt_len=chip_smoke.MAX_PROMPT,
        max_new_tokens=chip_smoke.MAX_NEW, device=device)

    def prefill(p):
        padded, length, _, _ = eng._prepare(p)
        eng._prefill_one(params, padded, length)
        torch.cuda.synchronize()

    cdll = fa._kernel_library()
    pydll = ctypes.PyDLL(cdll._name)
    for name in ("rtpu_flash_fwd_bf16", "rtpu_flash_bwd_dq_bf16",
                 "rtpu_flash_bwd_dkv_bf16"):
        getattr(pydll, name).argtypes = getattr(cdll, name).argtypes
        getattr(pydll, name).restype = getattr(cdll, name).restype
    libs = {"CDLL": lambda: cdll, "PyDLL": lambda: pydll}
    original = fa._kernel_library

    one = threading.Lock()

    def prefill_locked(p):
        with one:
            prefill(p)

    def allocator():
        m = torch.cuda.memory_stats(device)
        return (m.get("segment.all.allocated", 0),
                m.get("num_alloc_retries", 0))

    for p in prompts:  # every shape once
        prefill(p)
    rows = {}
    default_switch = sys.getswitchinterval()
    for lib in ("CDLL", "PyDLL", "CDLL", "PyDLL"):
        fa._kernel_library = libs[lib]
        seq = []
        for p in prompts:
            t = time.perf_counter()
            prefill(p)
            seq.append(time.perf_counter() - t)
        before = allocator()
        conc = _concurrent(prefill, [(p,) for p in prompts])
        after = allocator()
        locked = _concurrent(prefill_locked, [(p,) for p in prompts])
        sys.setswitchinterval(0.0005)
        try:
            fast_switch = _concurrent(prefill, [(p,) for p in prompts])
        finally:
            sys.setswitchinterval(default_switch)
        rows.setdefault(lib, []).append({
            "one_at_a_time_s": seq, "four_threads_s": conc,
            "four_threads_cudamallocs": after[0] - before[0],
            "four_threads_alloc_retries": after[1] - before[1],
            "four_threads_one_lock_s": locked,
            "four_threads_switch_0.5ms_s": fast_switch})
    emit = chip_smoke.emit
    emit("ttft_probe_prefill", **rows)

    stop = threading.Event()
    ticker = threading.Thread(target=eng.run_forever, args=(stop,),
                              daemon=True)
    ticker.start()
    rows = {}
    try:
        for lib in ("CDLL", "PyDLL", "CDLL", "PyDLL"):
            fa._kernel_library = libs[lib]
            reqs = [None] * len(prompts)

            def submit(i):
                reqs[i] = eng.submit(prompts[i], max_new_tokens=8)

            submit_s = _concurrent(submit, [(i,) for i in range(4)])
            for r in reqs:
                eng.result(r, timeout=600)
            rows.setdefault(lib, []).append({
                "submit_s": submit_s,
                "ttft_s": [eng.token_stats(r)["ttft_s"] for r in reqs]})
            for r in reqs:
                eng.pop_result(r)
    finally:
        stop.set()
        ticker.join(timeout=60)
        fa._kernel_library = original
    emit("ttft_probe_engine", **rows)

    # The decode tick at 4 busy slots, the ticker stopped, alone and with
    # 4 threads polling peek every 5 ms.
    held = [eng.submit(p) for p in prompts]
    eng.tick()
    rows = {}
    for label, pollers, switch in (("alone", 0, default_switch),
                                   ("4_pollers", 4, default_switch),
                                   ("4_pollers_switch_0.5ms", 4, 0.0005),
                                   ("alone_again", 0, default_switch)):
        sys.setswitchinterval(switch)
        done = threading.Event()

        def poll(r):
            while not done.is_set():
                try:
                    eng.peek(r)
                except KeyError:
                    return
                time.sleep(0.005)

        threads = [threading.Thread(target=poll, args=(held[i],))
                   for i in range(pollers)]
        for t in threads:
            t.start()
        times = []
        for _ in range(12):
            t = time.perf_counter()
            eng.tick()
            times.append((time.perf_counter() - t) * 1e3)
        done.set()
        for t in threads:
            t.join()
        sys.setswitchinterval(default_switch)
        rows[label] = {"tick_ms_median": statistics.median(times),
                       "tick_ms": times}
    for r in held:
        eng.abort(r)
    emit("ttft_probe_tick", **rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
