#!/usr/bin/env python3
"""What a fresh process of the port pays before its first work: each
import in a new interpreter (``--runs`` times), with the machine's own
bytecode setting and then with a bytecode cache under
``ray_tpu_torch/_build/pycache`` (as ``chip_smoke.keep_bytecode`` sets
it; the first run with the cache writes it); then, where a card is
present, in one new process: CUDA's start, the kernel library's load
(``flash_attention.build``) and the first two K1 launches. One JSON line
each. Run from the repo root:

    python3 tools/process_start_probe.py --runs 3 > start.txt 2>&1
"""
import argparse
import json
import os
import subprocess
import sys
import time

IMPORTS = {
    "python": "pass",
    "torch": "import torch",
    "model_stack": ("import ray_tpu_torch.models.transformer, "
                    "ray_tpu_torch.train.step, "
                    "ray_tpu_torch.ops.flash_attention"),
    "rllib_ppo": "import ray_tpu_torch.rllib.algorithms.ppo",
}

CARD = r"""
import json, time
t = time.perf_counter()
import torch
out = {"import_torch_s": time.perf_counter() - t}
t = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
out["cuda_start_s"] = time.perf_counter() - t
from ray_tpu_torch.ops import flash_attention as fa
t = time.perf_counter()
fa.build()
out["kernel_library_s"] = time.perf_counter() - t
q = torch.randn(1, 128, 4, 64, device="cuda", dtype=torch.bfloat16)
for key in ("first_k1_s", "second_k1_s"):
    t = time.perf_counter()
    fa.flash_attention_fwd(q, q, q, 0.125, True)
    torch.cuda.synchronize()
    out[key] = time.perf_counter() - t
print(json.dumps(out))
"""


def timed(code, env):
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True)
    return time.perf_counter() - t, proc


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = dict(os.environ, PYTHONPATH=repo)
    cached = dict(base, PYTHONPYCACHEPREFIX=os.path.join(
        repo, "ray_tpu_torch", "_build", "pycache"))
    cached.pop("PYTHONDONTWRITEBYTECODE", None)
    for mode, env in (("as_set", base), ("bytecode_cache", cached)):
        for name, code in IMPORTS.items():
            runs = [timed(code, env)[0] for _ in range(args.runs)]
            print(json.dumps({
                "mode": mode, "import": name, "seconds": runs,
                "PYTHONDONTWRITEBYTECODE": env.get(
                    "PYTHONDONTWRITEBYTECODE")}), flush=True)
    import torch

    if torch.cuda.is_available():
        seconds, proc = timed(CARD, cached)
        if proc.returncode:
            print(proc.stderr[-2000:], file=sys.stderr)
            sys.exit(1)
        print(json.dumps({"mode": "bytecode_cache", "process_s": seconds,
                          **json.loads(proc.stdout.strip().splitlines()[-1])}),
              flush=True)
