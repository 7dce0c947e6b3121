#!/usr/bin/env python3
"""Where a fresh process's first ViT-L/16 forwards spend their time.

A data pool worker is a fresh process: its first block's four forwards
took 9.6-9.8 s on an H100, against 33 ms each once warm. This script runs,
in a fresh interpreter each time, the steps such a worker takes: import
torch, take the card, load the kernel library, make ViT-L/16's params on
the card, then time each of the first ``--forwards`` forwards at batch 64
(host clock around a synchronised forward). It does so once with CUDA's
default module loading and once with ``CUDA_MODULE_LOADING=EAGER``, and
prints one JSON line per run. Run from the repo root on a card:

    python3 tools/vit_cold_start.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
t_import = time.perf_counter()
torch.cuda.set_device(0)
torch.zeros(1, device="cuda")
t_ctx = time.perf_counter()
sys.path.insert(0, ".")
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.models import vit
fa.build()
t_lib = time.perf_counter()
cfg = vit.vit_l16()
dev = torch.device("cuda", 0)
params = vit.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
x = torch.randn(64, cfg.image_size, cfg.image_size, 3, device=dev)
torch.cuda.synchronize()
t_params = time.perf_counter()
forwards = []
with torch.inference_mode():
    for _ in range({n}):
        t = time.perf_counter()
        vit.forward(params, x, cfg)
        torch.cuda.synchronize()
        forwards.append(time.perf_counter() - t)
print(json.dumps({{"import_torch_s": t_import - t0,
                   "cuda_context_s": t_ctx - t_import,
                   "kernel_library_s": t_lib - t_ctx,
                   "params_s": t_params - t_lib,
                   "forwards_s": forwards}}))
"""


def main() -> int:
    n = 5
    if "--forwards" in sys.argv:
        n = int(sys.argv[sys.argv.index("--forwards") + 1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for loading in ("default", "EAGER"):
        env = dict(os.environ)
        if loading == "EAGER":
            env["CUDA_MODULE_LOADING"] = "EAGER"
        out = subprocess.run([sys.executable, "-c", _CHILD.format(n=n)],
                             capture_output=True, text=True, env=env,
                             timeout=600)
        if out.returncode:
            sys.stderr.write(out.stderr[-3000:])
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"module_loading": loading, "card": card, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
