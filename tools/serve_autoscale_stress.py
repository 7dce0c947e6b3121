#!/usr/bin/env python3
"""chip_smoke.py's ``serve_autoscale`` phase again and again, each pass
on a fresh replica, counting the connections to replicas that failed.

Run from the repo root on a machine with a card: ``python3
tools/serve_autoscale_stress.py [--passes N]`` (default 5; one card:
about 40 s a pass after chip_smoke's ``slice``, which makes the witness).
Each pass starts 8 streams at once on a new replica, the case where a
replica's listener meets its most concurrent connects. Every failed
``ReplicaClient.open`` is recorded with its cause; the script prints, per
pass, the phase's line, the failed connects (count, the first causes) and
last ``AUTOSCALE_OK k of N``. It exits non-zero where a pass failed.
"""
import argparse
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=5)
    passes = ap.parse_args().passes

    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve import replica

    failed_opens = []
    open_ = replica.ReplicaClient.open

    def traced_open(self, *args, **kwargs):
        try:
            return open_(self, *args, **kwargs)
        except BaseException as e:
            failed_opens.append("".join(traceback.format_exception_only(
                e.__cause__ or e)).strip())
            raise

    replica.ReplicaClient.open = traced_open
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fa.build()
    print(chip_smoke.card_line(), flush=True)
    cfg, _, prompts, witness, _, _, _ = chip_smoke.phase_slice(device)
    ok = 0
    try:
        for i in range(passes):
            failed_opens.clear()
            t = time.perf_counter()
            try:
                chip_smoke.phase_serve_autoscale(cfg, prompts, witness)
                ok += 1
            except AssertionError as e:
                print(f"FAILED pass {i}: {str(e)[:1000]}", flush=True)
            print(f"FAILED_OPENS pass {i}: {len(failed_opens)} "
                  f"{sorted(set(failed_opens))[:3]} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
    finally:
        serve.shutdown()
    print(f"AUTOSCALE_OK {ok} of {passes}", flush=True)
    return 0 if ok == passes else 1


if __name__ == "__main__":
    sys.exit(main())
