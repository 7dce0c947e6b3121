#!/usr/bin/env python3
"""``chip_smoke.py``'s Train phases alone, on every visible card up to 4:
the kernels' build, ``train_glue`` (MNIST and GPT-2 125M through
``TorchTrainer``), then ``data_ingest`` (GPT-2 125M from a shuffled
TFRecord dataset by ``split_shard`` and by a ``streaming_split``, held
against the bare step on the same batches: bit for bit on one card,
within ``GLUE_LOSS_RTOL`` of the bare data=W step on more). Each prints
its JSON line; the exit code is 1 if a phase failed. Run from the repo
root, on four cards for the data=W mesh:

    python3 tools/data_ingest_phases.py > ingest.txt 2>&1
"""
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    fa.build()
    cs.emit("build", ok=True, seconds=time.perf_counter() - t0,
            cards=torch.cuda.device_count())
    print(cs.card_line(), flush=True)
    _, glue_tokens_per_s, _ = cs.phase_train_glue(dev)
    cs.gc_collect()
    launches = cs.phase_data_ingest(dev, glue_tokens_per_s)
    print(f"data_ingest launches over the ranks: {launches}", flush=True)
