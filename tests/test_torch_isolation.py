"""The port stands alone: ``ray_tpu_torch`` imports neither ``jax`` nor any
module of the JAX package, and its entry points refuse to fall back to the
CPU on their own."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {repo!r})
import ray_tpu_torch
names = ["ray_tpu_torch"]
for info in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
leaked = sorted(m for m in sys.modules
                if m == "ray_tpu" or m.startswith("ray_tpu.")
                or m == "jax" and sys.modules[m] is not None
                or m.startswith("jax."))
print("IMPORTED", len(names))
print("LEAKED", leaked)
"""


def test_package_imports_without_jax_or_ray_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("IMPORTED", "LEAKED")))
    # ops.flash_attention, models.generate, serve.llm_engine, convert, ...
    assert int(lines["IMPORTED"]) >= 12
    assert lines["LEAKED"] == "[]"


def test_sources_name_no_jax_or_ray_tpu():
    """The textual check behind the import check: no source of the port or
    of chip_smoke.py imports jax or a module of the JAX package."""
    pat = re.compile(r"^\s*(import jax|from jax|import ray_tpu\b(?!_torch)"
                     r"|from ray_tpu\b(?!_torch))", re.M)
    # _build/ holds build outputs (git-ignored), not sources of the port.
    files = sorted(f for f in (REPO / "ray_tpu_torch").rglob("*.py")
                   if "_build" not in f.relative_to(REPO).parts)
    files.append(REPO / "chip_smoke.py")
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert hits == []


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    from ray_tpu_torch.models.configs import llama_tiny
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.serve.llm_engine import ContinuousBatchingEngine

    cfg = llama_tiny(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(cfg, params, num_slots=1, max_prompt_len=8,
                                 max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator().manual_seed(0))
    # Asked for explicitly, the CPU works.
    eng = ContinuousBatchingEngine(cfg, params, num_slots=1,
                                   max_prompt_len=8, max_new_tokens=2,
                                   device="cpu")
    assert eng.device.type == "cpu"
