"""The port stands alone: ``ray_tpu_torch`` imports neither ``jax`` nor any
module of the JAX package (nor gymnasium, but inside the functions that
build a gymnasium env), and its entry points refuse to fall back to the
CPU on their own."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["gymnasium"] = None    # and `import gymnasium`
sys.modules["ray_tpu"] = None      # and any module of the JAX package
sys.path.insert(0, {repo!r})
import ray_tpu_torch
names = ["ray_tpu_torch"]
for info in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if m in ("ray_tpu", "jax") and sys.modules[m] is not None
                or m.startswith(("ray_tpu.", "jax.")))
print("IMPORTED", len(names))
print("NAMES", " ".join(names))
print("LEAKED", leaked)
"""


def test_package_imports_without_jax_or_ray_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("IMPORTED", "LEAKED", "NAMES")))
    # ops.flash_attention, models.generate, serve.llm_engine, convert,
    # models.vit, rllib.* ... and chip_smoke.py
    assert int(lines["IMPORTED"]) >= 30
    assert lines["LEAKED"] == "[]"
    rl = "ray_tpu_torch.rllib."
    assert {rl + m for m in (
        "utils.replay_buffers", "algorithms.dqn", "algorithms.sac",
        "offline", "offline.io", "offline.bc", "offline.cql",
        "offline.marwil", "env.multi_agent_env")} <= set(
            lines["NAMES"].split())


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


def test_vit_and_rl_entry_points_raise_when_cuda_is_absent(monkeypatch):
    """ViT's init_params, the env runner, the learner and PPOConfig.build:
    the card unless the caller asks for the CPU."""
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import MLPModule
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
    from ray_tpu_torch.rllib.env.vector_env import CartPoleBatchedEnv

    def creator(n):
        return CartPoleBatchedEnv(n)
    creator.makes_batched_env = True

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cases = [
        lambda **kw: vit.init_params(torch.Generator().manual_seed(0),
                                     vit.vit_tiny(), **kw),
        lambda **kw: SingleAgentEnvRunner(creator, lambda: MLPModule(4, 2),
                                          num_envs=2, **kw),
        lambda **kw: PPOLearner(MLPModule(4, 2), PPOConfig(), **kw),
        lambda **kw: PPOConfig().environment(env_creator=creator)
        .resources(**kw).build(),
    ]
    for make in cases:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        make(device="cpu")


def test_offpolicy_offline_and_multi_agent_entry_points_raise_without_cuda(
        monkeypatch):
    """DQN, SAC, CQL, BC and MARWIL (their configs' build and learners)
    and PPO over a MultiAgentBatchedEnv: the card unless the caller asks
    for the CPU."""
    import chip_smoke
    from ray_tpu_torch.rllib.algorithms.dqn import (DQNConfig, DQNLearner,
                                                    DQNModule)
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.algorithms.sac import (SACConfig, SACLearner,
                                                    SACModule)
    from ray_tpu_torch.rllib.env.multi_agent_env import (
        make_multi_agent_creator)
    from ray_tpu_torch.rllib.env.vector_env import CartPoleBatchedEnv
    from ray_tpu_torch.rllib.offline import BCConfig, CQLConfig, MARWILConfig

    cartpole = chip_smoke.batched_creator(CartPoleBatchedEnv)
    pendulum = chip_smoke.batched_creator(chip_smoke.PendulumBatchedEnv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def build(cfg, creator):
        return lambda **kw: cfg().environment(env_creator=creator).resources(
            **kw).build()

    cases = [
        build(DQNConfig, cartpole), build(SACConfig, pendulum),
        build(CQLConfig, pendulum), build(BCConfig, cartpole),
        build(MARWILConfig, cartpole),
        build(PPOConfig, make_multi_agent_creator(chip_smoke.TwoAgentEnv)),
        lambda **kw: DQNLearner(DQNModule(4, 2), DQNConfig(), **kw),
        lambda **kw: SACLearner(SACModule(3, 1, np.full(1, -2.0),
                                          np.full(1, 2.0), (8, 8)),
                                SACConfig(), **kw),
    ]
    for make in cases:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        made = make(device="cpu")
        if hasattr(made, "stop"):
            made.stop()
