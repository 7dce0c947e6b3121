"""The port stands alone: ``ray_tpu_torch`` imports neither ``jax`` nor any
module of the JAX package (nor gymnasium, but inside the functions that
build a gymnasium env, nor cloudpickle, which the card's machine lacks),
also inside a spawned train worker, data pool worker, env runner or
learner process, and its entry points refuse to fall back to the CPU on
their own."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch import serve

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["gymnasium"] = None    # and `import gymnasium`
sys.modules["ray_tpu"] = None      # and any module of the JAX package
sys.modules["cloudpickle"] = None  # and cloudpickle
sys.modules["aiohttp"] = None      # and aiohttp (the JAX proxy's server)
sys.path.insert(0, {repo!r})
import ray_tpu_torch
names = ["ray_tpu_torch"]
for info in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if m in ("ray_tpu", "jax", "cloudpickle", "aiohttp")
                and sys.modules[m] is not None
                or m.startswith(("ray_tpu.", "jax.", "cloudpickle.",
                                 "aiohttp.")))
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
    assert {"ray_tpu_torch.train." + m for m in TRAIN_MODULES} | {
        "ray_tpu_torch.util.collective"} <= set(lines["NAMES"].split())
    assert {"ray_tpu_torch.data." + m for m in DATA_MODULES} | {
        "ray_tpu_torch.util.procs"} <= set(lines["NAMES"].split())
    assert {rl + "utils.actor_manager", "ray_tpu_torch.parallel.collectives"
            } <= set(lines["NAMES"].split())
    assert {"ray_tpu_torch.serve." + m for m in SERVE_MODULES} | {
        "ray_tpu_torch.core." + m for m in CORE_MODULES} | {
        "ray_tpu_torch.util." + m for m in PLANE_UTIL_MODULES} <= set(
            lines["NAMES"].split())
    assert {"ray_tpu_torch.tune." + m for m in TUNE_MODULES} | {
        "ray_tpu_torch.util.tensorboard"} <= set(lines["NAMES"].split())
    assert {"ray_tpu_torch.dag." + m for m in DAG_MODULES} | {
        "ray_tpu_torch.parallel.mpmd"} <= set(lines["NAMES"].split())


SERVE_MODULES = ("context", "admission", "batching", "deployment", "replica",
                 "controller", "handle", "api", "llm", "prefix_cache",
                 "disagg", "llm_engine", "proxy", "grpc_proxy", "autoscaler",
                 "multiplex", "trace")
CORE_MODULES = ("telemetry", "events", "sink", "checkpoint", "ids",
                "context", "serialization", "object_store", "worker", "api")
DAG_MODULES = ("dag_node", "channels", "resident", "compiled_dag", "meter")
PLANE_UTIL_MODULES = ("metrics", "tracing", "state")
DATA_MODULES = ("context", "block", "datasource", "logical", "read_api",
                "executor", "dataset", "iterator", "preprocessors", "grouped",
                "tfrecord_lite")
TRAIN_MODULES = ("config", "checkpoint", "storage", "session", "callbacks",
                 "worker_group", "backend", "backend_executor",
                 "data_parallel_trainer", "predictor")
TUNE_MODULES = ("search", "search.sample", "search.searcher",
                "search.basic_variant", "search.tpe", "experiment",
                "schedulers", "callbacks", "trainable", "tune_controller",
                "tuner")

# Run as a file: a spawned worker runs it again as its main module, so the
# blocks at the top hold in the worker too.
_WORKER_SCRIPT = r"""
import importlib, sys
for name in ("jax", "ray_tpu", "cloudpickle"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})


def leaked():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle")
                  and sys.modules[m] is not None)


def import_train_layer(names):
    for name in names:
        importlib.import_module(name)
    return leaked()


if __name__ == "__main__":
    from ray_tpu_torch.train import WorkerGroup

    wg = WorkerGroup(1)
    try:
        print("WORKER", wg.execute(import_train_layer, {names!r})[0])
    finally:
        wg.shutdown()
    print("DRIVER", leaked())
"""


def test_train_worker_imports_without_jax_ray_tpu_or_cloudpickle(tmp_path):
    """A spawned train worker imports every module of the Train layer and
    the host collectives with jax, the JAX package and cloudpickle
    blocked, and imports none of them."""
    names = ["ray_tpu_torch.train." + m for m in TRAIN_MODULES] + [
        "ray_tpu_torch.util.collective"]
    script = tmp_path / "worker_imports.py"
    script.write_text(_WORKER_SCRIPT.format(repo=str(REPO), names=names))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WORKER []" in proc.stdout.splitlines(), proc.stdout
    assert "DRIVER []" in proc.stdout.splitlines(), proc.stdout


_TRIAL_SCRIPT = r"""
import importlib, sys
for name in ("jax", "ray_tpu", "cloudpickle"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from ray_tpu_torch import tune
from ray_tpu_torch.train import RunConfig


def leaked():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle")
                  and sys.modules[m] is not None)


def trial(config):
    for name in config["names"]:
        importlib.import_module(name)
    tune.report({{"leaked": " ".join(leaked()),
                 "torch": "torch" in sys.modules}})


if __name__ == "__main__":
    grid = tune.Tuner(
        trial, param_space={{"names": {names!r}}},
        run_config=RunConfig(name="iso", storage_path={out!r})).fit()
    print("TRIAL", repr(grid[0].metrics["leaked"]), grid.errors)
    print("TORCH", grid[0].metrics["torch"])
    print("CONTROLLER", leaked())
"""


def test_tune_trial_process_imports_without_jax_ray_tpu_or_cloudpickle(
        tmp_path):
    """A Tune trial process imports every module of the Tune layer and
    the TensorBoard writer with jax, the JAX package and cloudpickle
    blocked, and imports none of them; running a numpy trainable, it
    never loads torch either."""
    names = ["ray_tpu_torch.tune." + m for m in TUNE_MODULES] + [
        "ray_tpu_torch.util.tensorboard", "ray_tpu_torch.train.config",
        "ray_tpu_torch.train.checkpoint"]
    script = tmp_path / "trial_imports.py"
    script.write_text(_TRIAL_SCRIPT.format(repo=str(REPO), names=names,
                                           out=str(tmp_path / "out")))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRIAL '' []" in proc.stdout.splitlines(), proc.stdout
    assert "TORCH False" in proc.stdout.splitlines(), proc.stdout
    assert "CONTROLLER []" in proc.stdout.splitlines(), proc.stdout


_POOL_SCRIPT = r"""
import sys
for name in ("jax", "ray_tpu", "cloudpickle"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})


class Leaked:
    def __call__(self, batch):
        import importlib

        for name in {names!r}:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle")
                        and sys.modules[m] is not None)
        return {{"id": batch["id"], "leaked": [" ".join(leaked)] * len(batch["id"])}}


if __name__ == "__main__":
    import ray_tpu_torch.data as rd

    rows = rd.range(4, parallelism=2).map_batches(Leaked,
                                                  concurrency=1).take_all()
    print("WORKER", sorted({{str(r["leaked"]) for r in rows}}))
"""


def test_pool_worker_imports_without_jax_ray_tpu_or_cloudpickle(tmp_path):
    """A data pool worker imports the data layer and the predictors with
    jax, the JAX package and cloudpickle blocked, and imports none of
    them."""
    names = ["ray_tpu_torch.data." + m for m in DATA_MODULES] + [
        "ray_tpu_torch.train.predictor"]
    script = tmp_path / "pool_imports.py"
    script.write_text(_POOL_SCRIPT.format(repo=str(REPO), names=names))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WORKER ['']" in proc.stdout.splitlines(), proc.stdout


_RL_SCRIPT = r"""
import sys
for name in ("jax", "ray_tpu", "cloudpickle"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
from ray_tpu_torch.rllib.env.vector_env import CartPoleBatchedEnv


def leaked():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle")
                  and sys.modules[m] is not None)


class ProbeEnv(CartPoleBatchedEnv):
    # Runs in the runner process: a leak fails the sample there.
    def step(self, actions):
        if leaked():
            raise RuntimeError(f"LEAKED {{leaked()}}")
        return super().step(actions)


class ProbeLearner(PPOLearner):
    def leaked(self):
        return leaked()


if __name__ == "__main__":
    import functools

    import numpy as np

    from ray_tpu_torch.rllib.algorithm import LearnerFactory
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    from ray_tpu_torch.rllib.core.rl_module import MLPModule
    from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
    from ray_tpu_torch.rllib.env.vector_env import BatchedCreator
    from ray_tpu_torch.rllib.utils.rollout import fragments_to_ppo_batch

    runners = EnvRunnerGroup(BatchedCreator(ProbeEnv),
                             functools.partial(MLPModule, 4, 2),
                             num_runners=1, num_envs_per_runner=2)
    learners = LearnerGroup(
        LearnerFactory(ProbeLearner, functools.partial(MLPModule, 4, 2),
                       PPOConfig(), device="cpu"),
        num_learners=1, device="cpu")
    try:
        runners.sync_weights(learners.get_weights())
        frags = runners.sample_fragments(8)
        print("FRAGMENTS", len(frags))
        learners.update(fragments_to_ppo_batch(frags, gamma=0.99, lam=0.95))
        print("LEARNER", learners.call("leaked"))
        info = runners.manager.foreach_actor("process_info")[0][1]
        print("RUNNER_CUDA", info["cuda_initialized"], info["device"])
    finally:
        runners.stop()
        learners.shutdown()
    print("DRIVER", leaked())
"""


def test_rl_processes_import_without_jax_ray_tpu_or_cloudpickle(tmp_path):
    """An env runner process samples and a learner process updates with
    jax, the JAX package and cloudpickle blocked, and neither imports any
    of them; the CPU runner never starts CUDA."""
    script = tmp_path / "rl_imports.py"
    script.write_text(_RL_SCRIPT.format(repo=str(REPO)))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for want in ("FRAGMENTS 1", "LEARNER []", "RUNNER_CUDA False cpu",
                 "DRIVER []"):
        assert want in lines, (want, proc.stdout, proc.stderr[-3000:])


def test_rl_processes_refuse_before_any_spawn(monkeypatch):
    """Runner processes on cards (runner_resources={"num_gpus": 1}) and a
    learner process on the card raise before any spawn when CUDA is
    absent, as does a nested env creator, naming itself; asked for the
    CPU, the spawn is reached."""
    import functools

    from ray_tpu_torch.rllib.algorithm import LearnerFactory
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core import learner_group
    from ray_tpu_torch.rllib.core.rl_module import MLPModule
    from ray_tpu_torch.rllib.env import env_runner_group
    from ray_tpu_torch.rllib.env.vector_env import (BatchedCreator,
                                                    CartPoleBatchedEnv)

    def no_spawn(*args, **kwargs):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(env_runner_group, "ActorProcess", no_spawn)
    monkeypatch.setattr(learner_group, "ActorProcess", no_spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = functools.partial(MLPModule, 4, 2)
    creator = BatchedCreator(CartPoleBatchedEnv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env_runner_group.EnvRunnerGroup(creator, module, num_runners=1,
                                        runner_resources={"num_gpus": 1})
    factory = LearnerFactory(PPOLearner, module, PPOConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        learner_group.LearnerGroup(factory, num_learners=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPOConfig().environment(env_creator=creator).learners(
            num_learners=1).build()

    def nested_creator(n):
        return CartPoleBatchedEnv(n)
    nested_creator.makes_batched_env = True
    with pytest.raises(TypeError, match="nested_creator"):
        env_runner_group.EnvRunnerGroup(nested_creator, module,
                                        num_runners=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 env runners need 2 cards, 1 "
                                         "visible"):
        env_runner_group.EnvRunnerGroup(creator, module, num_runners=2,
                                        runner_resources={"num_gpus": 1})
    # Asked for the CPU, the spawn is reached.
    with pytest.raises(AssertionError, match="a worker was spawned"):
        env_runner_group.EnvRunnerGroup(creator, module, num_runners=1)
    with pytest.raises(AssertionError, match="a worker was spawned"):
        learner_group.LearnerGroup(
            LearnerFactory(PPOLearner, module, PPOConfig(), device="cpu"),
            num_learners=1, device="cpu")


def test_data_entry_points_refuse_without_cuda_before_any_spawn(
        monkeypatch):
    """iter_device_batches, map_batches(num_gpus=1) and BatchPredictor
    take the card unless the caller asks for the CPU: with no CUDA, or
    with fewer cards than workers, they raise before a worker is
    spawned."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data import executor
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, TorchPredictor

    def no_spawn(*args, **kwargs):
        raise AssertionError("a worker was spawned")

    class Udf:  # never pickled: the refusals come first
        pass

    monkeypatch.setattr(executor, "_Slot", no_spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = rd.range(8, parallelism=2)
    ckpt = Checkpoint("/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.iter_device_batches(batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.map_batches(Udf, num_gpus=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchPredictor(ckpt, TorchPredictor).predict(ds)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 pool workers need 2 cards, 1 "
                                         "visible"):
        BatchPredictor(ckpt, TorchPredictor).predict(
            ds, max_scoring_workers=2)
    with pytest.raises(ValueError, match="num_gpus is 0 or 1"):
        ds.map_batches(Udf, num_gpus=2)
    # Asked for the CPU, the pool reaches the spawn.
    with pytest.raises(AssertionError, match="a worker was spawned"):
        BatchPredictor(ckpt, TorchPredictor, device="cpu").predict(
            ds, num_gpus_per_actor=0).take_all()


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


def _noop_loop(config):
    pass


def test_torch_trainer_refuses_before_any_spawn(monkeypatch):
    """TorchTrainer's workers take the card unless the caller asks for the
    CPU: with no CUDA it raises; with fewer cards than workers, or a worker
    asking for two cards, too. Each before any worker is spawned."""
    from ray_tpu_torch.train import ScalingConfig, TorchPredictor, TorchTrainer
    from ray_tpu_torch.train import worker_group

    def no_spawn(*args, **kwargs):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(worker_group, "_WorkerProcess", no_spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchTrainer(_noop_loop, train_loop_config={}).fit()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchPredictor(lambda p, x: x, {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 workers need 2 cards, 1 visible"):
        TorchTrainer(_noop_loop, train_loop_config={},
                     scaling_config=ScalingConfig(num_workers=2)).fit()
    with pytest.raises(ValueError, match="exactly one"):
        TorchTrainer(_noop_loop, train_loop_config={},
                     scaling_config=ScalingConfig(
                         resources_per_worker={"GPU": 2})).fit()
    # Asked for explicitly, the CPU is taken: the spawn is reached.
    with pytest.raises(AssertionError, match="a worker was spawned"):
        TorchTrainer(_noop_loop, train_loop_config={}, device="cpu").fit()


def test_unpicklable_split_iterator_refuses_before_any_spawn(monkeypatch):
    """A dataset every rank gets as it is (a list of split iterators) must
    pickle: a split's batch generator in place of its SplitIterator
    raises in fit(), before any worker is spawned, naming the entry."""
    import ray_tpu_torch.data as td
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.train import worker_group

    def no_spawn(*args, **kwargs):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(worker_group, "_WorkerProcess", no_spawn)
    its = td.range(8).streaming_split(1)
    with pytest.raises(TypeError, match=r"datasets\['splits'\]"):
        TorchTrainer(_noop_loop, train_loop_config={}, device="cpu",
                     datasets={"splits": [its[0].iter_batches()]}).fit()
    # The iterators themselves pickle: the spawn is reached.
    with pytest.raises(AssertionError, match="a worker was spawned"):
        TorchTrainer(_noop_loop, train_loop_config={}, device="cpu",
                     datasets={"splits": its}).fit()


# Run as a file: a replica process runs it again as its main module, so
# the blocks at the top hold in the replica too.
_SERVE_SCRIPT = r"""
import sys
for name in ("jax", "ray_tpu", "cloudpickle", "aiohttp"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from ray_tpu_torch import serve


def leaked():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle",
                                         "aiohttp")
                  and sys.modules[m] is not None)


@serve.deployment
class Leaked:
    def __call__(self, names):
        import importlib

        for name in names:
            importlib.import_module(name)
        return leaked()


if __name__ == "__main__":
    import multiprocessing

    handle = serve.run(Leaked.bind())
    try:
        print("REPLICA", handle.remote({names!r}).result(timeout=60))
        _, (rep,) = serve.controller._local.get_replicas("Leaked")
        info = rep.call("stats")["process"]
        print("REPLICA_CUDA", info["cuda_initialized"], info["num_threads"])
    finally:
        serve.shutdown()
    print("CHILDREN", multiprocessing.active_children())
    print("DRIVER", leaked())
"""


def test_serve_replica_imports_without_jax_ray_tpu_or_cloudpickle(tmp_path):
    """A CPU replica process imports every module of the Serve layer and
    of its trace and metrics plane with
    jax, the JAX package, cloudpickle and aiohttp blocked, imports none
    of them,
    runs torch on one thread and never starts CUDA; shutdown leaves no
    child process."""
    names = (["ray_tpu_torch.serve." + m for m in SERVE_MODULES]
             + ["ray_tpu_torch.core." + m for m in CORE_MODULES]
             + ["ray_tpu_torch.util." + m for m in PLANE_UTIL_MODULES])
    script = tmp_path / "serve_imports.py"
    script.write_text(_SERVE_SCRIPT.format(repo=str(REPO), names=names))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for want in ("REPLICA []", "REPLICA_CUDA False 1", "CHILDREN []",
                 "DRIVER []"):
        assert want in lines, (want, proc.stdout, proc.stderr[-3000:])


def test_serve_refuses_before_any_spawn(monkeypatch):
    """The LLM builders take a card a replica by default (num_gpus=1):
    with no CUDA, or with too few cards, they raise before any replica
    is spawned, as serve.run does for a deployment asking for a card; a
    nested class or a lambda among the bind arguments raises before any
    spawn, naming itself."""
    from ray_tpu_torch.models.configs import llama_tiny
    from ray_tpu_torch.serve import controller
    from ray_tpu_torch.serve.disagg import build_disagg_llm_deployment
    from ray_tpu_torch.serve.llm import (build_llm_deployment,
                                         build_streaming_llm_deployment)
    from ray_tpu_torch.util import procs

    def no_spawn(*args, **kwargs):
        raise AssertionError("a replica was spawned")

    monkeypatch.setattr(procs, "Worker", no_spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_tiny(dtype=torch.float32)
    for build in (build_llm_deployment, build_streaming_llm_deployment,
                  build_disagg_llm_deployment):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(cfg, _noop_loop)
    gpu = serve.deployment(ray_actor_options={"num_gpus": 1})(_noop_loop)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.run(gpu.bind())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 replicas need 2 cards"):
        build_disagg_llm_deployment(cfg, _noop_loop)
    with pytest.raises(ValueError, match="2 replicas need 2 cards"):
        build_streaming_llm_deployment(cfg, _noop_loop, num_replicas=2)

    class Nested:
        pass

    with pytest.raises(TypeError, match="Nested.*defined inside a function"):
        serve.run(serve.deployment(Nested).bind())
    with pytest.raises(TypeError, match="argument 0 <function"):
        serve.run(serve.deployment(_Plain).bind(lambda: 0))
    # Asked for the CPU, the spawn is reached.
    with pytest.raises(AssertionError, match="a replica was spawned"):
        serve.run(build_streaming_llm_deployment(cfg, _noop_loop,
                                                 num_gpus=0).bind())
    serve.shutdown()
    assert controller._local is None


class _Plain:
    def __init__(self, fn):
        self.fn = fn


@serve.deployment
def _echo(x):
    return x


def test_serve_shutdown_stops_proxies_and_frees_the_port():
    """After serve.shutdown() no proxy thread is left (the HTTP proxy's
    accept and connection threads, the gRPC proxy's pool) and the HTTP
    port can be bound again, by a proxy as by a plain socket."""
    import json
    import socket
    import threading
    import urllib.request

    from ray_tpu_torch.serve import api

    def proxy_threads():
        return sorted(t.name for t in threading.enumerate()
                      if t.name.startswith(("serve-http-proxy",
                                            "serve-grpc-proxy")))

    grpc = None
    try:
        import grpc
    except ImportError:
        pass
    serve.run(_echo.bind(), route_prefix="/e", _http=True, http_port=0,
              _grpc=grpc is not None, grpc_port=0)
    port = api._proxy.port
    # An open keep-alive connection holds a thread until shutdown.
    conn = socket.create_connection(("127.0.0.1", port))
    req = urllib.request.Request(f"http://127.0.0.1:{port}/e",
                                 data=json.dumps(5).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read()) == {"result": 5}
    if grpc is not None:
        with grpc.insecure_channel(
                f"127.0.0.1:{api._grpc_proxy.port}") as ch:
            call = ch.unary_unary(
                "/rtpu.serve/Call",
                request_serializer=lambda o: json.dumps(o).encode(),
                response_deserializer=lambda b: json.loads(b.decode()))
            assert call({"route": "/e", "input": 6}, timeout=30) == {
                "result": 6}
    assert proxy_threads()
    serve.shutdown()
    conn.close()
    assert proxy_threads() == []
    assert api._proxy is None and api._grpc_proxy is None
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
    serve.start(http_port=port)
    try:
        assert api._proxy.port == port
    finally:
        serve.shutdown()
    assert proxy_threads() == []


def test_serve_shutdown_stops_the_metrics_endpoint():
    """The serve controller serves ``GET /metrics`` on an ephemeral port;
    after serve.shutdown() its responder and sampler threads are gone and
    the port can be bound again; a metrics flush afterwards (no
    controller) returns at once."""
    import socket
    import threading
    import time
    import urllib.request

    from ray_tpu_torch.util import metrics, state

    def plane_threads():
        return sorted(t.name for t in threading.enumerate()
                      if t.name in ("rtpu-metrics-http", "rtpu-metrics-tsdb"))

    serve.run(_echo.bind(), route_prefix="/m")
    addr = state.metrics_address()
    host, port = addr.split(":")
    metrics.Counter("isolation_probe_total").inc(2.0)
    metrics.flush_metrics()
    with urllib.request.urlopen(f"http://{addr}/metrics", timeout=10) as r:
        assert "isolation_probe_total 2.0" in r.read().decode()
    assert plane_threads() == ["rtpu-metrics-http", "rtpu-metrics-tsdb"]
    serve.shutdown()
    assert plane_threads() == []
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, int(port)))
    metrics.Counter("isolation_probe_total").inc(1.0)
    t = time.monotonic()
    assert metrics.flush_metrics() is True
    assert time.monotonic() - t < 2.0


# Run as a file: a task worker and a spawned actor run it again as their
# main module (the blocks at its top hold there too); a stage process
# forks from the fork server, which imports only the stage's preload.
_CORE_SCRIPT = r"""
import importlib, sys
for name in ("jax", "ray_tpu", "cloudpickle"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt


def leaked():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle")
                  and sys.modules[m] is not None)


def imports(names):
    for name in names:
        importlib.import_module(name)
    return leaked(), "torch" in sys.modules


@rt.remote
def task(names):
    return imports(names)


@rt.remote
class CpuActor:
    def probe(self, names):
        return imports(names)


class Probe:
    def __call__(self, x):
        return x

    def probe(self):
        return leaked()


class ProbeFactory:
    def __call__(self, idx, n, mesh):
        return Probe()


if __name__ == "__main__":
    from ray_tpu_torch.parallel import MPMDPipeline

    rt.init(num_cpus=2)
    try:
        print("TASK", rt.get(task.remote({core!r})))
        a = CpuActor.remote()
        print("ACTOR", rt.get(a.probe.remote({core!r})))
        p = MPMDPipeline([ProbeFactory()] * 2, recovery=False)
        print("RUN", p.run([1, 2]))
        p.teardown(kill_actors=False)
        print("STAGES", p.call_stages("probe"))
        p.teardown()
    finally:
        rt.shutdown()
    print("DRIVER", leaked())
"""


def test_core_processes_import_without_jax_or_ray_tpu(tmp_path):
    """A task worker and a CPU actor import the core and the DAG layer
    with jax, the JAX package and cloudpickle blocked, import none of
    them and never load torch; an MPMD stage process (which loads torch)
    and the driver import none of them either."""
    core = ["ray_tpu_torch.core." + m for m in CORE_MODULES
            if m not in ("telemetry", "sink")] + [
        "ray_tpu_torch.dag." + m for m in DAG_MODULES]
    script = tmp_path / "core_imports.py"
    script.write_text(_CORE_SCRIPT.format(repo=str(REPO), core=core))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=180, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "TASK ([], False)" in lines, proc.stdout
    assert "ACTOR ([], False)" in lines, proc.stdout
    assert "RUN [1, 2]" in lines, proc.stdout
    assert "STAGES [[], []]" in lines, proc.stdout
    assert "DRIVER []" in lines, proc.stdout


class _Factory:
    def __call__(self, idx, n, mesh):
        return lambda x: x


@pytest.fixture
def core():
    import ray_tpu_torch as rt

    rt.init(num_cpus=2)
    try:
        yield rt
    finally:
        rt.shutdown()


def _actors():
    from ray_tpu_torch.core import api

    return len(api.runtime().actors)


def test_mpmd_refuses_before_any_spawn(core, monkeypatch):
    """A nested factory, a mesh_spec over more than one card and stages
    that ask cards on a host without CUDA raise before any stage process
    starts."""
    from ray_tpu_torch.core import api
    from ray_tpu_torch.parallel import MPMDPipeline
    from ray_tpu_torch.parallel.mesh import MeshSpec

    def nested_factory(idx, n, mesh):
        return lambda x: x

    with pytest.raises(TypeError, match="nested_factory"):
        MPMDPipeline([_Factory(), nested_factory])
    with pytest.raises(ValueError, match="spans 2 cards"):
        MPMDPipeline([_Factory(), _Factory()],
                     mesh_specs=[None, MeshSpec(fsdp=2)])
    monkeypatch.setattr(api.runtime(), "_num_gpus", 0)
    with pytest.raises(RuntimeError, match="cards"):
        MPMDPipeline([_Factory()] * 2,
                     stage_options=[{"num_gpus": 1}] * 2)
    assert _actors() == 0


def test_handles_refused_before_any_send(core):
    """A nested remote class raises TypeError in the driver, naming
    itself, before any spawn. (Handles and refs travel since slice 18:
    ``test_handle_and_ref_reach_a_child_without_jax``.)"""
    import ray_tpu_torch as rt

    class Nested:
        pass

    with pytest.raises(TypeError, match="Nested"):
        rt.remote(Nested).remote()
    assert _actors() == 0


# Run as a file, as _CORE_SCRIPT: the task worker and the actor run it
# again as their main module, so the blocks hold there too.
_HANDLE_SCRIPT = r"""
import sys
for name in ("jax", "ray_tpu", "cloudpickle"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt


def leaked():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle")
                  and sys.modules[m] is not None)


@rt.remote
class Box:
    def __init__(self):
        self.items = []

    def add(self, x):
        self.items.append(x)
        return len(self.items)


@rt.remote
def use(handle, nested):
    ref = nested["ref"]
    return (rt.get(handle.add.remote(rt.get(ref))),
            type(handle).__name__, type(ref).__name__, leaked(),
            "torch" in sys.modules)


if __name__ == "__main__":
    rt.init(num_cpus=2)
    try:
        box = Box.remote()
        print("CHILD", rt.get(use.remote(box, {{"ref": rt.put(7)}}),
                              timeout=60))
    finally:
        rt.shutdown()
    print("DRIVER", leaked())
"""


def test_handle_and_ref_reach_a_child_without_jax(tmp_path):
    """An ActorHandle and a ref nested in a dict reach a task worker that
    has loaded neither jax nor the JAX package (nor torch), arrive as a
    handle and a ref, and work there through the driver."""
    script = tmp_path / "handles.py"
    script.write_text(_HANDLE_SCRIPT.format(repo=str(REPO)))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "CHILD (1, 'ActorHandle', 'ObjectRef', [], False)" in lines, (
        proc.stdout)
    assert "DRIVER []" in lines, proc.stdout

