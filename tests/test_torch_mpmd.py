"""The port's MPMD pipeline (``ray_tpu_torch.parallel.mpmd``) on the CPU:
stage processes of the core wired by compiled-DAG channels.

- llama_tiny at 4 layers, with params the JAX package initialised and
  ``convert.py`` carries, over 2 and 4 stage processes
  (``TransformerStage``): the logits are held to the JAX package's
  ``models.transformer.forward`` within ATOL/RTOL (the port's own
  forward-against-JAX tolerance, tests/test_torch_models.py) and to the
  port's one-process forward bit for bit, one torch thread on both sides;
- a stage killed mid-stream restores from its checkpoint, which holds what
  the stage was built from and not its weights, and the outputs stay
  those of the one-process forward bit for bit;
- tests/test_compiled_dag_channels.py's test_mpmd_pipeline_channel_mode
  (describe, 32 microbatches through 3 stages, 29 steady gaps).

Stage processes import this module again to find its factories, so its
top loads neither torch nor jax.
"""
import glob
import multiprocessing
import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.object_store import CHANNEL_PREFIX

N_LAYERS = 4
ATOL = RTOL = 1e-4
B, S, MICRO = 2, 24, 6


def port_cfg():
    import torch

    from ray_tpu_torch.models.configs import llama_tiny

    return llama_tiny(dtype=torch.float32, n_layers=N_LAYERS)


class NpzParams:
    """The JAX package's llama_tiny params from an ``.npz``, on the CPU,
    with torch on one thread in the calling process (a stage's)."""

    def __init__(self, path):
        self.path = path

    def __call__(self):
        import torch

        from ray_tpu_torch import convert

        torch.set_num_threads(1)
        tree = {"layers": {}}
        with np.load(self.path) as z:
            for k in z.files:
                if k.startswith("layers/"):
                    tree["layers"][k[len("layers/"):]] = z[k]
                else:
                    tree[k] = z[k]
        return convert.params_from_numpy(tree, port_cfg(), "cpu")


class AddFactory:
    """Stage k adds 10 ** k."""

    def __call__(self, idx, n, mesh):
        assert mesh is None
        return AddStep(10 ** idx)


class AddStep:
    def __init__(self, k):
        self.k = k

    def __call__(self, x):
        return x + self.k


def _leftovers(dag_id):
    return glob.glob(f"/dev/shm/{CHANNEL_PREFIX}{dag_id[:12]}*")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX side: llama_tiny (4 layers, f32, key 0) params in an .npz,
    MICRO token microbatches, and the JAX forward's logits of each."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import configs as jconfigs
    from ray_tpu.models import transformer as jtfm

    jcfg = jconfigs.llama_tiny(remat=False, dtype=jnp.float32,
                               n_layers=N_LAYERS)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    flat = {}
    for k, v in jparams.items():
        if k == "layers":
            flat.update({f"layers/{n}": np.asarray(w) for n, w in v.items()})
        else:
            flat[k] = np.asarray(v)
    path = str(tmp_path_factory.mktemp("mpmd") / "llama_tiny.npz")
    np.savez(path, **flat)
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, jcfg.vocab_size, (B, S)) for _ in range(MICRO)]
    logits = [np.asarray(jtfm.forward(jparams, jnp.asarray(t, jnp.int32),
                                      jcfg)) for t in toks]
    return path, toks, logits


@pytest.fixture(scope="module")
def one_process(ref):
    """The port's one-process forward of each microbatch, one thread."""
    import torch

    from ray_tpu_torch.models.transformer import forward

    path, toks, _ = ref
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = NpzParams(path)()
        with torch.no_grad():
            return [forward(params, torch.from_numpy(t), port_cfg())
                    for t in toks]
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    os.environ["RTPU_CHECKPOINT_DIR"] = str(
        tmp_path_factory.mktemp("mpmd-ckpt"))
    os.environ["RTPU_DAG_STALL_S"] = "0.5"
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()
        for k in ("RTPU_CHECKPOINT_DIR", "RTPU_DAG_STALL_S"):
            os.environ.pop(k, None)
    assert [p for p in multiprocessing.active_children()
            if p.name.startswith(("rtpt-task", "rtpt-actor"))] == []


def test_mpmd_pipeline_channel_mode(core):
    from ray_tpu_torch.parallel import MPMDPipeline

    p = MPMDPipeline([AddFactory()] * 3, max_in_flight=4)
    try:
        assert p.mode == "channels"
        assert [s["stage"] for s in p.describe()] == [0, 1, 2]
        assert all(s["spawn_s"] > 0 for s in p.describe())
        outs = p.run(list(range(32)))
        assert outs == [i + 111 for i in range(32)]
        assert p.gap_stats()["n"] == 29  # 31 gaps minus the 2-step fill
    finally:
        dag_id = p._compiled.dag_id
        p.teardown()
    assert _leftovers(dag_id) == []


@pytest.mark.parametrize("n_stages", [2, 4])
def test_llama_tiny_stages_against_jax_and_one_process(core, ref,
                                                       one_process,
                                                       n_stages):
    import torch

    from ray_tpu_torch.parallel import MPMDPipeline
    from ray_tpu_torch.parallel.mpmd import TransformerStage

    path, toks, jax_logits = ref
    factory = TransformerStage(port_cfg(), NpzParams(path))
    p = MPMDPipeline([factory] * n_stages, max_in_flight=4, recovery=False)
    try:
        assert p.mode == "channels"
        outs = p.run(toks)
        assert p.gap_stats()["n"] == MICRO - 1 - (n_stages - 1)
        p.teardown(kill_actors=False)
        launches = p.call_stages("kernel_launches")
    finally:
        dag_id = p._compiled.dag_id
        p.teardown()
    assert _leftovers(dag_id) == []
    for got, one, jx in zip(outs, one_process, jax_logits):
        assert got.dtype == torch.float32 and got.shape == (B, S, 512)
        assert torch.equal(got, one)
        np.testing.assert_allclose(got.numpy(), jx, atol=ATOL, rtol=RTOL)
    # On the CPU attention takes the plain path: no kernel launched.
    assert all(c["flash_fwd"] == 0 for c in launches)


def test_killed_stage_restores_from_its_construction(core, ref,
                                                     one_process):
    """SIGKILL stage 1 of 3 mid-stream: it restarts from its checkpoint,
    which holds its factory, index, count and spec (a few KB, not the
    params: the factory runs again), and every output is still the
    one-process forward's, bit for bit."""
    import pickle

    import torch

    from ray_tpu_torch.core import api
    from ray_tpu_torch.core import checkpoint as ckpt
    from ray_tpu_torch.parallel import MPMDPipeline
    from ray_tpu_torch.parallel.mpmd import TransformerStage

    path, toks, _ = ref
    factory = TransformerStage(port_cfg(), NpzParams(path))
    p = MPMDPipeline([factory] * 3, max_in_flight=2,
                     stage_options=[{"checkpoint_every_n": 1}] * 3)
    try:
        assert p.mode == "channels"
        victim_actor = p._handles[1]._actor_id
        victim = api.runtime().actor_info(victim_actor)["pid"]
        refs = []
        for i in range(3 * MICRO):
            refs.append(p.submit(toks[i % MICRO]))
            time.sleep(0.03)
            if i == MICRO:
                os.kill(victim, signal.SIGKILL)
        outs = [r.get(timeout=120) for r in refs]
        assert p.recoveries >= 1
        assert api.runtime().actor_info(victim_actor)["pid"] != victim
        # The record: the stage's construction (a few KB; the params are
        # ~4 MB) and the DAG journal, whose window of encoded outputs is
        # bounded by the in-flight window plus 2.
        rec = ckpt.decode(ckpt.newest_local(victim_actor)[1])
        assert len(pickle.dumps(rec["instance"])) < 16 * 1024
        (journal,) = [v for k, v in rec["journal"].items()
                      if str(k).startswith("__dag__")]
        assert len(journal[1]["outs"]) <= 2 + 2
    finally:
        p.teardown()
    for i, got in enumerate(outs):
        assert torch.equal(got, one_process[i % MICRO]), i
