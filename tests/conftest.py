"""Test fixtures (reference: python/ray/tests/conftest.py ray_start_regular:419,
ray_start_cluster:500).

JAX is forced onto a virtual 8-device CPU platform before any test imports it,
so sharding/collective tests run the real pjit/shard_map paths without TPU
hardware (SURVEY.md §4.4 test-ring 2).
"""
import os

os.environ["RTPU_JAX_PLATFORM"] = "cpu"

from ray_tpu.util.jaxenv import cpu_mesh_env  # noqa: E402

cpu_mesh_env(8)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running stress/chaos variants excluded from tier-1 "
        "(run with -m slow)")
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection tests (drain/preemption/kill harnesses). "
        "Fast chaos tests stay inside the tier-1 'not slow' set; stress "
        "variants are additionally marked slow.")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the PyTorch port's hand-written "
        "kernels); skips without one. On the card: "
        "python -m pytest -m cuda tests/test_torch_*.py")


@pytest.fixture(scope="module")
def ray_start_regular():
    import ray_tpu

    handle = ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    yield handle
    ray_tpu.shutdown()


@pytest.fixture(scope="module")
def ray_start_cluster():
    from ray_tpu.core.cluster_utils import Cluster

    cluster = Cluster(head_resources={"CPU": 2})
    yield cluster
    cluster.shutdown()
