"""The port's host collectives with a group object
(``ray_tpu_torch/parallel/collectives.py``) on two spawned CPU processes:
the values and expectations of the JAX package's
``tests/test_collectives.py``, the pytree allreduce included. The ranks
meet at a FileStore named after the group and this process (their parent),
which is gone once they leave; the spawned processes import this module
again, and it imports no jax."""
import multiprocessing
import os
import traceback
import uuid

import numpy as np
import pytest


def _worker(world_size, rank, group_name, out):
    try:
        from ray_tpu_torch.parallel import collectives as col

        g = col.init_collective_group(world_size, rank, group_name)
        res = {}
        res["allreduce"] = g.allreduce(np.full((4,), float(rank + 1),
                                               np.float32))
        res["mean"] = g.allreduce(np.full((2,), float(rank), np.float32),
                                  op="mean")
        res["gathered"] = g.allgather(rank * 10)
        res["bcast"] = g.broadcast("hello" if rank == 0 else None,
                                   src_rank=0)
        g.barrier()
        res["rs"] = g.reducescatter(np.arange(4, dtype=np.float32))
        tree = {"a": np.ones(3, np.float32) * (rank + 1),
                "b": [np.zeros(2) + rank]}
        res["tree"] = g.allreduce(tree)
        res["max"] = col.allreduce(np.array([rank, -rank], np.float32),
                                   group_name, op="max")
        res["min"] = col.allreduce(np.array([rank, -rank], np.float32),
                                   group_name, op="min")
        col.destroy_collective_group(group_name)
        out.put((rank, "ok", res))
    except BaseException:  # noqa: BLE001 — reported to the test
        out.put((rank, "err", traceback.format_exc()))


@pytest.fixture(scope="module")
def two_ranks():
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    name = f"torchgrp-{uuid.uuid4().hex[:8]}"
    ps = [ctx.Process(target=_worker, args=(2, r, name, out))
          for r in range(2)]
    for p in ps:
        p.start()
    try:
        got = dict((r, (status, value)) for r, status, value in
                   (out.get(timeout=120) for _ in ps))
    finally:
        for p in ps:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(not p.is_alive() for p in ps)
    from ray_tpu_torch.parallel.collectives import rendezvous_path

    assert not os.path.exists(rendezvous_path(name, os.getpid()))
    errors = [v for s, v in got.values() if s == "err"]
    assert not errors, errors[0]
    return {r: v for r, (_, v) in got.items()}


def test_collective_group_two_ranks(two_ranks):
    res = two_ranks
    for r in (0, 1):
        np.testing.assert_array_equal(res[r]["allreduce"],
                                      np.full((4,), 3.0))
        np.testing.assert_array_equal(res[r]["mean"], np.full((2,), 0.5))
        assert res[r]["gathered"] == [0, 10]
        assert res[r]["bcast"] == "hello"
        np.testing.assert_array_equal(res[r]["max"], [1.0, 0.0])
        np.testing.assert_array_equal(res[r]["min"], [0.0, -1.0])
    # reducescatter: rank r gets slice r of 2*[0,1,2,3]
    np.testing.assert_array_equal(res[0]["rs"], np.array([0.0, 2.0]))
    np.testing.assert_array_equal(res[1]["rs"], np.array([4.0, 6.0]))


def test_collective_pytree_allreduce(two_ranks):
    for r in (0, 1):
        tree = two_ranks[r]["tree"]
        np.testing.assert_array_equal(tree["a"], np.full(3, 3.0))
        np.testing.assert_array_equal(tree["b"][0], np.full(2, 1.0))
        assert tree["a"].dtype == np.float32
