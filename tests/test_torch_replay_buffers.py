"""The port's replay buffers (ray_tpu_torch/rllib/utils/replay_buffers)
against the JAX package's copy: the same seeded numpy inputs and draws
give the same columns, indices and importance weights, exactly."""
import numpy as np
import pytest

from ray_tpu.rllib.utils import episodes as jeps
from ray_tpu.rllib.utils import replay_buffers as jrb
from ray_tpu_torch.rllib.utils import episodes as teps
from ray_tpu_torch.rllib.utils import replay_buffers as trb


def _fill(mod, cls, capacity, n, action_shape=(), action_dtype=np.int32,
          seed=0, **kw):
    rng = np.random.default_rng(seed)
    b = getattr(mod, cls)(capacity, (3,), action_shape, action_dtype, **kw)
    slots = []
    for i in range(n):
        a = (rng.uniform(-1, 1, action_shape).astype(action_dtype)
             if action_shape else int(rng.integers(0, 4)))
        slots.append(b.add(rng.standard_normal(3), rng.standard_normal(3),
                           a, float(rng.standard_normal()),
                           float(rng.random() < 0.1)))
    return b, slots


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("action_shape,action_dtype",
                         [((), np.int32), ((2,), np.float32)])
def test_ring_order_wrap_and_shapes(action_shape, action_dtype):
    """13 adds into 8 slots: the same slots, the ring's position and size,
    the same stored columns, and the same uniform sample."""
    jb, jslots = _fill(jrb, "ReplayBuffer", 8, 13, action_shape,
                       action_dtype)
    tb, tslots = _fill(trb, "ReplayBuffer", 8, 13, action_shape,
                       action_dtype)
    assert tslots == jslots == [i % 8 for i in range(13)]
    assert (len(tb), tb.pos) == (len(jb), jb.pos) == (8, 5)
    for k in ("obs", "next_obs", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k))
    got = tb.sample(16, np.random.default_rng(3))
    _assert_same(got, jb.sample(16, np.random.default_rng(3)))
    assert got["actions"].shape == (16, *action_shape)
    assert got["obs"].shape == (16, 3)


def test_prioritized_sample_matches_jax_before_and_after_updates():
    """Same draws from the same np.random.default_rng seed: idx and IS
    weights equal, exactly, on a partly filled buffer, after priority
    updates, and once the ring has wrapped."""
    kw = dict(alpha=0.7, beta=0.5)
    jb, _ = _fill(jrb, "PrioritizedReplayBuffer", 32, 20, **kw)
    tb, _ = _fill(trb, "PrioritizedReplayBuffer", 32, 20, **kw)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    rng = np.random.default_rng(6)
    for step in range(4):
        want, got = jb.sample(24, jr), tb.sample(24, tr)
        _assert_same(got, want)
        td = rng.standard_normal(24) * 3
        jb.update_priorities(want["idx"], td)
        tb.update_priorities(got["idx"], td)
        np.testing.assert_array_equal(tb._tree.tree, jb._tree.tree)
        assert tb._max_priority == jb._max_priority
        if step == 1:  # wrap the ring: new rows at the max priority
            for b in (jb, tb):
                r = np.random.default_rng(7)
                for _ in range(20):
                    b.add(r.standard_normal(3), r.standard_normal(3), 1,
                          0.5, 0.0)


def test_make_buffer_dispatch():
    for cfg, cls in ((None, "ReplayBuffer"),
                     ({"type": "uniform"}, "ReplayBuffer"),
                     ({"type": "prioritized"}, "PrioritizedReplayBuffer"),
                     ({"type": "PrioritizedEpisodeReplayBuffer",
                       "alpha": 0.5, "beta": 0.3},
                      "PrioritizedReplayBuffer")):
        want = jrb.make_buffer(cfg, 8, (1,))
        got = trb.make_buffer(cfg, 8, (1,))
        assert type(got).__name__ == type(want).__name__ == cls
        if cls == "PrioritizedReplayBuffer":
            assert (got.alpha, got.beta) == (want.alpha, want.beta)
    b = trb.make_buffer(None, 4, (2,), action_shape=(3,),
                        action_dtype=np.float32)
    assert b.actions.shape == (4, 3) and b.actions.dtype == np.float32


def _episodes(mod, rng, continuous, jax_side=False):
    """Chunks 0-3 as the runners make them (terminated, truncated, cut,
    each with its final observation); chunks 4 and 5 without it, as the
    port's runner ends them over a same-step autoreset env: 4 terminated
    (its last step keeps its own observation as the next, masked by the
    done flag), 5 truncated (its last step has no next observation: the
    port drops it). The JAX side's chunk 5 is given without that step,
    which the JAX runner never makes, so both buffers must hold the same
    columns."""
    out = []
    for i in range(6):
        T = int(rng.integers(1, 6))
        ep = mod.SingleAgentEpisode()
        n_obs = T if i >= 4 else T + 1
        ep.observations = [rng.standard_normal(3).astype(np.float32)
                           for _ in range(n_obs)]
        ep.actions = ([rng.uniform(-1, 1, 2).astype(np.float32)
                       for _ in range(T)] if continuous
                      else [int(a) for a in rng.integers(0, 4, T)])
        ep.rewards = [float(x) for x in rng.standard_normal(T)]
        ep.terminated = i in (0, 4)
        ep.truncated = i in (1, 5)
        if jax_side and i == 5:
            ep.actions, ep.rewards = ep.actions[:-1], ep.rewards[:-1]
        out.append(ep)
    return out


@pytest.mark.parametrize("continuous", [False, True])
def test_add_episodes_gives_the_same_columns(continuous):
    shape, dtype = ((2,), np.float32) if continuous else ((), np.int32)
    jb = jrb.ReplayBuffer(32, (3,), shape, dtype)
    tb = trb.ReplayBuffer(32, (3,), shape, dtype)
    n_j = jb.add_episodes(_episodes(jeps, np.random.default_rng(8),
                                    continuous, jax_side=True))
    eps = _episodes(teps, np.random.default_rng(8), continuous)
    n_t = tb.add_episodes(eps)
    assert n_t == n_j == len(tb) == sum(len(e) for e in eps) - 1
    assert tb.dones.sum() == 2  # the terminated chunks' last steps
    for k in ("obs", "next_obs", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k),
                                      err_msg=k)
