"""The port's autoscalers and the drain (``serve/autoscaler.py``,
``serve/controller.py``'s signal plane), the mirror of
tests/test_serve.py::test_autoscaling_up and
tests/test_serve_disagg.py::test_autoscaler_scales_up_and_drains_down;
``ServeAutoscaler`` against the JAX package's on the same signal
sequences at the same ``now`` (TTFT p99 signals too); the TTFT trigger
scaling a deployment on its replica's real TTFT histograms; and the
pending replicas of a target past the free cards (a divergence by design)
on simulated cards.

Deployments are module-level (a replica imports this module again to
find them), so the module imports neither jax nor the JAX package at the
top.
"""
import pathlib
import subprocess
import sys
import time

import pytest

import test_torch_serve as base
from ray_tpu_torch import serve
from ray_tpu_torch.serve import controller

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def serve_instance():
    yield
    serve.shutdown()
    assert base.no_children_left()


@serve.deployment(
    max_ongoing_requests=32,
    autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                        "target_ongoing_requests": 2.0,
                        "upscale_delay_s": 0.0,
                        "downscale_delay_s": 60.0})
class Slow:
    def __call__(self, x):
        time.sleep(0.4)
        return x


SCALY_POLICY = {"min_replicas": 1, "max_replicas": 2,
                "queue_depth_high": 3.0, "queue_depth_low": 0.5,
                "occupancy_low": 0.5, "up_for_s": 2.0, "down_for_s": 3.0,
                "cooldown_s": 0.0}


@serve.deployment(name="scaly", scaling_policy=SCALY_POLICY)
class Scaly:
    """Reports the queue depth it is told to, as an LLM replica reports
    its blocked submitters."""

    def __init__(self):
        self._q = 0.0

    def set_queue(self, q):
        self._q = float(q)
        return self._q

    def serve_stats(self):
        return {"queued": self._q, "slots_busy": 0.0,
                "slots_total": 1.0, "occupancy": 0.0}

    def __call__(self, x):
        return x


def test_autoscaling_up(serve_instance):
    """autoscaling_config: sustained concurrent load well above
    target_ongoing_requests a replica adds replicas."""
    handle = serve.run(Slow.bind(), route_prefix="/slow")
    try:
        t_end = time.time() + 8
        grew = False
        while time.time() < t_end and not grew:
            resps = [handle.remote(i) for i in range(12)]
            for r in resps:
                r.result(timeout=30)
            grew = serve.status()["Slow"]["num_replicas"] > 1
        assert grew, "autoscaler never scaled up under sustained load"
    finally:
        serve.delete("Slow")


def _set_all(name, q):
    for r in controller._local.get_replicas(name)[1]:
        r.handle_request("set_queue", (q,), timeout=10)


def test_autoscaler_scales_up_and_drains_down(serve_instance):
    """scaling_policy: sustained queue depth scales the pool up; idle
    drains it back down without stopping a busy replica, and requests
    keep succeeding throughout."""
    handle = serve.run(Scaly.bind(), route_prefix="/scaly")
    try:
        def stats():
            return controller._local.get_serve_stats()["scaly"]

        assert stats()["replicas"] == 1
        deadline = time.time() + 30
        grew = False
        while time.time() < deadline:
            _set_all("scaly", 10.0)
            if stats()["replicas"] >= 2:
                grew = True
                break
            time.sleep(0.5)
        assert grew, "autoscaler never scaled up under queue pressure"
        assert handle.remote(1).result(timeout=30) == 1

        deadline = time.time() + 45
        shrank = False
        while time.time() < deadline:
            _set_all("scaly", 0.0)
            st = stats()
            if st["replicas"] == 1 and st["draining"] == 0:
                shrank = True
                break
            assert handle.remote(2).result(timeout=30) == 2
            time.sleep(0.5)
        assert shrank, "autoscaler never drained back down when idle"
        assert handle.remote(3).result(timeout=30) == 3
        (retired,) = controller._local.get_retired("scaly")
        assert retired["stats"]["ongoing"] == 0, retired
        assert retired["drain_s"] >= 3.0, retired
    finally:
        serve.delete("scaly")


# ------------------------------------------- the autoscaler against JAX's


def _signals(case):
    """(now, {deployment: signals}) ticks of a case, two deployments,
    uneven steps so the for-durations land between ticks."""
    ticks, now = [], 0.0
    for i in range(24):
        now += 0.7 if i % 3 else 1.1
        if case == "rising_queue":
            a = {"queue_depth": 0.5 * i, "occupancy": 0.3}
        elif case == "rising_occupancy":
            a = {"queue_depth": 0.0, "occupancy": min(1.0, 0.06 * i)}
        elif case == "idle":
            a = {"queue_depth": 0.0 if i > 3 else 6.0, "occupancy": 0.1}
        else:  # cooldown, autoscale_off: sustained pressure
            a = {"queue_depth": 9.0, "occupancy": 1.0}
        b = {"queue_depth": 0.2, "occupancy": 0.4 if i % 5 else 0.97}
        ticks.append((now, {"a": a, "b": b}))
    return ticks


@pytest.mark.parametrize("case", ["rising_queue", "rising_occupancy",
                                  "idle", "cooldown", "autoscale_off"])
def test_autoscaler_deltas_equal_jax(case, monkeypatch):
    """The port's ServeAutoscaler and the JAX package's, fed the same
    signal sequences at the same ``now``, give identical deltas."""
    from ray_tpu.serve.autoscaler import ServeAutoscaler as JaxAutoscaler

    from ray_tpu_torch.serve.autoscaler import ServeAutoscaler

    if case == "autoscale_off":
        monkeypatch.setenv("RTPU_SERVE_AUTOSCALE", "0")
    pa = {"min_replicas": 1, "max_replicas": 4, "queue_depth_high": 3.0,
          "occupancy_high": 0.9, "up_for_s": 2.0, "down_for_s": 3.0,
          "cooldown_s": 4.0 if case == "cooldown" else 0.0}
    pb = {"up_for_s": 1.0, "down_for_s": 1.5}
    port, ref = ServeAutoscaler(), JaxAutoscaler()
    for a in (port, ref):
        a.configure("a", pa)
        a.configure("b", pb)
    got = [port.step(now, sig) for now, sig in _signals(case)]
    want = [ref.step(now, sig) for now, sig in _signals(case)]
    assert got == want
    if case == "autoscale_off":
        assert not any(got)
    else:
        assert any(d.get("a") for d in got), got


def _ttft_signals(case):
    """(now, signals) ticks with a TTFT p99 beside quiet queue and
    occupancy: rising, a spike, flat above the bound, absent."""
    ticks, now = [], 0.0
    for i in range(24):
        now += 0.7 if i % 3 else 1.1
        a = {"queue_depth": 0.2, "occupancy": 0.4}
        if case == "rising":
            a["ttft_p99_s"] = 0.1 * i
        elif case == "spike":
            a["ttft_p99_s"] = 5.0 if 6 <= i <= 7 else 0.2
        elif case == "sustained":
            a["ttft_p99_s"] = 3.0
        b = {"queue_depth": 0.0, "occupancy": 0.1, "ttft_p99_s": 0.05 * i}
        ticks.append((now, {"a": a, "b": b}))
    return ticks


@pytest.mark.parametrize("case", ["rising", "spike", "sustained",
                                  "absent"])
def test_autoscaler_ttft_deltas_equal_jax(case):
    """The TTFT trigger: the port's ServeAutoscaler and the JAX
    package's, fed the same TTFT p99 signals at the same ``now``, give
    identical deltas (a policy without the trigger ignores the signal)."""
    from ray_tpu.serve.autoscaler import ServeAutoscaler as JaxAutoscaler

    from ray_tpu_torch.serve.autoscaler import ServeAutoscaler

    pa = {"min_replicas": 1, "max_replicas": 4, "ttft_p99_high_s": 1.0,
          "queue_depth_high": 100.0, "occupancy_high": 2.0,
          "up_for_s": 2.0, "down_for_s": 30.0, "cooldown_s": 0.0}
    pb = {"up_for_s": 1.0, "down_for_s": 60.0}
    port, ref = ServeAutoscaler(), JaxAutoscaler()
    for a in (port, ref):
        a.configure("a", pa)
        a.configure("b", pb)
    got = [port.step(now, sig) for now, sig in _ttft_signals(case)]
    want = [ref.step(now, sig) for now, sig in _ttft_signals(case)]
    assert got == want
    ups = [d for d in got if d.get("a") == 1]
    assert bool(ups) == (case in ("rising", "sustained")), got
    assert not any(d.get("b") for d in got)


TTFT_POLICY = {"min_replicas": 1, "max_replicas": 2,
               "ttft_p99_high_s": 0.001, "queue_depth_high": 1e9,
               "occupancy_high": 2.0, "up_for_s": 1.0, "down_for_s": 600.0,
               "cooldown_s": 0.0}


def test_ttft_trigger_scales_on_real_histograms(serve_instance, tmp_path):
    """A deployment whose only trigger is ``ttft_p99_high_s`` reaches
    target 2 from the TTFT histograms its replica's engine records: the
    replica ships them to the controller's sink, the sink's TSDB gives
    the p99 the signal plane reads."""
    from ray_tpu_torch.serve.llm import build_streaming_llm_deployment

    jref = base.JaxReference(tmp_path)
    name = "ttft-llm"
    dep = build_streaming_llm_deployment(
        base.port_cfg(), jref.factory, name=name, max_prompt_len=16,
        max_new_tokens=4, continuous_batching=True, num_slots=2,
        num_gpus=0).options(scaling_policy=TTFT_POLICY)
    handle = serve.run(dep.bind(), route_prefix="/ttft")
    try:
        def stats():
            return controller._local.get_serve_stats()[name]

        deadline = time.time() + 40
        while time.time() < deadline and stats()["target"] < 2:
            toks = [c["token"] for c in handle.options(stream=True).remote(
                {"tokens": [5, 9, 2]})]
            assert toks == jref.tokens([5, 9, 2], 4)
            time.sleep(0.2)
        st = stats()
        assert st["target"] == 2, st
        assert st["ttft_p99_s"] >= TTFT_POLICY["ttft_p99_high_s"], st
        assert st["queue_depth"] < 1 and st["occupancy"] < 2
    finally:
        serve.delete(name)


def test_disagg_builder_passes_pool_policies():
    """build_disagg_llm_deployment's prefill_/decode_scaling_policy put
    each pool under the autoscaler."""
    from ray_tpu_torch.serve.disagg import build_disagg_llm_deployment

    pre = {"min_replicas": 1, "max_replicas": 3}
    dec = {"min_replicas": 1, "max_replicas": 2, "queue_depth_high": 2.0}
    app = build_disagg_llm_deployment(
        base.port_cfg(), base.NpzParams("unused.npz"), num_gpus=0,
        prefill_scaling_policy=pre, decode_scaling_policy=dec)
    configs = {n.deployment.name: n.deployment.config
               for n in app._flatten()}
    assert configs["llm-prefill"].scaling_policy == pre
    assert configs["llm-decode"].scaling_policy == dec
    assert configs["llm"].scaling_policy is None


# ------------------------------------------------------ pending replicas

# Run as a file: a replica process runs it again as its main module, so
# the simulated cards (CARDS of them, taken without CUDA) hold there too.
_PENDING_SCRIPT = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import torch

CARDS = [1]
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: CARDS[0]
torch.cuda.set_device = lambda device: None
from ray_tpu_torch.util import procs
procs.take_card = lambda card: os.environ.__setitem__("LOCAL_RANK", str(card))
from ray_tpu_torch import serve
from ray_tpu_torch.serve import controller

POLICY = {{"min_replicas": 1, "max_replicas": 2, "queue_depth_high": 2.0,
          "up_for_s": 1.0, "down_for_s": 2.0, "cooldown_s": 0.0}}


@serve.deployment(name="carded", ray_actor_options={{"num_gpus": 1}},
                  scaling_policy=POLICY)
class Carded:
    def __init__(self):
        self.q = 0.0

    def set_queue(self, q):
        self.q = float(q)

    def serve_stats(self):
        return {{"queued": self.q, "slots_busy": 0.0, "slots_total": 1.0}}

    def __call__(self, x):
        return os.environ["LOCAL_RANK"]


def until(cond, pressure, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        for r in controller._local.get_replicas("carded")[1]:
            r.handle_request("set_queue", (pressure,), timeout=10)
        st = controller._local.get_serve_stats()["carded"]
        if cond(st):
            return st
        time.sleep(0.2)
    raise AssertionError(f"timed out: {{st}}")


if __name__ == "__main__":
    handle = serve.run(Carded.bind())
    try:
        st = until(lambda s: s["target"] == 2, 5.0)
        time.sleep(2.5)  # passes of the control loop with the card taken
        st = controller._local.get_serve_stats()["carded"]
        print("ONE_CARD", st["target"], st["replicas"], st["pending"],
              st["spawned"], controller._local.get_last_error("carded"),
              serve.status()["carded"]["pending"])
        st = until(lambda s: s["target"] == 1 and s["pending"] == 0, 0.0)
        print("ONE_CARD_IDLE", st["target"], st["replicas"], st["pending"],
              st["draining"], st["spawned"])
        CARDS[0] = 2
        st = until(lambda s: s["ready"] == 2, 5.0)
        cards = sorted(s["card"] for s in
                       controller._local.get_replica_starts("carded"))
        answers = sorted({{handle.remote(i).result(timeout=30)
                          for i in range(20)}})
        print("TWO_CARDS", st["ready"], st["pending"], cards, answers)
        st = until(lambda s: s["replicas"] == 1 and s["draining"] == 0, 0.0)
        retired = controller._local.get_retired("carded")
        print("DRAINED", st["replicas"], st["pending"],
              [r["card"] for r in retired])
    finally:
        serve.shutdown()
"""


def test_pending_replicas_wait_for_a_card(tmp_path):
    """Divergence by design: a target past the free cards leaves the extra
    replica pending (no spawn, no error) where the JAX package leaves an
    actor waiting for a chip; it is dropped first when the target falls,
    and with a second card the next scale-up spawns on it and drains back
    off it. Cards are simulated (a replica takes its card's number)."""
    script = tmp_path / "pending_cards.py"
    script.write_text(_PENDING_SCRIPT.format(repo=str(REPO)))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=150, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for want in ("ONE_CARD 2 1 1 1 None 1", "ONE_CARD_IDLE 1 1 0 0 1",
                 "TWO_CARDS 2 0 [0, 1] ['0', '1']", "DRAINED 1 0 [1]"):
        assert want in lines, (want, proc.stdout, proc.stderr[-3000:])
