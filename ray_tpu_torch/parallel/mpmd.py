"""MPMD pipeline parallelism: stage actors, each a process on one card,
wired by compiled-DAG channels (counterpart of the JAX package's
``parallel/mpmd.py``).

This is the actor-level counterpart of ``parallel/pipeline.py`` (which
runs a GPipe schedule inside one program over the ``pipe`` mesh axis).
Here each stage is a program of its own, an actor process of the core
(``core/api.py``), and microbatches flow from stage to stage through the
shared-memory rings the compiled DAG allocates when it compiles
(``dag/compiled_dag.py``). That buys what the in-graph schedule cannot:

- heterogeneous stages (different model code, a CPU stage feeding card
  stages): MPMD, not SPMD;
- stages on cards of their own (``stage_options`` ``num_gpus=1``), or
  several stage processes on one card (``num_gpus=0``, the stage placing
  its work on a card itself);
- a steady-state dispatch with no control plane: the driver writes one
  slot a microbatch, so the gap between microbatches is bounded by the
  stages' compute and the channel's copies, not by calls.

Overlap comes from the compiled DAG's ``max_in_flight`` window: with W
microbatches in flight, stage k runs microbatch i while stage k+1 runs
i-1, so once the pipeline has filled, the gap between two completions is
about the slowest stage's time, not the sum of the stages'. ``run()``
records the completion gaps so a benchmark can show it.

A value crosses a channel pickled by the core's rules: a CUDA tensor as
its host copy, put on the receiving stage's own card.

Divergences by design:

- a stage is one process on one card: a ``mesh_spec`` over more than one
  card raises before any spawn (a spec of one card is accepted; the
  factory gets ``mesh=None``, the process's card being its mesh);
- a stage's checkpoint (``recovery=True`` checkpoints every stage every
  2 s) is what it was built from: the factory, its index and count and
  the mesh spec, plus the state of its step callable where the callable's
  class defines ``__getstate__``. A restore calls the factory again. The
  JAX stage pickles its whole instance, weights included; a stage that
  holds a model slice on a card must not write gigabytes every 2 s;
- factories go by plain pickle, by reference: a nested factory, a closure
  or a lambda raises ``TypeError`` before any spawn, naming itself.

:class:`TransformerStage` is a factory for a decoder-only transformer cut
by layers: stage 0 embeds, the last applies the final norm and the head.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core import api
from ..core import worker as core_worker
from ..dag import InputNode, meter

# A stage factory: called once inside the stage's process, returns its
# step callable:  factory(stage_idx, num_stages, mesh) -> (x -> y).
StageFactory = Callable[[int, int, Any], Callable[[Any], Any]]

# What the fork server imports once for stage processes (they fork from
# it: a stage is ready in a fraction of the seconds an import of torch
# and the model takes in a fresh process).
STAGE_PRELOAD = ["torch", "ray_tpu_torch.parallel.mpmd",
                 "ray_tpu_torch.models.transformer",
                 "ray_tpu_torch.ops.flash_attention",
                 "ray_tpu_torch.core.worker", "ray_tpu_torch.dag"]


# Seconds the stages get to build (a stage that builds a model on its
# card one after another with the others: minutes for a large one).
READY_TIMEOUT_S = 600.0


def mesh_cards(spec: Any) -> int:
    """The cards a stage's mesh spec spans (an axis of -1 fills what the
    stage has: one card)."""
    if spec is None:
        return 1
    sizes = getattr(spec, "sizes", None)
    if sizes is None:
        raise TypeError(f"mesh_spec {spec!r}: a parallel.mesh.MeshSpec or "
                        "None")
    return math.prod(1 if v == -1 else int(v) for v in sizes().values())


def _has_own_state(fn: Any) -> bool:
    """Does ``fn``'s class define ``__getstate__`` (beyond object's)?"""
    get = getattr(type(fn), "__getstate__", None)
    return get is not None and get is not getattr(object, "__getstate__",
                                                  None)


class _Stage:
    """One pipeline stage: builds its step callable once, then serves
    microbatches through the compiled DAG's resident loop."""

    def __init__(self, factory: StageFactory, stage_idx: int,
                 num_stages: int, mesh_spec: Any = None):
        self._factory = factory
        self._idx = stage_idx
        self._n = num_stages
        self._spec = mesh_spec
        self._build()

    def _build(self) -> None:
        self._fn = self._factory(self._idx, self._n, None)

    def __getstate__(self) -> Dict[str, Any]:
        return {"factory": self._factory, "idx": self._idx, "n": self._n,
                "spec": self._spec,
                "fn_state": (self._fn.__getstate__()
                             if _has_own_state(self._fn) else None)}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self._factory = state["factory"]
        self._idx, self._n, self._spec = state["idx"], state["n"], \
            state["spec"]
        self._build()
        if state["fn_state"] is not None:
            self._fn.__setstate__(state["fn_state"])

    def step(self, x):
        return self._fn(x)

    def describe(self) -> Dict[str, Any]:
        import os

        return {"stage": self._idx, "num_stages": self._n,
                "mesh": (None if self._spec is None
                         else dict(self._spec.sizes())),
                "pid": os.getpid()}

    def fn_call(self, method: str, *args, **kwargs):
        """``method(*args, **kwargs)`` of the stage's step callable."""
        return getattr(self._fn, method)(*args, **kwargs)


_StageActor = api.ActorClass(_Stage)


class MPMDPipeline:
    """An N-stage actor pipeline compiled onto reusable channels.

    ``stage_factories[k]`` builds stage k's step callable (see
    ``StageFactory``). ``mesh_specs`` / ``stage_options`` are optional
    per-stage lists: a spec of one card, and options for ``.options()``
    (``num_gpus=1`` gives a stage a card of its own).

    ``recovery=True`` (the default) makes every stage restartable with
    periodic checkpoints (``RECOVERY_STAGE_OPTIONS``), so a killed stage
    process heals in place: the compiled DAG pauses, the core restarts
    the stage from its checkpoint, only the affected channels are rebuilt
    and the retained microbatches replay exactly once. A stage's own
    ``stage_options`` win over these defaults; ``recovery=False`` tears
    the pipeline down at a death.
    """

    #: Per-stage defaults of ``recovery=True``: restarts for repeated
    #: faults, and a checkpoint cadence that bounds what a restart loses.
    RECOVERY_STAGE_OPTIONS = {
        "max_restarts": 4,
        "max_task_retries": 1,
        "checkpoint_interval_s": 2.0,
    }

    def __init__(
        self,
        stage_factories: Sequence[StageFactory],
        *,
        max_in_flight: int = 8,
        mesh_specs: Optional[Sequence[Any]] = None,
        stage_options: Optional[Sequence[Optional[dict]]] = None,
        recovery: bool = True,
    ):
        if not stage_factories:
            raise ValueError("MPMDPipeline needs at least one stage")
        n = len(stage_factories)
        if mesh_specs is not None and len(mesh_specs) != n:
            raise ValueError("mesh_specs must match stage count")
        if stage_options is not None and len(stage_options) != n:
            raise ValueError("stage_options must match stage count")
        self.num_stages = n
        self.max_in_flight = max_in_flight
        self.recovery = bool(recovery)
        # Everything that can refuse refuses before any stage spawns.
        opts_list, args_list = [], []
        cards = 0
        for i, factory in enumerate(stage_factories):
            spec = mesh_specs[i] if mesh_specs else None
            if mesh_cards(spec) > 1:
                raise ValueError(
                    f"stage {i}: mesh_spec {spec} spans {mesh_cards(spec)} "
                    "cards; a stage is one process on one card")
            opts = dict(self.RECOVERY_STAGE_OPTIONS) if recovery else {}
            opts["_preload"] = STAGE_PRELOAD
            opts.update((stage_options[i] if stage_options else None) or {})
            cards += int(opts.get("num_gpus", 0) or 0)
            core_worker.actor_payload(_Stage, (factory, i, n, spec),
                                      where="stage's process")
            opts_list.append(opts)
            args_list.append((factory, i, n, spec))
        rt = api.runtime()
        if cards:
            free = rt.num_gpus() - len(rt.cards_used)
            if cards > free:
                raise RuntimeError(
                    f"the stages ask {cards} cards (num_gpus=1 each); this "
                    f"host has {free} free of {rt.num_gpus()}")
        handles = []
        try:
            for opts, args in zip(opts_list, args_list):
                handles.append(_StageActor.options(**opts).remote(*args))
            self._handles = handles
            # Ask the stages before compiling: installing the plan hands
            # each stage's call thread to its resident loop until
            # teardown, so ordinary calls would wait behind it.
            self.stage_info: List[Dict[str, Any]] = api.get(
                [h.describe.remote() for h in handles],
                timeout=READY_TIMEOUT_S)
            for info, h in zip(self.stage_info, handles):
                info["spawn_s"] = rt.actor_info(h._actor_id)["spawn_s"][-1]
            with InputNode() as inp:
                node = handles[0].step.bind(inp)
                for h in handles[1:]:
                    node = h.step.bind(node)
            self._compiled = node.experimental_compile(
                max_in_flight=max_in_flight)
        except BaseException:
            for h in handles:
                api.kill(h)
            raise
        #: "channels" when every edge got a ring; "submit" when the flag
        #: is off or the graph fell back.
        self.mode = self._compiled._mode
        self.last_gaps_s: List[float] = []
        self.last_first_result_s: Optional[float] = None
        self._run_window: Optional[tuple] = None

    # -- execution ------------------------------------------------------

    def submit(self, microbatch) -> Any:
        """Feed one microbatch; returns a ref. Blocks only while
        ``max_in_flight`` microbatches are in the pipe."""
        return self._compiled.execute(microbatch)

    def run(self, microbatches: Sequence[Any], *,
            timeout: Optional[float] = 120.0) -> List[Any]:
        """Stream ``microbatches`` through the pipeline with the whole
        in-flight window; returns the outputs in order. Each completion is
        taken as it comes, and the next microbatch fed then, so
        ``last_gaps_s`` holds the wall gap between consecutive completions
        (in the steady state, the slowest stage's time a microbatch). The
        JAX package's run feeds every microbatch before it takes the first
        result, so with more microbatches than the window its first
        completions are taken late, all at once, and their gaps read near
        zero. Also records the stages' meter counters over the run."""
        before = self._compiled.stage_counters()
        t0 = t_start = time.perf_counter()
        todo = iter(microbatches)
        window: deque = deque()
        for mb in todo:
            window.append(self._compiled.execute(mb))
            if len(window) >= self.max_in_flight:
                break
        outs: List[Any] = []
        stamps: List[float] = []
        while window:
            outs.append(window.popleft().get(timeout=timeout))
            stamps.append(time.perf_counter())
            if len(stamps) == self.num_stages:
                # The fill is over: the steady window starts here.
                before, t0 = self._compiled.stage_counters(), stamps[-1]
            for mb in todo:
                window.append(self._compiled.execute(mb))
                break
        self.last_gaps_s = [
            stamps[i] - stamps[i - 1] for i in range(1, len(stamps))]
        #: Seconds from the run's start to its first completion: the
        #: first microbatch through every stage (on a card, each stage's
        #: first, cold step).
        self.last_first_result_s = stamps[0] - t_start if stamps else None
        self._run_window = (before, self._compiled.stage_counters(),
                            time.perf_counter() - t0)
        return outs

    @property
    def recoveries(self) -> int:
        """In-place recoveries the compiled plan has completed."""
        return getattr(self._compiled, "_recovery_count", 0)

    def gap_stats(self) -> Dict[str, Any]:
        """The last run's completion gaps, without the fill ramp (the
        first ``num_stages - 1`` completions arrive while the pipe
        fills), beside the meter's attribution (:meth:`meter_stats`)."""
        gaps = self.last_gaps_s
        steady = gaps[self.num_stages - 1:] or gaps
        if not steady:
            return {"n": 0}
        s = sorted(steady)
        out: Dict[str, Any] = {
            "n": len(steady),
            "mean_us": sum(steady) / len(steady) * 1e6,
            "p50_us": s[len(s) // 2] * 1e6,
            "max_us": s[-1] * 1e6,
        }
        out.update(self.meter_stats())
        return out

    def meter_stats(self) -> Dict[str, Any]:
        """The channel meter's view of this pipeline: the stages' busy
        fractions, each stage's ms a microbatch by phase and the
        bottleneck over the steady part of the last ``run()`` (the
        meter's last sample window before any run), the edges' ring
        counters, and steps a second.
        Empty in submit mode or with RTPU_DAG_METER=0."""
        if self.mode != "channels":
            return {}
        from ..util import state

        row = next((d for d in state.list_compiled_dags()
                    if d.get("dag_id") == self._compiled.dag_id), None)
        out: Dict[str, Any] = {}
        for key in ("stage_busy", "edge_stats", "steps_per_s",
                    "bottleneck"):
            if row and row.get(key):
                out[key] = row[key]
        if self._run_window is not None:
            before, after, wall = self._run_window
            if after:
                out["stage_busy"] = meter.busy_between(before, after, wall)
                out["bottleneck"] = meter.attribute_bottleneck(
                    out["stage_busy"])
                out["stage_ms"] = {}
                for idx, a in after.items():
                    b = before.get(idx) or dict.fromkeys(meter.PHASES, 0)
                    steps = a["steps"] - b["steps"]
                    if steps:
                        out["stage_ms"][f"s{idx}"] = {
                            p: (a[p] - b[p]) / steps / 1e6
                            for p in meter.PHASES if p != "steps"}
        bn = out.get("bottleneck")
        if bn:
            out["bottleneck_stage"] = int(bn[1:])
        return out

    def describe(self) -> List[Dict[str, Any]]:
        """One dict a stage (its index, mesh, pid and spawn-to-ready
        seconds), taken at construction: the live stages cannot be asked
        while the compiled plan holds their call threads."""
        return list(self.stage_info)

    def call_stages(self, method: str, *args, timeout: float = 60.0,
                    **kwargs) -> List[Any]:
        """``method(*args, **kwargs)`` of every stage's step callable, in
        stage order. Only while no plan holds the stages: after
        ``teardown(kill_actors=False)``."""
        if self.mode == "channels" and not self._compiled._torn_down:
            raise RuntimeError("call_stages: the compiled plan holds the "
                               "stages; call teardown(kill_actors=False) "
                               "first")
        return api.get([h.fn_call.remote(method, *args, **kwargs)
                        for h in self._handles], timeout=timeout)

    def teardown(self, *, kill_actors: bool = True) -> None:
        # The pipeline made its stage actors itself (live handles, not
        # ClassNodes), so the compiled DAG does not own them: kill here.
        self._compiled.teardown(kill_actors=False)
        if kill_actors:
            for h in self._handles:
                api.kill(h)


# ------------------------------------------------- a transformer's stages


class TransformerStage:
    """A ``StageFactory`` for a decoder-only transformer
    (``models/transformer.py``) cut by layers: stage k of n keeps layers
    ``[k L // n, (k + 1) L // n)``; stage 0 embeds the tokens, the last
    applies the final norm and the head.

    ``params_factory()`` makes the whole model's params in the stage's
    process, on its device (it is called there, so it goes by pickle: a
    module-level class); the stage keeps its own slice and frees the
    rest, so its weights are the same as a one-process model's from the
    same factory. ``build_lock`` (a file path) makes the stages of one
    host build one after another, so the whole model lives on a card
    once at a time. ``head``: ``"logits"`` returns the f32 logits
    [B, S, V]; ``"last"`` returns (the last position's f32 logits [B, V],
    the greedy token at every position [B, S])."""

    def __init__(self, cfg, params_factory: Callable[[], Any], *,
                 head: str = "logits", build_lock: Optional[str] = None):
        if head not in ("logits", "last"):
            raise ValueError(f"head {head!r}: logits | last")
        self.cfg = cfg
        self.params_factory = params_factory
        self.head = head
        self.build_lock = build_lock

    def __call__(self, idx: int, n: int, mesh: Any) -> "TransformerStep":
        with _file_lock(self.build_lock):
            params = self.params_factory()
            step = TransformerStep(self.cfg, params, idx, n, self.head,
                                   copy=True)
            del params
            gc.collect()
            step.empty_cache()
        return step


@contextlib.contextmanager
def _file_lock(path: Optional[str]):
    if path is None:
        yield
        return
    import fcntl

    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


class TransformerStep:
    """Stage ``idx`` of ``n`` of a transformer on ``params`` (its own
    slice, copied out with ``copy``, so the whole tree can be freed)."""

    def __init__(self, cfg, params: Dict[str, Any], idx: int, n: int,
                 head: str = "logits", copy: bool = False):
        import dataclasses

        self.cfg = dataclasses.replace(cfg, remat=False)
        self.idx, self.n, self.head = idx, n, head
        L = cfg.n_layers
        lo, hi = idx * L // n, (idx + 1) * L // n
        self.layers_range = (lo, hi)

        def keep(t):
            return t.clone() if copy else t

        self.params: Dict[str, Any] = {
            "layers": {k: keep(v[lo:hi])
                       for k, v in params["layers"].items()}}
        names = []
        if idx == 0:
            names += ["embed", "pos_embed"]
        if idx == n - 1:
            names += ["final_norm", "final_norm_b", "lm_head"]
            if "lm_head" not in params:
                names.append("embed")  # a tied head reads embed.T
        for k in names:
            if k in params:
                self.params[k] = keep(params[k])
        self.device = params["layers"][
            next(iter(params["layers"]))].device

    def __call__(self, x):
        import torch

        from ..models import transformer as tf

        cfg, p = self.cfg, self.params
        with torch.no_grad():
            if self.idx == 0:
                tokens = torch.as_tensor(x).to(self.device)
                h = tf.embed_tokens(p, tokens, cfg)
            else:
                h = x.to(self.device)
            B, S = h.shape[0], h.shape[1]
            body = tf.layer_scan_body(cfg, tf._positions(B, S, self.device))
            h, _ = tf.run_layers(body, h, list(tf.iter_layers(p)))
            if self.idx < self.n - 1:
                out = h
            else:
                logits = tf.lm_head(p, h, cfg)
                out = (logits if self.head == "logits" else
                       (logits[:, -1, :].contiguous(), logits.argmax(-1)))
            if self.device.type == "cuda":
                # The step's own time ends with its kernels, not with the
                # host copy that sends its output.
                torch.cuda.synchronize(self.device)
            return out

    def kernel_launches(self) -> Dict[str, int]:
        """This process's launches of the port's kernels so far."""
        from ..ops import flash_attention as fa

        return {"flash_fwd": fa.flash_attention_fwd.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches}

    def empty_cache(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def memory(self) -> Dict[str, Any]:
        """The stage's card, its peak and current allocated bytes (None on
        the CPU)."""
        import torch

        if self.device.type != "cuda":
            return {"device": str(self.device), "peak_bytes": None,
                    "allocated_bytes": None}
        return {"device": str(self.device),
                "peak_bytes": torch.cuda.max_memory_allocated(self.device),
                "allocated_bytes": torch.cuda.memory_allocated(self.device)}
