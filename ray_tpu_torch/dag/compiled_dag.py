"""Compiled DAGs: persistent actor pipelines on shared-memory channels
(counterpart of the JAX package's ``dag/compiled_dag.py``).

``compile`` turns an actor-method graph into a static channel plan, one
reusable slot ring per edge (``dag/channels.py``, depth
``max_in_flight``), and installs a resident loop on every participating
actor's process (``dag/resident.py``). A steady-state ``execute()`` is
one slot write and at most one doorbell; the driver's pump thread drains
the terminal rings into a result table.

The stall probe runs when nothing moved for ``RTPU_DAG_STALL_S`` with
work outstanding. It reads each stage actor's process (the driver is
every actor's parent, so a death is its process's exit, seen at once) and
asks each resident loop for its status: a slow stage that is alive is
waited for, however long it takes (a stage still warming its card up is
not a dead one). With ``RTPU_DAG_RECOVERY`` a dead stage with restarts
left heals in place (``_recover``: quiesce, restart, rebuild the affected
edges, replay); without it, or with no restart left, the DAG tears down
and every outstanding ref raises ``DAGTeardownError``.

``RTPU_DAG_CHANNELS=0``, or a graph the channels cannot express (a bare
task node, no InputNode, a node nested in a container argument), falls
back to the submit path: every ``execute()`` submits the stage chain as
ordinary actor calls, ``max_in_flight`` bounding the depth through
``wait`` on the oldest outstanding ref.

One host: every edge is a ring. The JAX module's cross-host stream
edges, node-loss and drain cases are left out.
"""
from __future__ import annotations

import glob
import os
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .. import flags
from ..core import api, events
from ..core.object_store import CHANNEL_PREFIX, SlotRing
from ..util import metrics as um
from . import channels, meter
from .channels import DAGTeardownError
from .dag_node import (ClassMethodNode, ClassNode, DAGNode, FunctionNode,
                       InputAttributeNode, InputNode, MultiOutputNode)

_m_execute = um.Histogram(
    "rtpu_dag_execute_seconds",
    description="Compiled-DAG step latency: input channel write to the "
                "final result at the driver",
    boundaries=(0.0001, 0.001, 0.01, 0.1, 1.0, 10.0))
_m_recoveries = um.Counter(
    "rtpu_dag_recoveries_total",
    description="Compiled-DAG in-place recoveries completed, by cause",
    tag_keys=("cause",))
_m_recovery_s = um.Histogram(
    "rtpu_dag_recovery_seconds",
    description="Compiled-DAG recovery latency: a stage's death seen to "
                "the pipeline resumed",
    boundaries=(0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0))

# Seconds an actor gets to answer a control call of the DAG.
_CONTROL_S = 30.0

_live: "weakref.WeakSet[CompiledDAG]" = weakref.WeakSet()


def teardown_all() -> None:
    """Tear down every live compiled DAG (the core's shutdown)."""
    for dag in list(_live):
        dag.teardown(kill_actors=False)


class _ChannelUnsupported(Exception):
    """This graph cannot compile to channels: use the submit path."""


class CompiledDAGRef:
    """The future of one submit-path execution: the final stage's ref."""

    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout: Optional[float] = None):
        return api.get(self._ref, timeout=timeout)

    @property
    def ref(self):
        return self._ref


class ChannelDAGRef:
    """The future of one channel-mode execution: a (dag, seq) pair. Its
    value lives in the terminal ring until the driver's pump stores it."""

    _UNSET = object()

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value: Any = self._UNSET

    @property
    def seq(self) -> int:
        return self._seq

    def get(self, timeout: Optional[float] = None):
        if self._value is self._UNSET:
            self._value = self._dag._get_result(self._seq, timeout)
        return self._value


class _MeterSource:
    """The compiled DAG as a meter source: every edge's ring (the driver's
    own, or attached by name, again after a rebuild) and the stages'
    counters from the DAG's StageBlock."""

    def __init__(self, dag: "CompiledDAG"):
        self._dag = dag
        self.dag_id = dag.dag_id
        self._attached: Dict[str, SlotRing] = {}

    @property
    def rings(self) -> Dict[str, SlotRing]:
        dag = self._dag
        out: Dict[str, SlotRing] = {}
        for eid, e in dag._plan["edges"].items():
            name = e["ring"]["name"]
            if eid == "in" and dag._input_writer is not None:
                out[eid] = dag._input_writer.ring
                continue
            ring = self._attached.get(eid)
            if ring is None or ring.name != name:
                if ring is not None:
                    ring.close()
                    self._attached.pop(eid)
                try:
                    ring = self._attached[eid] = SlotRing.attach(name)
                except (FileNotFoundError, ValueError):
                    continue  # not (yet) created
            out[eid] = ring
        return out

    @property
    def stage_ns(self) -> Dict[int, Dict[str, int]]:
        block = self._dag._block
        return {} if block is None else block.read()

    def close(self) -> None:
        for ring in self._attached.values():
            ring.close()
        self._attached.clear()


class CompiledDAG:
    def __init__(self, output_node: DAGNode, *, max_in_flight: int = 16):
        self._output = output_node
        self._nodes = output_node.topological()
        self._max_in_flight = max(1, int(max_in_flight))
        self._inflight: deque = deque()
        self._torn_down = False
        self._teardown_done = threading.Event()
        self._cond = threading.Condition()
        self._plan: Dict[str, Any] = {}
        # Validate the whole graph before creating anything: a rejected
        # graph must not leave half its actors behind.
        for n in self._nodes:
            if not isinstance(n, (ClassNode, ClassMethodNode, FunctionNode,
                                  InputNode, InputAttributeNode,
                                  MultiOutputNode)):
                raise TypeError(f"cannot compile node type "
                                f"{type(n).__name__}")
            if isinstance(n, ClassNode):
                for up in n.topological():
                    if isinstance(up, (InputNode, InputAttributeNode)):
                        raise TypeError(
                            "compiled DAG: actor constructor arguments "
                            "cannot reference InputNode: actors are built "
                            "once at compile time, not per execution")
        # Each ClassNode's actor, made once: the handles persist across
        # executions (the difference from DAGNode.execute()).
        self._actor_handles: Dict[int, Any] = {}
        boot_memo: Dict[int, Any] = {}
        for n in self._nodes:
            if isinstance(n, ClassNode):
                self._actor_handles[id(n)] = n._execute_memo(boot_memo)
        self._mode = "submit"
        self.dag_id = uuid.uuid4().hex
        if flags.get("RTPU_DAG_CHANNELS"):
            try:
                self._compile_channels()
                self._mode = "channels"
            except _ChannelUnsupported:
                pass  # the submit path stays whole
        _live.add(self)

    # =================================================== channel compile

    def _compile_channels(self) -> None:
        """Build the channel plan and install it. Raises
        _ChannelUnsupported for a graph the plan cannot express; any other
        error is a real compile error."""
        plan = self._analyze()
        self._rt = api.runtime()
        self._plan = plan
        self._place_edges(plan)
        self._input_writer: Optional[channels.ShmEdgeWriter] = None
        self._terminal_readers: Dict[str, channels.ShmEdgeReader] = {}
        self._results: Dict[int, Dict[str, Tuple[int, bytes]]] = {}
        self._finished: set = set()
        self._exec_ts: Dict[int, float] = {}
        self._next_seq = 0
        self._done_contig = 0
        self._error: Optional[BaseException] = None
        self._xlock = threading.Lock()
        self._pump_stop = threading.Event()
        self._recovering = False
        self._recovery_count = 0
        self._terminal_next: Dict[str, int] = {}  # edge -> next unseen seq
        self._block: Optional[meter.StageBlock] = None
        self._meter_src: Optional[_MeterSource] = None
        try:
            if flags.get("RTPU_DAG_METER"):
                self._block = meter.StageBlock.create(
                    plan["meter"], len(plan["stages"]))
            self._install(plan)
            self._open_driver_channels(plan)
        except Exception:
            self._teardown_channels()
            raise
        meter.note_compiled(
            self.dag_id,
            [{"idx": s["idx"], "actor_id": s["actor_id"],
              "method": s["method"]} for s in plan["stages"]],
            {eid: "shm" for eid in plan["edges"]}, plan["depth"])
        if self._block is not None:
            self._meter_src = _MeterSource(self)
            meter.register_source(self._meter_src)
        self._pump_thread = threading.Thread(
            target=self._pump, name=f"dag-pump-{self.dag_id[:8]}",
            daemon=True)
        self._pump_thread.start()

    # -- graph analysis ----------------------------------------------

    def _analyze(self) -> Dict[str, Any]:
        input_node: Optional[InputNode] = None
        stages: List[Dict[str, Any]] = []
        stage_of: Dict[int, int] = {}  # id(ClassMethodNode) -> stage idx
        for n in self._nodes:
            if isinstance(n, FunctionNode):
                raise _ChannelUnsupported("bare task nodes")
            if isinstance(n, InputNode):
                input_node = n
            if isinstance(n, ClassMethodNode):
                stage_of[id(n)] = len(stages)
                stages.append({"node": n})
        if input_node is None or not stages:
            raise _ChannelUnsupported("no InputNode / no actor stages")
        out = self._output
        if isinstance(out, MultiOutputNode):
            for o in out._outputs:
                if not isinstance(o, ClassMethodNode):
                    raise _ChannelUnsupported("non-stage terminal output")
            terminal_stages = [stage_of[id(o)] for o in out._outputs]
        elif isinstance(out, ClassMethodNode):
            terminal_stages = [stage_of[id(out)]]
        else:
            raise _ChannelUnsupported("output must be an actor stage")

        def classify(v) -> tuple:
            if isinstance(v, InputNode):
                return ("input", None)
            if isinstance(v, InputAttributeNode):
                return ("input", v._key)
            if isinstance(v, ClassMethodNode):
                return ("stage", stage_of[id(v)])
            if isinstance(v, DAGNode):
                raise _ChannelUnsupported(f"binding {type(v).__name__}")
            if isinstance(v, (list, tuple, dict)):
                probe = [v]
                while probe:
                    x = probe.pop()
                    if isinstance(x, DAGNode):
                        raise _ChannelUnsupported(
                            "DAG node nested inside a container arg")
                    if isinstance(x, (list, tuple)):
                        probe.extend(x)
                    elif isinstance(x, dict):
                        probe.extend(x.values())
            return ("const", v)

        for idx, st in enumerate(stages):
            n: ClassMethodNode = st["node"]
            owner = n._owner
            if isinstance(owner, ClassNode):
                handle = self._actor_handles[id(owner)]
            elif isinstance(owner, DAGNode):
                raise _ChannelUnsupported("unsupported method owner")
            else:
                handle = owner  # a live ActorHandle
            args = [classify(a) for a in n._bound_args]
            kwargs = {k: classify(v) for k, v in n._bound_kwargs.items()}
            if not any(b[0] != "const"
                       for b in list(args) + list(kwargs.values())):
                # A stage with only constant bindings would run ahead of
                # the per-seq lockstep of the channel loop.
                raise _ChannelUnsupported("stage with no data dependency")
            st.update({"idx": idx, "actor_id": handle._actor_id,
                       "handle": handle, "method": n._method,
                       "raw_args": args, "raw_kwargs": kwargs})
        return {
            "dag_id": self.dag_id,
            "depth": self._max_in_flight,
            "slot_bytes": int(flags.get("RTPU_DAG_SLOT_BYTES")),
            "stages": stages,
            "terminal_stages": terminal_stages,
            "meter": f"{self._prefix()}m",
        }

    def _prefix(self) -> str:
        return f"{CHANNEL_PREFIX}{self.dag_id[:12]}"

    def _endpoint(self, actor_id: str) -> Dict[str, Any]:
        """A stage actor's endpoint: its id and its process's incarnation,
        once the process is ready."""
        info = self._rt.wait_actor(
            actor_id, lambda i: i["ready"] or i["state"] == "dead",
            _CONTROL_S)
        if info["state"] == "dead" or not info["ready"]:
            raise RuntimeError(
                f"compiled DAG: actor {actor_id[:8]} is not alive "
                f"(state={info['state']}: {info['death']})")
        return {"actor_id": actor_id, "pid": info["pid"],
                "incarnation": info["incarnation"]}

    def _place_edges(self, plan: Dict[str, Any]) -> None:
        """One edge a producer ("in" for the driver's input, "e<idx>" a
        stage), with stage-level consumers: a diamond is one ring with two
        reader cursors, not two copies."""
        endpoints: Dict[str, Dict[str, Any]] = {"driver": {}}
        for st in plan["stages"]:
            endpoints[f"s{st['idx']}"] = self._endpoint(st["actor_id"])
        plan["endpoints"] = endpoints
        edges: Dict[str, Dict[str, Any]] = {}

        def consume(eid: str, producer: str, consumer_ep: str) -> None:
            e = edges.setdefault(eid, {"producer": producer,
                                       "consumers": []})
            if consumer_ep not in e["consumers"]:
                e["consumers"].append(consumer_ep)

        for st in plan["stages"]:
            ep = f"s{st['idx']}"

            def bind(b):
                if b[0] == "const":
                    return ("const", b[1])
                if b[0] == "input":
                    consume("in", "driver", ep)
                    return ("chan", "in", b[1])
                prod = plan["stages"][b[1]]
                if prod["actor_id"] == st["actor_id"]:
                    # The same actor: the value stays in the resident
                    # loop's memory, no channel, no pickling.
                    return ("local", b[1])
                consume(f"e{b[1]}", f"s{b[1]}", ep)
                return ("chan", f"e{b[1]}", None)

            st["args"] = [bind(b) for b in st["raw_args"]]
            st["kwargs"] = {k: bind(b) for k, b in st["raw_kwargs"].items()}
        self._output_edges: List[str] = []
        for tidx in plan["terminal_stages"]:
            consume(f"e{tidx}", f"s{tidx}", "driver")
            self._output_edges.append(f"e{tidx}")
        for st in plan["stages"]:
            eid = f"e{st['idx']}"
            st["out_edge"] = eid if eid in edges else None
        for eid, e in edges.items():
            consumers = e.pop("consumers")
            if len(consumers) > SlotRing.MAX_READERS:
                raise _ChannelUnsupported(
                    f"edge {eid}: {len(consumers)} consumers exceed the "
                    "slot ring's reader table")
            e["ring"] = {"name": f"{self._prefix()}{eid}",
                         "n_readers": len(consumers)}
            e["ring_idx"] = {c: i for i, c in enumerate(consumers)}
            e["epoch"] = 0
        plan["edges"] = edges

    # -- wiring ------------------------------------------------------

    @staticmethod
    def _wire_plan(plan: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "dag_id": plan["dag_id"], "depth": plan["depth"],
            "slot_bytes": plan["slot_bytes"], "meter": plan["meter"],
            "stages": [{"idx": s["idx"], "actor_id": s["actor_id"],
                        "method": s["method"], "args": s["args"],
                        "kwargs": s["kwargs"], "out_edge": s["out_edge"]}
                       for s in plan["stages"]],
            "edges": plan["edges"],
            "endpoints": plan["endpoints"],
        }

    def _actor_ids(self) -> List[str]:
        return sorted({info["actor_id"]
                       for ep, info in self._plan["endpoints"].items()
                       if ep != "driver"})

    def _install(self, plan: Dict[str, Any],
                 recover: Optional[Dict[str, Any]] = None,
                 actors: Optional[List[str]] = None) -> None:
        """Send each actor its plan (``dag_install``); each answers once
        the rings it produces exist, and then runs its loop."""
        wire = self._wire_plan(plan)
        calls = [self._rt.control_send(aid, "dag_install", wire, recover)
                 for aid in (actors if actors is not None
                             else self._actor_ids())]
        for c in calls:
            self._rt.control_wait(c, _CONTROL_S)

    def _retain_depth(self) -> int:
        # +2 covers the cursor positions a paused consumer can report past
        # its last applied seq (one consumed but not applied, one mid
        # advance), so a replay always has what a reader still needs.
        return (self._max_in_flight + 2
                if flags.get("RTPU_DAG_RECOVERY") else 0)

    def _new_input_writer(self, edge: Dict[str, Any]
                          ) -> channels.ShmEdgeWriter:
        cfg = edge["ring"]
        ring = SlotRing.create(
            self._plan["depth"], self._plan["slot_bytes"], cfg["n_readers"],
            name=cfg["name"], epoch=int(edge.get("epoch", 0)),
            base=int(cfg.get("base", 0)), reader_starts=cfg.get("starts"))
        return channels.ShmEdgeWriter(ring, retain=self._retain_depth())

    def _open_driver_channels(self, plan: Dict[str, Any]) -> None:
        in_edge = plan["edges"].get("in")
        if in_edge is not None:
            self._input_writer = self._new_input_writer(in_edge)
        for eid in set(self._output_edges):
            e = plan["edges"][eid]
            self._terminal_readers[eid] = channels.ShmEdgeReader(
                e["ring"]["name"], e["ring_idx"]["driver"],
                expect_epoch=int(e.get("epoch", 0)))

    # -- the driver's pump -------------------------------------------

    def _pump(self) -> None:
        """Drain the terminal rings into the result table (so unread
        results never clog the window), watch for stalls, and probe the
        participants when one appears. The readers are read again every
        sweep: a recovery may swap a terminal edge's reader."""
        slice_s = 0.05 if len(self._terminal_readers) == 1 else 0.002
        want = len(self._terminal_readers)
        last_progress = time.monotonic()
        stall_s = float(flags.get("RTPU_DAG_STALL_S"))
        while not self._pump_stop.is_set():
            progressed = False
            for eid, r in list(self._terminal_readers.items()):
                try:
                    item = r.recv(slice_s, stop=self._pump_stop.is_set)
                except channels.ChannelClosed:
                    if not self._pump_stop.is_set():
                        self._fail(DAGTeardownError(
                            f"compiled DAG {self.dag_id[:8]}: terminal "
                            f"channel {eid} closed by its producer"))
                    return
                if item is None:
                    continue
                progressed = True
                seq, kind, payload = item
                if seq >= self._terminal_next.get(eid, 0):
                    self._terminal_next[eid] = seq + 1
                t0 = None
                with self._cond:
                    entry = self._results.setdefault(seq, {})
                    entry[eid] = (kind, payload)
                    if len(entry) == want:
                        self._finished.add(seq)
                        while self._done_contig in self._finished:
                            self._done_contig += 1
                        t0 = self._exec_ts.pop(seq, None)
                        self._cond.notify_all()
                if t0 is not None:
                    _m_execute.observe(time.perf_counter() - t0)
            if progressed:
                last_progress = time.monotonic()
                continue
            with self._cond:
                outstanding = self._next_seq - self._done_contig
            if outstanding == 0:
                last_progress = time.monotonic()
            elif time.monotonic() - last_progress > stall_s:
                if not self._probe():
                    return
                last_progress = time.monotonic()

    def _status(self, aid: str) -> Optional[Dict[str, Any]]:
        """The actor's resident status, or None where it did not answer."""
        try:
            return self._rt.control(aid, "dag_status", self.dag_id,
                                    timeout=5.0)
        except Exception:  # noqa: BLE001 — no answer: judged by process
            return None

    def _probe(self) -> bool:
        """No progress with work outstanding: look at every participant.
        Returns False when the DAG was failed (the pump leaves)."""
        dead_eps: Dict[str, str] = {}
        for ep, want in self._plan["endpoints"].items():
            if ep == "driver":
                continue
            info = self._rt.actor_info(want["actor_id"])
            if info["state"] == "dead":
                self._fail(DAGTeardownError(
                    f"compiled DAG {self.dag_id[:8]}: stage actor "
                    f"{want['actor_id'][:8]} is dead and will not restart "
                    f"({info['death']})"))
                return False
            if info["incarnation"] != want["incarnation"]:
                dead_eps[ep] = "worker_killed"
        if dead_eps and not flags.get("RTPU_DAG_RECOVERY"):
            self._fail(DAGTeardownError(
                f"compiled DAG {self.dag_id[:8]}: stage process of "
                f"{sorted(dead_eps)} died; channels cannot be "
                f"re-established with RTPU_DAG_RECOVERY=0: recompile the "
                f"DAG"))
            return False
        for aid in self._actor_ids():
            if any(self._plan["endpoints"][ep]["actor_id"] == aid
                   for ep in dead_eps):
                continue
            r = self._status(aid)
            if r is not None and r.get("failed"):
                self._fail(DAGTeardownError(
                    f"compiled DAG {self.dag_id[:8]}: resident loop "
                    f"failed: {r['failed']}"))
                return False
            # No answer from a live process: a stage busy in a long call
            # (a card warming up): wait, the next stall probes again.
        if dead_eps:
            return self._recover(dead_eps, "worker_killed")
        return True

    # -- self-healing (RTPU_DAG_RECOVERY) -----------------------------

    def _event(self, severity: str, kind: str, message: str,
               **data) -> None:
        events.emit(severity, kind, message, source="dag",
                    data={"dag_id": self.dag_id, **data})

    def _recover(self, dead_eps: Dict[str, str], cause: str) -> bool:
        """Heal in place: quiesce the survivors, wait out the actors'
        restarts, rebuild only the affected edges under a bumped epoch,
        replay the retained items, resume. Runs on the pump thread."""
        t0 = time.monotonic()
        dead_aids = sorted({self._plan["endpoints"][ep]["actor_id"]
                            for ep in dead_eps})
        self._recovering = True
        self._recovery_count += 1
        self._event("WARNING", "DAG_PARTICIPANT_DIED",
                    f"compiled DAG {self.dag_id[:8]}: stage actor(s) "
                    f"{[a[:8] for a in dead_aids]} died ({cause})",
                    cause=cause, actors=dead_aids)
        try:
            self._recover_inner(dead_eps)
        except Exception as e:  # noqa: BLE001 — fails the DAG, typed
            self._recovering = False
            with self._cond:
                self._cond.notify_all()
            self._event("ERROR", "DAG_RECOVERY_FAILED",
                        f"compiled DAG {self.dag_id[:8]}: recovery failed: "
                        f"{e!r}", cause=cause, actors=dead_aids)
            self._fail(DAGTeardownError(
                f"compiled DAG {self.dag_id[:8]}: recovery failed "
                f"({type(e).__name__}: {e})"))
            return False
        self._recovering = False
        with self._cond:
            self._cond.notify_all()
        dt = time.monotonic() - t0
        _m_recoveries.inc(1, {"cause": cause})
        _m_recovery_s.observe(dt)
        meter.note_recovery(self.dag_id, cause, dt)
        self._event("INFO", "DAG_RECOVERED",
                    f"compiled DAG {self.dag_id[:8]} recovered in "
                    f"{dt:.3f} s", cause=cause, actors=dead_aids,
                    duration_s=dt)
        return True

    def _recover_inner(self, dead_eps: Dict[str, str]) -> None:
        plan = self._plan
        rt = self._rt
        dead_ep_set = set(dead_eps)
        dead_actor_eps: Dict[str, List[str]] = {}
        for ep in sorted(dead_eps):
            dead_actor_eps.setdefault(
                plan["endpoints"][ep]["actor_id"], []).append(ep)
        self._event("INFO", "DAG_RECOVERING",
                    f"compiled DAG {self.dag_id[:8]}: rebuilding around "
                    f"{sorted(dead_eps)}", actors=sorted(dead_actor_eps))
        survivors = [a for a in self._actor_ids()
                     if a not in dead_actor_eps]

        # 1. Quiesce the survivors; 2. the barrier: each parks and
        # reports its position (next seq, and the inputs it consumed for
        # it already).
        for aid in survivors:
            rt.control(aid, "dag_pause", self.dag_id, timeout=5.0)
        positions: Dict[int, Dict[str, Any]] = {}
        deadline = time.monotonic() + 20.0
        pending = list(survivors)
        while pending:
            if time.monotonic() > deadline:
                raise RuntimeError("the pipeline did not quiesce in 20 s")
            for aid in list(pending):
                r = rt.control(aid, "dag_positions", self.dag_id,
                               timeout=5.0)
                if r.get("failed"):
                    raise RuntimeError(f"a resident loop failed during the "
                                       f"quiesce: {r['failed']}")
                if r.get("known") and r.get("parked"):
                    positions.update({int(k): v for k, v in
                                      (r.get("positions") or {}).items()})
                    pending.remove(aid)
            if pending:
                time.sleep(0.05)

        # 3. Wait for each dead actor's restart (its checkpoint restores
        # in its new process's constructor).
        timeout_s = float(flags.get("RTPU_DAG_RECOVERY_TIMEOUT_S"))
        for aid, eps in dead_actor_eps.items():
            info = rt.wait_actor(
                aid, lambda i: i["state"] == "dead" or i["ready"],
                timeout_s)
            if info["state"] == "dead":
                raise RuntimeError(f"stage actor {aid[:8]} is dead: "
                                   f"{info['death']}")
            if not info["ready"]:
                raise RuntimeError(f"stage actor {aid[:8]} did not come "
                                   f"back within {timeout_s:.0f} s")
            for ep in eps:
                plan["endpoints"][ep] = {
                    "actor_id": aid, "pid": info["pid"],
                    "incarnation": info["incarnation"]}

        # 4. Where each restarted stage resumes: from the journal its
        # restored checkpoint carries, else from the oldest seq any
        # consumer could still need.
        resume: Dict[int, int] = {}
        for aid, eps in dead_actor_eps.items():
            j = rt.control(aid, "dag_resume_info", self.dag_id,
                           timeout=_CONTROL_S)
            for ep in eps:
                idx = int(ep[1:])
                resume[idx] = (int(j[idx]) + 1 if idx in j
                               else self._done_contig)

        # 5. Rewrite only the affected edges: a bumped epoch, a fresh ring
        # name, a start cursor a reader. The other edges keep their rings
        # and cursors.
        affected: set = set()
        for eid, e in plan["edges"].items():
            if (e["producer"] in dead_ep_set
                    or any(c in dead_ep_set for c in e["ring_idx"])):
                affected.add(eid)

        def consumer_need(eid: str, c: str) -> int:
            if c == "driver":
                return int(self._terminal_next.get(eid, 0))
            idx = int(c[1:])
            if c in dead_ep_set:
                return int(resume[idx])
            pos = positions.get(idx)
            if pos is None:
                return int(self._done_contig)
            need = int(pos["next"])
            if eid in (pos.get("have") or ()):
                need += 1
            return need

        starts_msg: Dict[str, Dict[str, int]] = {}
        for eid in sorted(affected):
            e = plan["edges"][eid]
            consumers = list(e["ring_idx"])
            e["epoch"] = int(e.get("epoch", 0)) + 1
            needs = {c: consumer_need(eid, c) for c in consumers}
            starts_msg[eid] = needs
            prod = e["producer"]
            if prod == "driver":
                prod_first = self._next_seq
            elif prod in dead_ep_set:
                prod_first = resume[int(prod[1:])]
            else:
                ppos = positions.get(int(prod[1:]))
                prod_first = (int(ppos["next"]) if ppos
                              else int(self._done_contig))
            e["ring"] = {
                "name": f"{self._prefix()}{eid}p{e['epoch']}",
                "n_readers": len(consumers),
                "base": min([needs[c] for c in consumers]
                            + [int(prod_first)]),
                "starts": [needs[c] for c in consumers]}

        # 6. The driver's own rebuild of the input edge.
        in_edge = plan["edges"].get("in")
        if in_edge is not None and "in" in affected:
            old_writer = self._input_writer
            retained = old_writer.retained if old_writer else None
            if old_writer is not None:
                old_writer.close()
            new_writer = self._new_input_writer(in_edge)
            if retained and new_writer.retained is not None:
                new_writer.retained.extend(retained)
            self._input_writer = new_writer
        reattach = [eid for eid in set(self._output_edges)
                    if eid in affected]
        for eid in reattach:
            self._terminal_readers.pop(eid).close()

        # 7. The rebuild: survivors' parked loops swap their affected
        # channels and replay; each restarted actor installs its part
        # with the recovery's positions and replays from its journal.
        wire = self._wire_plan(plan)
        calls = [rt.control_send(aid, "dag_rebuild", wire, starts_msg,
                                 resume, sorted(affected))
                 for aid in survivors]
        recover = {"resume": resume, "starts": starts_msg,
                   "affected": sorted(affected)}
        calls += [rt.control_send(aid, "dag_install", wire, recover)
                  for aid in dead_actor_eps]
        for c in calls:
            rt.control_wait(c, _CONTROL_S)
        for eid in reattach:
            e = plan["edges"][eid]
            self._terminal_readers[eid] = channels.ShmEdgeReader(
                e["ring"]["name"], e["ring_idx"]["driver"],
                expect_epoch=int(e["epoch"]))

        # 8. The driver's replay: the rebuilt input edge takes again the
        # retained items its consumers still need; an input edge that
        # survived takes only the tail an execute interrupted by the
        # recovery left unwritten.
        iw = self._input_writer
        if iw is not None:
            if "in" in affected:
                iw.replay(in_edge["ring"].get("base"),
                          stop=lambda: self._torn_down)
            elif iw.retained:
                ws = iw.ring.write_seq()
                for seq, kind, payload in list(iw.retained):
                    if seq >= ws:
                        iw.write(seq, kind, payload,
                                 stop=lambda: self._torn_down)

    def _fail(self, err: BaseException) -> None:
        with self._cond:
            if self._error is None:
                self._error = err
            self._cond.notify_all()
        # Full teardown: every outstanding ref resolves with the error.
        self.teardown(kill_actors=False)

    # ==================================================== public surface

    def execute(self, *args, **kwargs):
        if self._torn_down:
            if self._mode == "channels" and self._error is not None:
                raise DAGTeardownError(str(self._error)) from self._error
            raise DAGTeardownError("CompiledDAG has been torn down")
        if self._mode != "channels":
            return self._execute_submit(args, kwargs)
        # The InputNode contract, checked before a seq is taken.
        if args and kwargs:
            raise TypeError(
                "DAG execute() got both positional and keyword inputs; "
                "pass one or the other (use a dict input for named access)")
        if kwargs:
            value: Any = kwargs
        elif len(args) == 1:
            value = args[0]
        else:
            value = args
        payload = channels.encode_value(value)
        with self._xlock:
            with self._cond:
                while (self._error is None and not self._torn_down
                       and (self._recovering
                            or self._next_seq - self._done_contig
                            >= self._max_in_flight)):
                    self._cond.wait(0.05)
                if self._error is not None:
                    raise DAGTeardownError(
                        str(self._error)) from self._error
                if self._torn_down:
                    raise DAGTeardownError("CompiledDAG has been torn down")
                seq = self._next_seq
                self._next_seq += 1
                self._exec_ts[seq] = time.perf_counter()
            if self._input_writer is not None:
                try:
                    self._input_writer.write(
                        seq, channels.KIND_DATA, payload,
                        stop=lambda: self._torn_down or self._recovering)
                except channels.ChannelClosed:
                    # A recovery interrupted the write. The payload is in
                    # the retained window already, so the rebuild replays
                    # it: wait the recovery out and hand back the ref.
                    with self._cond:
                        while (self._recovering and self._error is None
                               and not self._torn_down):
                            self._cond.wait(0.05)
                        clean = (self._error is None
                                 and not self._torn_down)
                    if not clean:
                        err = self._error
                        raise DAGTeardownError(
                            "CompiledDAG was torn down mid-execute"
                            + (f": {err}" if err else "")) from err
        return ChannelDAGRef(self, seq)

    def _execute_submit(self, args, kwargs) -> CompiledDAGRef:
        while len(self._inflight) >= self._max_in_flight:
            oldest = self._inflight.popleft()
            refs = (oldest.ref if isinstance(oldest.ref, list)
                    else [oldest.ref])
            api.wait(refs, num_returns=len(refs))
        memo: Dict[int, Any] = {"__input__": (args, kwargs)}
        memo.update(self._actor_handles)  # the persistent actors
        out = CompiledDAGRef(self._output._execute_memo(memo))
        self._inflight.append(out)
        return out

    def _get_result(self, seq: int, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while seq not in self._finished:
                if self._error is not None:
                    raise DAGTeardownError(
                        str(self._error)) from self._error
                if self._torn_down:
                    raise DAGTeardownError(
                        "CompiledDAG was torn down with this execution "
                        "outstanding")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise api.GetTimeoutError(
                        f"compiled DAG result seq={seq} not ready within "
                        f"{timeout} s")
                self._cond.wait(0.05 if remaining is None
                                else min(0.05, remaining))
            entry = self._results.pop(seq)
        values = []
        for eid in self._output_edges:
            kind, payload = entry[eid]
            if kind == channels.KIND_ERROR:
                raise channels.decode(payload)
            values.append(channels.decode(payload))
        if not isinstance(self._output, MultiOutputNode):
            return values[0]
        return values

    def stage_counters(self) -> Dict[int, Dict[str, int]]:
        """The stages' cumulative phase counters (ns, steps) from the
        meter's block; empty where the meter is off or in submit mode."""
        block = getattr(self, "_block", None)
        return {} if block is None else block.read()

    def teardown(self, *, kill_actors: bool = True) -> None:
        with self._cond:
            already = self._torn_down
            self._torn_down = True
        if already:
            # Another thread (the pump, through _fail) owns the teardown:
            # wait until it is done, so the channels are released when
            # this returns.
            self._teardown_done.wait(timeout=30)
            return
        self._inflight.clear()
        try:
            if self._mode == "channels":
                self._teardown_channels()
            if kill_actors:
                for h in self._actor_handles.values():
                    try:
                        api.kill(h)
                    except Exception:  # noqa: BLE001 — already gone
                        pass
            self._actor_handles.clear()
        finally:
            _live.discard(self)
            self._teardown_done.set()

    def _teardown_channels(self) -> None:
        if self._meter_src is not None:
            meter.unregister_source(self._meter_src)
            self._meter_src.close()
            self._meter_src = None
        meter.note_torndown(self.dag_id)
        self._pump_stop.set()
        with self._cond:
            self._cond.notify_all()
        # Every participant stops its loop and releases its rings (a loop
        # answers once it has); a dead process's are swept below.
        calls = []
        for aid in self._actor_ids():
            try:
                calls.append(self._rt.control_send(aid, "dag_teardown",
                                                   self.dag_id))
            except Exception:  # noqa: BLE001 — the actor is gone
                pass
        for c in calls:
            try:
                self._rt.control_wait(c, 10.0)
            except Exception:  # noqa: BLE001 — a dead or stuck stage
                pass
        pump = getattr(self, "_pump_thread", None)
        if pump is not None and pump is not threading.current_thread():
            pump.join(timeout=5)
        if self._input_writer is not None:
            self._input_writer.close()
            self._input_writer = None
        for r in self._terminal_readers.values():
            r.close()
        self._terminal_readers.clear()
        if self._block is not None:
            self._block.unlink()
            self._block = None
        self._sweep_channel_names()
        with self._cond:
            self._cond.notify_all()

    def _sweep_channel_names(self) -> None:
        """The last pass: unlink every shm segment this DAG could have
        made, every edge, epoch and sidecar. Surviving stages release
        their own; a killed producer leaves its ring and sidecars, and
        only the driver knows the prefix."""
        for path in glob.glob(f"/dev/shm/{self._prefix()}*"):
            channels._unlink_segment(os.path.basename(path))

    def __enter__(self) -> "CompiledDAG":
        return self

    def __exit__(self, *exc):
        self.teardown()
        return False


def compile_dag(output_node: DAGNode, *,
                max_in_flight: int = 16) -> CompiledDAG:
    """The entry point of ``dag.experimental_compile()``."""
    return CompiledDAG(output_node, max_in_flight=max_in_flight)


def _experimental_compile(self: DAGNode, *, max_in_flight: int = 16,
                          **_ignored) -> CompiledDAG:
    return CompiledDAG(self, max_in_flight=max_in_flight)


DAGNode.experimental_compile = _experimental_compile
