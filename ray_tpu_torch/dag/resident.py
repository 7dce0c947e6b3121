"""The actor side of a compiled DAG: the resident loop (counterpart of the
JAX package's ``dag/resident.py``, ``:222-860``).

The driver's ``dag_install`` call (``core/worker.py``
``ActorHost.dag_install``) reaches the actor process's one call thread:
:func:`install` creates the rings of the edges this actor produces,
answers the call itself, and runs the resident loop on that thread until
teardown. Ordinary calls that arrive meanwhile wait in the process's
mailbox (``procs.Mailbox``) and run once the loop has given the thread
back; the DAG's own control calls (``dag_teardown``, ``dag_status``,
``dag_pause``, ``dag_positions``, ``dag_rebuild``) the loop takes from
the mailbox and answers itself, at the top of every seq and whenever it
waits on a channel.

The loop blocks on its input rings, runs the bound method, writes the
result into its output edge and goes on to the next seq. Errors are
values: a raised exception travels as a KIND_ERROR item edge by edge to
the driver, which raises it on that seq's ref, and the pipeline runs on.
A torn ring or a closed channel stops the loop and records ``fail``,
which the driver's stall probe reads through ``dag_status``.

**Recovery (RTPU_DAG_RECOVERY).** When a stage's process dies, the driver
quiesces the survivors (``dag_pause``: every loop parks between
microbatches and reports its position, the next seq it applies and the
input edges it already consumed for it), waits for the actor's restart
(from its newest checkpoint where one is configured), and sends
``dag_rebuild``: a plan in which only the affected edges have a bumped
epoch, a fresh ring and per-reader start cursors. Parked loops swap the
affected halves of their channels in place, producers replay their
retained items, and the pipeline resumes with every microbatch delivered
once. The restarted actor gets ``dag_install`` with the recovery's
positions. The loop journals its last applied seq and a window of its
encoded outputs per stage under ``__dag__<dag_id>`` in the actor's
exactly-once journal, inside its checkpoint: a restarted stage resumes
from there and re-emits journaled outputs without running them again.

The JAX module's cross-host stream edges and its drain-migration
snapshots are left out: the port's core runs on one host.
"""
from __future__ import annotations

import glob
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .. import flags
from ..core import object_store
from ..util import procs
from . import channels
from .meter import StageBlock

CONTROL = ("dag_teardown", "dag_status", "dag_pause", "dag_positions",
           "dag_rebuild")


def install(host, plan: Dict[str, Any],
            recover: Optional[Dict[str, Any]]) -> Any:
    """Set up this actor's part of ``plan``, answer the install call, and
    run the resident loop until teardown (on the calling thread)."""
    wd = WorkerDAG(host, plan, recover)
    old = host.dags.pop(plan["dag_id"], None)
    if old is not None:
        old.cleanup()
    host.dags[plan["dag_id"]] = wd
    wd.setup()
    host.mailbox.answer(host.mailbox.seq, "ok", {"pid": os.getpid()})
    wd.run()
    return procs.ANSWERED


def status(host, dag_id: str) -> Dict[str, Any]:
    wd = host.dags.get(dag_id)
    if wd is None:
        return {"known": False}
    return wd.status()


def teardown(host, dag_id: str) -> Dict[str, Any]:
    """Teardown of a DAG whose loop is not running (it failed, or never
    started): release what it holds."""
    wd = host.dags.pop(dag_id, None)
    if wd is not None:
        wd.cleanup()
    return {"ok": True}


def resume_info(host, dag_id: str) -> Dict[int, int]:
    """The last seq this actor's DAG journal recorded for each stage (a
    restarted actor's, from its checkpoint): where the driver resumes
    it."""
    ent = host.journal.get("__dag__" + dag_id) or {}
    return {int(idx): int(rec["seq"]) for idx, rec in ent.items()}


class _Err:
    """A same-actor stage-to-stage value whose producer raised: carries
    the encoded error forward."""

    __slots__ = ("payload",)

    def __init__(self, payload: bytes):
        self.payload = payload


class _Paused(Exception):
    """A quiesce interrupted a stage: unwind to the loop's top (the
    stage's partial progress on this seq stays in its cache)."""


class _Stop(Exception):
    """Teardown: the loop leaves."""


def _sweep_ring(ring) -> None:
    """Unlink a superseded ring and the sidecars it spilled
    (``<ring>s<seq>``)."""
    for path in glob.glob(f"/dev/shm/{ring.name}s*"):
        channels._unlink_segment(os.path.basename(path))
    try:
        ring.unlink()
    except Exception:  # noqa: BLE001 — already gone
        pass


class WorkerDAG:
    """What one actor process holds of one compiled DAG."""

    def __init__(self, host, plan: Dict[str, Any],
                 recover: Optional[Dict[str, Any]]):
        self.host = host
        self.mb: procs.Mailbox = host.mailbox
        self.plan = plan
        self.dag_id = plan["dag_id"]
        self.recover = recover
        self.fail: Optional[BaseException] = None
        self.running = False
        self.stopped = False
        self._teardown_seq: Optional[int] = None
        self.progress: Dict[int, int] = {}  # stage idx -> last seq done
        self.rings: Dict[str, object_store.SlotRing] = {}  # edges I make
        self.ring_bases: Dict[str, int] = {}
        self.pause_req = False
        self.parked = False
        self.resume_gen = 0
        self._pos: Dict[int, int] = {}  # stage idx -> next seq to apply
        self._cache: Dict[int, Dict[str, Any]] = {}  # partial per-seq state
        self._affected: set = set()
        self._starts: Dict[str, Dict[str, int]] = {}
        self._retain = (int(plan["depth"]) + 2
                        if flags.get("RTPU_DAG_RECOVERY") else 0)
        self.meter = bool(flags.get("RTPU_DAG_METER"))
        self.block: Optional[StageBlock] = None
        self.io: List[list] = []
        self.stages: List[Dict[str, Any]] = []

    # -- install -------------------------------------------------------

    def _mine(self) -> List[str]:
        aid = self.host.actor_id
        return [ep for ep, info in self.plan["endpoints"].items()
                if info.get("actor_id") == aid]

    def _create_ring(self, eid: str, edge: Dict[str, Any]) -> None:
        old = self.rings.get(eid)
        if old is not None:
            _sweep_ring(old)  # a superseded epoch
        cfg = edge["ring"]
        base = int(cfg.get("base", 0))
        self.rings[eid] = object_store.SlotRing.create(
            self.plan["depth"], self.plan["slot_bytes"], cfg["n_readers"],
            name=cfg["name"], epoch=int(edge.get("epoch", 0)),
            base=base, reader_starts=cfg.get("starts"))
        self.ring_bases[eid] = base

    def setup(self) -> None:
        plan = self.plan
        mine = set(self._mine())
        if self.recover is not None:
            self._starts = dict(self.recover.get("starts") or {})
            self._affected = set(self.recover.get("affected") or ())
        for eid, edge in plan["edges"].items():
            if edge["producer"] in mine:
                self._create_ring(eid, edge)
        self.stages = sorted((st for st in plan["stages"]
                              if f"s{st['idx']}" in mine),
                             key=lambda st: st["idx"])
        resume = (self.recover or {}).get("resume") or {}
        for st in self.stages:
            self._pos[st["idx"]] = int(resume.get(st["idx"], 0))
        if self.meter and plan.get("meter"):
            self.block = StageBlock.attach(plan["meter"])

    # -- control calls -------------------------------------------------

    def status(self) -> Dict[str, Any]:
        return {"known": True, "running": self.running,
                "failed": repr(self.fail) if self.fail is not None else None,
                "progress": dict(self.progress)}

    def positions_snapshot(self) -> Dict[int, Dict[str, Any]]:
        out: Dict[int, Dict[str, Any]] = {}
        for idx, nxt in list(self._pos.items()):
            cache = self._cache.get(idx)
            have: List[str] = []
            if cache is not None and cache.get("seq") == nxt:
                have = list(cache["vals"].keys())
            out[idx] = {"next": int(nxt), "have": have}
        return out

    def _match(self, msg) -> bool:
        return msg[1] in CONTROL and msg[2] and (
            msg[2][0] == self.dag_id
            or (msg[1] == "dag_rebuild"
                and msg[2][0].get("dag_id") == self.dag_id))

    def poll(self, timeout: float = 0.0) -> None:
        """Take and answer the control calls waiting for this DAG."""
        while True:
            msg = self.mb.take(self._match, timeout)
            if msg is None:
                return
            timeout = 0.0
            seq, method, args, _ = msg
            if method == "dag_teardown":
                self.stopped = True
                self._teardown_seq = seq
                continue  # answered once the loop has released its rings
            if method == "dag_status":
                value = self.status()
            elif method == "dag_pause":
                self.pause_req = True
                value = {"known": True}
            elif method == "dag_positions":
                value = {"known": True, "parked": self.parked,
                         "positions": self.positions_snapshot(),
                         "failed": (repr(self.fail) if self.fail is not None
                                    else None)}
            else:
                self.apply_rebuild(*args)
                value = {"ok": True}
            self.mb.answer(seq, "ok", value)

    def _stop_requested(self) -> bool:
        if not self.stopped:
            self.poll()
        return self.stopped or self.mb.leaving

    def apply_rebuild(self, plan, starts, resume, affected) -> None:
        """Adopt the driver's plan after a recovery: fresh rings for the
        affected edges this actor produces; the parked loop swaps its
        affected channels and replays on resuming."""
        self.plan = plan
        self._starts = {eid: dict(d) for eid, d in (starts or {}).items()}
        self._affected = set(affected)
        mine = set(self._mine())
        for eid in self._affected:
            edge = plan["edges"].get(eid)
            if edge and edge["producer"] in mine:
                self._create_ring(eid, edge)
        self.resume_gen += 1
        self.pause_req = False

    # -- the resident loop ---------------------------------------------

    def _make_reader(self, stage, eid: str):
        edge = self.plan["edges"][eid]
        return channels.ShmEdgeReader(
            edge["ring"]["name"], edge["ring_idx"][f"s{stage['idx']}"],
            expect_epoch=int(edge.get("epoch", 0)))

    def _build_stage_io(self, stage) -> list:
        """Readers for each channel edge the stage consumes and the writer
        of the edge it produces (None where only same-actor stages consume
        it), as a mutable [readers, writer] pair, so a rebuild can swap
        the affected halves in place."""
        readers: Dict[str, Any] = {}
        for b in list(stage["args"]) + list(stage["kwargs"].values()):
            if b[0] != "chan" or b[1] in readers:
                continue
            readers[b[1]] = self._make_reader(stage, b[1])
        return [readers, self._build_stage_writer(stage)]

    def _build_stage_writer(self, stage):
        eid = stage.get("out_edge")
        if eid is None:
            return None
        return channels.ShmEdgeWriter(self.rings[eid], retain=self._retain)

    def _journal(self) -> Dict[int, Dict[str, Any]]:
        return self.host.journal.setdefault("__dag__" + self.dag_id, {})

    def _journal_apply(self, idx: int, seq: int, kind: int,
                       payload: bytes) -> None:
        """Record one applied stage output in the actor's exactly-once
        journal, before the edge write, so an output a crash or a pause
        interrupted mid-write can be replayed from the journal."""
        if self._retain == 0:
            return
        ent = self._journal().get(idx)
        if ent is None:
            ent = self._journal()[idx] = {
                "seq": -1, "outs": deque(maxlen=self._retain)}
        ent["outs"].append((seq, kind, payload))
        ent["seq"] = seq

    def _seed_writer(self, stage, writer) -> None:
        """A restart: refill a fresh writer's retained window from the
        journaled outputs of the previous incarnation's checkpoint."""
        if writer is None or writer.retained is None or writer.retained:
            return
        ent = self._journal().get(stage["idx"])
        writer.retained.extend(list(ent["outs"]) if ent else [])

    def _maybe_checkpoint(self) -> None:
        """The checkpoint cadence of an actor whose thread this loop
        holds: checkpoints run here, between microbatches."""
        host = self.host
        if host.ckpt_enabled:
            host.calls_since_ckpt += 1
            host.maybe_checkpoint()

    def run(self) -> None:
        """The loop, on the actor's call thread, until teardown."""
        stages, io = self.stages, self.io
        self.running = True
        try:
            try:
                for stage in stages:
                    io.append(self._build_stage_io(stage))
            except Exception as e:  # noqa: BLE001 — reported by status
                self.fail = self.fail or e
                return
            nexts = {st["idx"]: int(self._pos.get(st["idx"], 0))
                     for st in stages}
            if self.recover is not None:
                self._replay_writers(set(self.recover.get("affected")
                                         or ()))
            local_vals: Dict[int, Any] = {}
            seq = min(nexts.values()) if nexts else 0
            while True:
                if self._stop_requested():
                    raise _Stop()
                if self.pause_req:
                    self._park()
                    continue
                try:
                    for stage, sio in zip(stages, io):
                        idx = stage["idx"]
                        if seq < nexts[idx]:
                            self._skip_stage(stage, seq, local_vals)
                            continue
                        self._run_stage(stage, sio, seq, local_vals)
                        nexts[idx] = self._pos[idx] = seq + 1
                        self.progress[idx] = seq
                    self._maybe_checkpoint()
                except _Paused:
                    continue
                seq += 1
        except (_Stop, channels.ChannelClosed):
            pass  # teardown, or an upstream closed first
        except BaseException as e:  # noqa: BLE001 — reported by status
            self.fail = self.fail or e
        finally:
            self.running = False
            if self.stopped or self.mb.leaving:
                self.host.dags.pop(self.dag_id, None)
                self.cleanup()
                if self._teardown_seq is not None:
                    self.mb.answer(self._teardown_seq, "ok", {"ok": True})

    def _park(self) -> None:
        """The quiesce barrier: report parked, wait for the driver's
        rebuild (or teardown), then swap the affected channels in place
        and replay the retained items."""
        gen = self.resume_gen
        self.parked = True
        try:
            while self.resume_gen == gen:
                self.poll(timeout=0.1)
                if self.stopped or self.mb.leaving:
                    raise _Stop()
        finally:
            self.parked = False
        affected = set(self._affected)
        for stage, sio in zip(self.stages, self.io):
            readers = sio[0]
            for eid in list(readers.keys()):
                if eid not in affected:
                    continue
                old = readers.pop(eid)
                try:
                    old.close()
                except Exception:  # noqa: BLE001 — already gone
                    pass
                # A value consumed before the pause stays valid: the
                # positions reported it, so upstream replays after it.
                readers[eid] = self._make_reader(stage, eid)
            eid = stage.get("out_edge")
            if eid is not None and eid in affected and sio[1] is not None:
                old_writer = sio[1]
                retained = old_writer.retained
                try:
                    old_writer.close()  # unlinks the superseded ring
                except Exception:  # noqa: BLE001 — already gone
                    pass
                new_writer = self._build_stage_writer(stage)
                if retained and new_writer.retained is not None:
                    new_writer.retained.extend(retained)
                sio[1] = new_writer
        self._replay_writers(affected)

    def _replay_writers(self, affected) -> None:
        """Deliver again the retained items of every affected edge this
        actor produces: the rebuilt ring takes everything from its base
        up."""
        for stage, sio in zip(self.stages, self.io):
            eid = stage.get("out_edge")
            writer = sio[1]
            if writer is None or eid is None or eid not in affected:
                continue
            self._seed_writer(stage, writer)
            writer.replay(self.ring_bases.get(eid),
                          stop=self._stop_requested)

    def _skip_stage(self, stage, seq, local_vals) -> None:
        """This stage applied ``seq`` in a previous incarnation: expose its
        journaled output to same-actor consumers without running it
        again."""
        ent = self._journal().get(stage["idx"])
        for s, kind, payload in (ent["outs"] if ent else ()):
            if s == seq:
                local_vals[stage["idx"]] = (
                    _Err(payload) if kind == channels.KIND_ERROR
                    else channels.decode(payload))
                return

    def _recv_input(self, reader, eid: str, seq: int
                    ) -> Tuple[int, int, bytes]:
        """A blocking receive that notices a quiesce and drops replayed
        duplicates (a seq below the one this stage needs): re-delivery is
        at least once on the channel, exactly once at the consumer."""
        while True:
            item = reader.recv(0.1, stop=self._stop_requested)
            if item is None:
                if self._stop_requested():
                    raise _Stop()
                if self.pause_req:
                    raise _Paused()
                continue
            got_seq = item[0]
            if got_seq < seq:
                continue
            if got_seq > seq:
                raise RuntimeError(
                    f"dag {self.dag_id[:8]} edge {eid}: expected seq "
                    f"{seq}, got {got_seq} (torn channel)")
            return item

    def _run_stage(self, stage, sio, seq, local_vals) -> None:
        idx = stage["idx"]
        readers, writer = sio[0], sio[1]
        # The meter's phases: recv (waiting for the inputs and copying
        # them out of their rings), compute (decoding them, a CUDA
        # tensor's copy to the card included, and the method) and send
        # (encoding the output, its copy to the host included, and
        # writing it), the ring's backpressure inside the write taken out
        # of send (it is the consumer's cost); decode and encode are also
        # kept apart.
        mt = self.block is not None
        t0 = time.monotonic_ns() if mt else 0
        t1 = td = tm = t2 = t0
        cache = self._cache.get(idx)
        if cache is None or cache.get("seq") != seq:
            cache = self._cache[idx] = {"seq": seq, "vals": {}, "out": None}
        if cache["out"] is None:
            for eid, reader in readers.items():
                if eid in cache["vals"]:
                    continue  # consumed before a pause interrupted us
                _, kind, payload = self._recv_input(reader, eid, seq)
                cache["vals"][eid] = (kind, payload)
            if mt:
                t1 = time.monotonic_ns()
            err_payload: Optional[bytes] = None
            chan_vals: Dict[str, Any] = {}
            for eid in readers:
                kind, payload = cache["vals"][eid]
                if kind == channels.KIND_ERROR:
                    if err_payload is None:
                        err_payload = payload
                else:
                    chan_vals[eid] = channels.decode(payload)
            if mt:
                td = time.monotonic_ns()

            def resolve(b):
                nonlocal err_payload
                if b[0] == "const":
                    return b[1]
                if b[0] == "local":
                    v = local_vals.get(b[1])
                    if isinstance(v, _Err):
                        err_payload = err_payload or v.payload
                        return None
                    return v
                if b[1] not in chan_vals:
                    return None  # an upstream error took this value
                v = chan_vals[b[1]]
                if b[2] is not None:
                    return channels.apply_selector(v, b[2])
                return v

            args = [resolve(b) for b in stage["args"]]
            kwargs = {k: resolve(b) for k, b in stage["kwargs"].items()}
            if err_payload is not None:
                out_kind, out_payload = channels.KIND_ERROR, err_payload
                local_vals[idx] = _Err(err_payload)
            else:
                try:
                    result = getattr(self.host.instance, stage["method"])(
                        *args, **kwargs)
                    if mt:
                        tm = time.monotonic_ns()
                    out_kind = channels.KIND_DATA
                    out_payload = channels.encode_value(result)
                    local_vals[idx] = result
                except Exception as e:  # noqa: BLE001 — a value
                    out_kind = channels.KIND_ERROR
                    out_payload = channels.encode_error(e)
                    local_vals[idx] = _Err(out_payload)
            cache["out"] = (out_kind, out_payload)
            self._journal_apply(idx, seq, out_kind, out_payload)
        if mt:
            t2 = time.monotonic_ns()
        blocked = 0
        if writer is not None:
            out_kind, out_payload = cache["out"]
            try:
                blocked = writer.write(
                    seq, out_kind, out_payload,
                    stop=lambda: self._stop_requested() or self.pause_req)
            except channels.ChannelClosed:
                if self.pause_req and not self.stopped:
                    # Applied and journaled: the replay after the rebuild
                    # (or a retry, which the retained window dedups)
                    # delivers it.
                    raise _Paused()
                raise
        self._cache.pop(idx, None)
        if mt:
            t3 = time.monotonic_ns()
            tm = max(tm, td)  # the method did not run (an upstream error)
            self.block.add(idx, recv=max(0, t1 - t0),
                           compute=max(0, tm - t1),
                           send=max(0, t3 - tm - blocked), blocked=blocked,
                           decode=max(0, td - t1), encode=max(0, t2 - tm))

    # -- teardown ------------------------------------------------------

    def cleanup(self) -> None:
        """Release every channel this DAG holds here: readers closed,
        rings (and their sidecars) unlinked, the meter block unmapped."""
        for sio in self.io:
            readers, writer = sio[0], sio[1]
            for r in readers.values():
                try:
                    r.close()
                except Exception:  # noqa: BLE001 — already gone
                    pass
            if writer is not None:
                try:
                    writer.close()  # marks closed and unlinks the ring
                except Exception:  # noqa: BLE001 — already gone
                    pass
        self.io = []
        for ring in self.rings.values():
            _sweep_ring(ring)
        self.rings.clear()
        if self.block is not None:
            self.block.close()
            self.block = None
