"""Registry of the ``RTPU_*`` environment flags the PyTorch port reads.

The same contract as the JAX package's flag registry: every flag is defined
once with its type, default and documentation, and read through :func:`get`
at call time (environment over default), so a flag set by a test or a
parent process is honoured. Only the flags the port's modules read are
defined here; the port keeps its own copy and imports nothing of the JAX
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterator, Mapping


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    type: type
    default: Any
    doc: str


REGISTRY: Dict[str, Flag] = {}


def _define(name: str, type_: type, default: Any, doc: str) -> None:
    REGISTRY[name] = Flag(name, type_, default, doc)


_define("RTPU_ATTN_IMPL", str, "auto",
        "Attention implementation: auto (the hand-written flash kernel for "
        "CUDA tensors, the plain reference attention on the CPU) | flash "
        "(flash_attention: the kernel on CUDA, its plain version on the "
        "CPU) | xla (the plain reference attention everywhere; the name is "
        "kept from the JAX package).")
_define("RTPU_SP_MODE", str, "ring",
        "Context-parallel attention scheme over the seq mesh axis: "
        "ring | ulysses | auto (ulysses when head counts divide the axis).")

_define("RTPU_DATA_FT", bool, True,
        "Fault-tolerant data pool: a map_batches pool worker that dies "
        "is replaced on the same card and its in-flight blocks are sent "
        "to the replacement (bounded by RTPU_DATA_FT_RETRIES). 0 makes "
        "the stage raise PoolWorkerDiedError at the death.")
_define("RTPU_DATA_FT_RETRIES", int, 3,
        "Per-block retry budget of a self-healing pool stage: how many "
        "times one input block may be resent after its pool worker died "
        "before the stage raises.")
_define("RTPU_DATA_PROGRESS", bool, False,
        "Per-operator progress lines from the streaming data executor "
        "(one stderr line per operator every RTPU_DATA_PROGRESS_S while "
        "a stage runs, reference: Ray Data's ProgressBar rows). Off by "
        "default: interactive use only.")
_define("RTPU_DATA_PROGRESS_S", float, 5.0,
        "Seconds between data-executor progress lines when "
        "RTPU_DATA_PROGRESS is on.")
_define("RTPU_WORKFLOW_STORAGE", str, None,
        "Workflow durability root (default ~/.ray_tpu_torch/workflows: "
        "the port's own, not the JAX package's ~/.ray_tpu/workflows, "
        "whose stored runs it could not load).")
_define("RTPU_CHECKPOINT_DIR", str, None,
        "Directory for host-local checkpoint files: the data layer's "
        "ingest cursors and streaming-split handout journals, and the "
        "core's actor checkpoints (default: rtpu_checkpoints under the "
        "system temp root). Shared by every process on the host, so a "
        "restarted driver, consumer or actor resumes from the records its "
        "predecessor wrote.")

# -- actor checkpoints / exactly-once replay ---------------------------------
_define("RTPU_ACTOR_CHECKPOINT", bool, True,
        "Durable actor checkpoints: actors created with "
        "checkpoint_interval_s / checkpoint_every_n write their instance "
        "and their exactly-once call journal to the host-local record "
        "store, so a crash restart restores the newest checkpoint instead "
        "of running the constructor again. 0 turns the subsystem off: a "
        "restart runs the constructor.")
_define("RTPU_CHECKPOINT_TICK_S", float, 0.25,
        "How often an idle actor process with checkpoint_interval_s looks "
        "whether a checkpoint is due (a busy one looks after each call).")

# -- compiled DAG channels ---------------------------------------------------
_define("RTPU_DAG_CHANNELS", bool, True,
        "Compiled DAGs execute over reusable mutable channels: one shm "
        "slot ring per DAG edge and a resident loop on each actor process, "
        "so a steady-state execute() is a slot write and at most one "
        "doorbell. 0 falls back to one actor call per stage and execute() "
        "through the normal submit path.")
_define("RTPU_DAG_SLOT_BYTES", int, 128 * 1024,
        "Payload capacity of one shm channel slot. A value that pickles "
        "larger goes through a one-off sidecar shm segment named in the "
        "slot; size it to the common payload so the sidecar stays cold.")
_define("RTPU_DAG_SPIN_US", int, 200,
        "How long a channel reader or writer spins on the ring header "
        "before it arms its doorbell and blocks; 0 blocks at once (right "
        "for a host with fewer cores than processes).")
_define("RTPU_DAG_STALL_S", float, 2.0,
        "How long a compiled DAG's driver tolerates no progress with work "
        "outstanding before it probes its participants (their processes "
        "and resident loops). A slow stage that is alive is waited for; a "
        "dead one is recovered or, without recovery, tears the DAG down "
        "with DAGTeardownError.")
_define("RTPU_DAG_RECOVERY", bool, True,
        "Compiled DAGs heal in place: when the stall probe finds a dead "
        "stage process with restarts left, the driver quiesces the "
        "survivors, waits for the actor's restart (from its newest "
        "checkpoint where one is configured), rebuilds only the affected "
        "edges under a bumped ring epoch and replays the retained items "
        "from what each reader last applied, so every microbatch is "
        "delivered once. A stage with no restarts left still raises "
        "DAGTeardownError; 0 tears the DAG down at any death.")
_define("RTPU_DAG_RECOVERY_TIMEOUT_S", float, 60.0,
        "How long a recovering DAG waits for a dead stage's actor to come "
        "back before it tears down with DAGTeardownError.")
_define("RTPU_DAG_METER", bool, True,
        "Channel meter: every slot ring carries writer and reader counter "
        "lines (items, bytes, blocked and starved ns) and every resident "
        "stage accounts its recv, compute and send time in a shared block, "
        "which the driver samples into rtpu_dag_edge_* / rtpu_dag_stage_* "
        "metrics and the list_compiled_dags() row (busy fractions, the "
        "bottleneck). 0 removes the counters and clock reads from the hot "
        "path.")


# -- serve: deadlines, admission control, circuit breaking -------------------
_define("RTPU_SERVE_ADMISSION", bool, True,
        "Overload protection in the serve router: bounded per-deployment "
        "queues (shed with BackPressureError), per-replica circuit "
        "breakers the power-of-two picker skips, and a retry budget "
        "capped as a fraction of admitted traffic. 0 restores the "
        "unbounded-queue router; the router then reads the flag once "
        "per request.")
_define("RTPU_SERVE_MAX_QUEUED", int, 100,
        "Default per-deployment queued-request bound (queued = accepted "
        "by routers beyond the replicas' max_ongoing_requests capacity) "
        "when the deployment does not set max_queued_requests. -1 means "
        "unbounded.")
_define("RTPU_SERVE_REQUEST_TIMEOUT_S", float, 60.0,
        "Default end-to-end deadline for serve requests that do not carry "
        "an explicit one (HTTP X-Request-Timeout-S header, gRPC envelope "
        "timeout_s, or handle .options(deadline_s=...)). Expired work is "
        "dropped with DeadlineExceededError at every queue boundary "
        "instead of executing. <=0 means no default deadline.")
_define("RTPU_SERVE_READY_TIMEOUT_S", float, 60.0,
        "How long serve.run() waits for a deployment's replicas to become "
        "ready before raising.")
_define("RTPU_SERVE_BREAKER_THRESHOLD", int, 5,
        "Consecutive failures/timeouts on one replica before its circuit "
        "breaker opens and the router routes around it.")
_define("RTPU_SERVE_BREAKER_COOLDOWN_S", float, 5.0,
        "How long an open replica breaker waits before letting one "
        "half-open probe request through.")
_define("RTPU_SERVE_RETRY_BUDGET", float, 0.2,
        "Retry budget as a fraction of admitted traffic: each admitted "
        "request earns this many retry tokens (bucket capped at 10x), "
        "each retry spends one. Prevents retry amplification during an "
        "outage.")

# -- serve: disaggregated LLM plane (prefill/decode pools, prefix cache) -----
_define("RTPU_SERVE_DISAGG", bool, True,
        "Disaggregated LLM serving: build_disagg_llm_deployment splits "
        "prefill and decode into separate replica pools with a K/V "
        "handoff between them (a file). 0 collapses the builder to the "
        "unified continuous-batching deployment (identical request/"
        "response behavior, one pool).")
_define("RTPU_SERVE_DISAGG_RETRIES", int, 3,
        "How many times the disagg ingress re-dispatches a token stream "
        "to another decode replica after a mid-stream replica failure "
        "before surfacing the error to the client.")
_define("RTPU_PREFIX_CACHE", bool, True,
        "Decode-replica prefix cache: prefilled K/V keyed by token-prefix "
        "hash stays resident (LRU by KV bytes), so repeated prompts skip "
        "prefill entirely. 0 disables lookup, insert, and the "
        "controller-side cluster index.")
_define("RTPU_PREFIX_CACHE_MAX_MB", float, 256.0,
        "Per-replica prefix-cache budget in MiB of cached K/V (+logits) "
        "bytes; least-recently-used entries evict past it.")
_define("RTPU_PREFIX_CACHE_PROMOTE_HITS", int, 3,
        "Cluster-index promotion threshold: once a prefix accumulates "
        "this many cluster-wide hits, the serve controller has the "
        "replicas that don't hold it yet pull it from a holder. <=0 "
        "disables promotion.")

# -- serve: scaling ----------------------------------------------------------
_define("RTPU_SERVE_AUTOSCALE", bool, True,
        "Signal-driven serve autoscaler: pool replica counts follow slot "
        "occupancy and queue depth through the alert engine's "
        "threshold+for-duration machinery for deployments that set a "
        "scaling_policy. 0 freezes pools at their deployed size (the "
        "queue-length autoscaling_config path is unaffected).")
_define("RTPU_SERVE_DRAIN_DEADLINE_S", float, 30.0,
        "Scale-down grace: a draining replica stops receiving new "
        "requests at once (routers drop it at their next refresh) but is "
        "only stopped once idle or after this many seconds, so in-flight "
        "streams finish across a resize.")
_define("RTPU_SERVE_SCALE_COOLDOWN_S", float, 5.0,
        "Minimum seconds between two autoscaler actions on the same "
        "deployment, bounding resize churn.")


# -- observability: the metrics, event, tracing and serve trace planes -------
_define("RTPU_METRICS_FLUSH_S", float, 1.0,
        "Flush period for app metrics (util/metrics.py) to the sink: the "
        "serve controller's where the process has its address, else the "
        "process's own.")
_define("RTPU_TASK_EVENTS_FLUSH_S", float, 0.5,
        "Flush period of a process's shipper (core/sink.py: serve "
        "spans and ledger records, events, tracing spans).")
_define("RTPU_EVENTS", bool, True,
        "Cluster event subsystem (core/events.py): structured events "
        "(STREAM_STALLED, ...) in a bounded ring of the sink. 0 disables; "
        "emit sites then pay one flag check.")
_define("RTPU_TRACING", bool, False,
        "Span recording of util/tracing.py (set by setup_tracing; "
        "processes started afterwards inherit it through the "
        "environment).")
_define("RTPU_SERVE_TRACE", bool, True,
        "Per-request serving trace plane: every hop (proxy, router "
        "assign, replica, batch seal, engine slot wait, prefill, KV "
        "handoff, token stream) emits a span on its process's monotonic "
        "clock, finished requests ship to the serve controller's request "
        "ledger (util.state.list_serve_requests / serve_trace), and the "
        "engine records per-token timelines into rtpu_serve_itl_s. 0 "
        "reduces the whole plane to one flag check per hop.")
_define("RTPU_SERVE_STALL_S", float, 30.0,
        "Stream-stall detector threshold: a live generation slot that "
        "emits no token for this many seconds raises one STREAM_STALLED "
        "event (per request) with the replica's all-thread stack capture "
        "attached. <=0 disables the detector.")
_define("RTPU_SERVE_LEDGER_MAX", int, 2048,
        "Request-ledger capacity (finished serve request records with "
        "their spans). Past it, LRU rows evict, except SLO-miss / shed / "
        "deadline-exceeded rows, which are only reclaimed once every "
        "unflagged row is gone.")
_define("RTPU_SERVE_SLO_MS", float, 0.0,
        "Serving latency SLO in milliseconds: finished requests slower "
        "than this count into rtpu_serve_slo_miss_total and are retained "
        "ahead of LRU eviction in the request ledger. <=0 means no "
        "latency SLO (shed / deadline-exceeded outcomes still count as "
        "misses).")


def get(name: str) -> Any:
    """Read a registered flag from the environment (call-time), else its
    registered default."""
    f = REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return f.default
    if f.type is bool:
        return raw.strip().lower() not in ("0", "", "false", "no")
    if f.type in (int, float):
        return f.type(raw)
    return raw


@contextlib.contextmanager
def scoped(env: Mapping[str, str]) -> Iterator[None]:
    """Set environment flags (``{"RTPU_SP_MODE": "ulysses"}``) for a
    block, restoring their earlier values (or absence) after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
