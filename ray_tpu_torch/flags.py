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
        "prefill entirely. 0 disables lookup and insert.")
_define("RTPU_PREFIX_CACHE_MAX_MB", float, 256.0,
        "Per-replica prefix-cache budget in MiB of cached K/V (+logits) "
        "bytes; least-recently-used entries evict past it.")


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
