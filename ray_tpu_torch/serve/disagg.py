"""Disaggregated LLM serving: prefill and decode as separate pools
(counterpart of the JAX package's ``serve/disagg.py``).

The continuous-batching engine couples two different workloads on one
replica: prefill (compute-bound, O(prompt) FLOPs, bursty) and decode
(memory-bound, steady per token). Splitting them lets each pool scale on
its own and keeps long prefills from stealing decode ticks.

Data path per request (ingress -> decode -> prefill):

1. The ingress hashes the prompt (``prefix_cache.prefix_key``) and
   dispatches the stream to a DECODE replica with rendezvous affinity on
   that hash, so a repeated prompt lands where its K/V already lives.
2. Prefix-cache HIT: the decode replica splices the resident K/V into a
   free slot (``engine.attach_prefilled``): no prefill anywhere.
3. MISS: the decode replica calls its prefill-pool handle. The prefill
   replica runs the engine's bucketed prefill and returns the K/V blob
   as its result; the blob (128 KiB a token for Llama-3-8B) travels as a
   file the decode replica reads back (``procs.Spilled``), straight
   between the two replica processes. It lands in the prefix cache, then
   splices into a slot.
4. The ingress relays tokens, counting what it has delivered. If the
   decode replica dies mid-stream it re-dispatches to another replica
   (router refresh, the same affinity hash minus the dead replica) and
   SKIPS the tokens already sent: greedy decoding replays exactly, so
   the client sees no duplicate and no lost token. A sampled stream
   (temperature > 0) that already delivered tokens surfaces the failure
   instead of stitching two generations together.

Prefix hashes are derived server-side from the tokens, always: a client
``prefix_hash`` is dropped (it would let one request read or poison
another prompt's cached K/V).

``RTPU_SERVE_DISAGG=0`` collapses the builder to the unified
continuous-batching deployment with the identical request/response
contract.

The pools' replicas take one card each with ``num_gpus`` (default 1):
the prefill pool's first, then the decode pool's; the ingress runs on
the CPU and never starts CUDA.

The trace plane (``serve/trace.py``): the ingress opens one
``serve.decode_attempt`` hop an attempt (so a decode replica that dies
with its unshipped spans still leaves every attempt in the ledger row);
the decode replica's ``serve.stream`` covers obtaining the prefill, the
splice and the tokens, with ``serve.kv_handoff`` (the prefill pool's call
and the file's read, bytes attached) or a local ``serve.prefill`` under
it; the prefill replica's own ``serve.prefill`` lands in the same trace.
Handed-off bytes and re-dispatched streams are counted
(``rtpu_serve_handoff_bytes_total``, ``rtpu_serve_reroutes_total``).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import flags
from ..device import resolve_device
from . import context as serve_context
from . import trace
from .admission import BackPressureError
from .controller import check_cards, replica_cards
from .deployment import Application, deployment
from .llm import (build_streaming_llm_deployment, device_ctx, device_for,
                  load_params, parse_request, replica_seed,
                  stream_engine)
from .prefix_cache import PrefixCache, prefix_key

logger = logging.getLogger(__name__)

_disagg_metrics_cache = None


def _disagg_metrics():
    global _disagg_metrics_cache
    if _disagg_metrics_cache is None:
        from ..util.metrics import Counter

        _disagg_metrics_cache = {
            "handoff": Counter(
                "rtpu_serve_handoff_bytes_total",
                description="K/V bytes handed off prefill->decode (the "
                            "handoff file between the two replicas)",
                tag_keys=("model",)),
            "reroutes": Counter(
                "rtpu_serve_reroutes_total",
                description="Token streams re-dispatched to another "
                            "decode replica after a mid-stream replica "
                            "failure",
                tag_keys=("model",)),
        }
    return _disagg_metrics_cache


def _blob_bytes(blob: Dict[str, Any]) -> int:
    return sum(t.numel() * t.element_size()
               for t in (blob["k"], blob["v"], blob["logits"]))


class PrefillWorker:
    """Length-bucketed prefill; returns the handoff blob as its call
    result (a file, read back by the decode replica)."""

    def __init__(self, cfg, params_factory, *, max_prompt_len: int,
                 quantize_int8: bool = False, device=None,
                 name: str = "llm"):
        self.cfg = cfg
        self.name = name
        self.device = resolve_device(device)
        self.max_prompt_len = max_prompt_len
        self._params = load_params(params_factory, self.device, quantize_int8)
        self._lock = threading.Lock()
        self._inflight = 0

    @torch.no_grad()
    def prefill(self, tokens) -> Dict[str, Any]:
        """The engine's prefill of one prompt (``ContinuousBatchingEngine.
        prefill_only``'s work): k/v [L, S, KVH, hd] for the length bucket
        S, the true length and the last position's logits [V], as CPU
        tensors."""
        from ..models.generate import prefill
        from .llm_engine import bucket_len

        with self._lock:
            self._inflight += 1
        # The prefill on THIS replica's clock: the nested handle call
        # carried the trace over, so it lands in the decode side's
        # waterfall.
        hop = trace.start_hop("serve.prefill", kind="prefill",
                              attributes={"model": self.name})
        try:
            ids = np.asarray(tokens, np.int64)
            if ids.ndim != 1 or ids.size == 0:
                raise ValueError("tokens must be a non-empty 1-D integer "
                                 "list")
            ids = ids[-self.max_prompt_len:]
            S = bucket_len(len(ids), self.max_prompt_len)
            padded = np.zeros((1, S), np.int64)
            padded[0, :len(ids)] = ids
            with device_ctx(self.device):
                logits, cache = prefill(
                    self._params, torch.from_numpy(padded).to(self.device),
                    self.cfg, S,
                    lengths=torch.tensor([len(ids)], device=self.device))
                out = {"k": cache.k[:, 0].cpu(), "v": cache.v[:, 0].cpu(),
                       "length": len(ids), "logits": logits[0].cpu()}
            if hop is not None:
                hop.attributes.update(prompt_len=len(ids), bucket=S)
            return out
        except BaseException as e:
            if hop is not None:
                hop.end(error=type(e).__name__)
                hop = None
            raise
        finally:
            if hop is not None:
                hop.end()
            with self._lock:
                self._inflight -= 1

    def __call__(self, tokens) -> Dict[str, Any]:
        return self.prefill(tokens)

    def serve_stats(self) -> Dict[str, float]:
        n = self._inflight
        return {"queued": float(max(0, n - 1)),
                "slots_busy": float(min(n, 1)),
                "slots_total": 1.0,
                "occupancy": float(min(n, 1))}


class DecodeWorker:
    """Continuous-batching decode replica with a resident prefix cache;
    prefill comes from the cache, the prefill pool, or (last resort)
    locally."""

    def __init__(self, cfg, params_factory, prefill_handle=None, *,
                 name: str = "llm", num_slots: int = 4,
                 max_prompt_len: int = 256, max_new_tokens: int = 64,
                 quantize_int8: bool = False,
                 prefix_cache_mb: Optional[float] = None, device=None):
        from .llm_engine import ContinuousBatchingEngine

        self.device = resolve_device(device)
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.name = name
        self._mtags = {"model": name}
        params = load_params(params_factory, self.device, quantize_int8)
        self._engine = ContinuousBatchingEngine(
            cfg, params, num_slots=num_slots, max_prompt_len=max_prompt_len,
            max_new_tokens=max_new_tokens,
            seed=replica_seed(),
            model=name, device=self.device)
        self._prefill_pool = prefill_handle
        mb = prefix_cache_mb
        self._cache = PrefixCache(
            max_bytes=None if mb is None else int(mb * 2**20), model=name)
        # The K/V handoffs from the prefill pool: count, file bytes, the
        # call's seconds (prefill and file) and the file's read seconds.
        self.handoff = {"n": 0, "bytes": 0, "call_s": 0.0, "read_s": 0.0}
        self._handoff_lock = threading.Lock()
        self.cancels = []
        self._stop = threading.Event()
        self._ticker = threading.Thread(
            target=self._engine.run_forever, args=(self._stop,),
            daemon=True, name="engine-ticker")
        self._ticker.start()

    # ---------------------------------------------------------- the stream

    def _obtain_prefill(self, h: str, ids: np.ndarray,
                        timeout: Optional[float]):
        """(k, v, length, logits) for this prompt: cache hit -> resident
        blob; miss -> prefill pool (the handoff file); pool failure ->
        local prefill."""
        e = self._cache.get(h)
        if e is not None:
            return e.k, e.v, e.length, e.logits
        blob = None
        if self._prefill_pool is not None:
            # The handoff's span: the prefill pool's call and the file's
            # read; its dwell IS the transfer time, bytes attached.
            hop = trace.start_hop("serve.kv_handoff", kind="handoff",
                                  attributes={"model": self.name})
            try:
                t0 = time.perf_counter()
                resp = self._prefill_pool.prefill.remote(
                    [int(x) for x in ids])
                blob = resp.result(timeout=timeout)
                nbytes = _blob_bytes(blob)
                _disagg_metrics()["handoff"].inc(float(nbytes),
                                                 tags=self._mtags)
                with self._handoff_lock:
                    self.handoff["n"] += 1
                    self.handoff["bytes"] += resp.file_bytes
                    self.handoff["call_s"] += time.perf_counter() - t0
                    self.handoff["read_s"] += resp.file_load_s
                if hop is not None:
                    hop.end(bytes=nbytes)
            except (BackPressureError,
                    serve_context.DeadlineExceededError) as exc:
                if hop is not None:
                    hop.end(error=type(exc).__name__)
                raise
            except Exception as exc:  # noqa: BLE001 — fall back locally
                if hop is not None:
                    hop.end(error=type(exc).__name__)
                logger.warning("prefill pool unavailable (%s); falling "
                               "back to local prefill", exc)
                blob = None
        if blob is None:
            hop = trace.start_hop("serve.prefill", kind="prefill",
                                  attributes={"model": self.name,
                                              "local": True})
            try:
                k, v, length, logits = self._engine.prefill_only(ids)
            except BaseException as exc:
                if hop is not None:
                    hop.end(error=type(exc).__name__)
                raise
            if hop is not None:
                hop.end()
            blob = {"k": k, "v": v, "length": length, "logits": logits}
        self._cache.put(h, blob["k"], blob["v"], blob["length"],
                        blob["logits"])
        return blob["k"], blob["v"], blob["length"], blob["logits"]

    def __call__(self, request: Dict[str, Any]):
        try:
            ids, n, temp, eos = parse_request(request, self.max_new_tokens)
        except Exception as e:
            yield {"error": f"bad request: {e}"}
            return
        ids = ids[-self.max_prompt_len:]
        # Always derived from the tokens, never read from the request.
        h = prefix_key(ids)
        timeout = serve_context.remaining_s(default=300.0)

        def attach():
            k, v, length, logits = self._obtain_prefill(h, ids, timeout)
            return self._engine.attach_prefilled(
                k, v, length, logits, max_new_tokens=n, temperature=temp,
                eos_id=eos, timeout=timeout,
                queue_wait_s=serve_context.elapsed_s())

        yield from stream_engine(
            self._engine, self.cancels, ids, n, temp, eos, attach=attach,
            hop_attributes={"prefix_hit": h in self._cache})

    # -------------------------------------------------------- prefix plane

    def has_prefix(self, h: str) -> bool:
        return h in self._cache

    def export_prefix(self, h: str) -> Optional[Dict[str, Any]]:
        return self._cache.export(h)

    def pull_prefix(self, h: str, holder) -> bool:
        """Fetch a blob straight from the holder replica (a
        ``ReplicaClient``): the bytes go holder -> here as a file."""
        if not self._cache.enabled or h in self._cache:
            return True
        try:
            blob = holder.handle_request("export_prefix", (h,), {},
                                         timeout=30.0)
        except Exception:  # noqa: BLE001 — the holder is gone
            return False
        if not blob:
            return False
        return self._cache.insert_blob(h, blob)

    def cache_stats(self) -> Dict[str, Any]:
        return self._cache.stats()

    def pid(self) -> int:
        return os.getpid()

    def serve_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = self._engine.stats()
        out["ticks"] = self._engine.ticks
        out["prefix"] = self._cache.stats()
        with self._handoff_lock:
            out["handoff"] = dict(self.handoff)
        out["cancels"] = list(self.cancels)
        return out

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()


class DisaggIngress:
    """Routes streams to the decode pool with prefix affinity and replays
    across decode-replica death without duplicating or losing tokens
    (exact replay needs greedy decoding; a sampled stream that already
    delivered tokens fails over to an error)."""

    def __init__(self, decode_handle, *, name: str = "llm",
                 max_prompt_len: int = 256):
        self._decode = decode_handle
        self.name = name
        self._mtags = {"model": name}
        self.max_prompt_len = max_prompt_len
        self.reroutes = 0

    def __call__(self, request: Dict[str, Any]):
        if not isinstance(request, dict) or "tokens" not in request:
            yield {"error": "expected {'tokens': [...]} request body"}
            return
        try:
            ids = np.asarray(request["tokens"],
                             np.int64)[-self.max_prompt_len:]
            # Server-derived affinity/cache key; any client-supplied
            # prefix_hash is dropped.
            h = prefix_key(ids)
            greedy = float(request.get("temperature", 0.0) or 0.0) <= 0.0
        except Exception as e:
            yield {"error": f"bad request: {e}"}
            return
        request = dict(request)
        request.pop("prefix_hash", None)
        retries = int(flags.get("RTPU_SERVE_DISAGG_RETRIES"))
        sent = 0
        attempt = 0
        while True:
            stream = None
            # One span an attempt, on this replica's clock: a decode
            # replica that dies takes its unshipped spans with it, but the
            # ledger row still links every attempt.
            attempt_hop = trace.start_hop(
                "serve.decode_attempt", kind="ingress",
                attributes={"model": self.name, "attempt": attempt + 1,
                            "skip": sent})
            try:
                stream = self._decode.options(
                    stream=True, multiplexed_model_id=h).remote(request)
                skip = sent
                for chunk in stream:
                    if isinstance(chunk, dict) and "error" in chunk:
                        if "engine failed" in str(chunk["error"]):
                            # Sick replica: retryable elsewhere.
                            raise RuntimeError(chunk["error"])
                        yield chunk
                        return
                    if skip:
                        # Replayed prefix of a re-dispatched stream: the
                        # client already has these tokens.
                        skip -= 1
                        continue
                    sent += 1
                    yield chunk
                return
            except (BackPressureError, serve_context.DeadlineExceededError):
                raise
            except Exception as e:
                if attempt_hop is not None:
                    attempt_hop.end(error=type(e).__name__, sent=sent)
                    attempt_hop = None
                if sent and not greedy:
                    yield {"error": "decode replica died mid-stream; "
                                    "sampled (temperature > 0) streams "
                                    f"cannot be resumed: {e}"}
                    return
                attempt += 1
                if attempt > retries:
                    yield {"error": f"decode stream failed after {attempt} "
                                    f"attempts: {e}"}
                    return
                self.reroutes += 1
                _disagg_metrics()["reroutes"].inc(1.0, tags=self._mtags)
                logger.warning(
                    "decode stream for %s died (%s); re-routing (attempt "
                    "%d, %d tokens already delivered)", self.name, e,
                    attempt, sent)
                try:
                    self._decode._ensure_router()._refresh(force=True)
                except Exception:  # noqa: BLE001 — the next pick refreshes
                    pass
                time.sleep(min(0.25 * attempt, 1.0))
            finally:
                if attempt_hop is not None:
                    attempt_hop.end(sent=sent)
                if stream is not None:
                    stream.close()

    def serve_stats(self) -> Dict[str, Any]:
        return {"reroutes": self.reroutes}


def build_disagg_llm_deployment(cfg, params_factory, *, name: str = "llm",
                                num_prefill_replicas: int = 1,
                                num_decode_replicas: int = 1,
                                num_slots: int = 4,
                                max_prompt_len: int = 256,
                                max_new_tokens: int = 64,
                                num_gpus: int = 1,
                                quantize_int8: bool = False,
                                prefill_scaling_policy: Optional[Dict] = None,
                                decode_scaling_policy: Optional[Dict] = None,
                                prefix_cache_mb: Optional[float] = None
                                ) -> Application:
    """The disaggregated LLM application for ``serve.run``: its ingress
    speaks the same streamed {"tokens": [...]} -> {"token": id}* contract
    as ``build_streaming_llm_deployment``, which it degrades to when
    RTPU_SERVE_DISAGG=0. ``num_gpus=1`` (the default) gives each pool
    replica a card: too few cards, or no CUDA, raise here.

    ``*_scaling_policy`` dicts (``serve/autoscaler.py`` ScalingPolicy
    fields) put each pool under the signal-driven autoscaler; a pool
    that grows past the free cards leaves its extra replicas pending."""
    if not flags.get("RTPU_SERVE_DISAGG"):
        return build_streaming_llm_deployment(
            cfg, params_factory, name=name, max_prompt_len=max_prompt_len,
            max_new_tokens=max_new_tokens,
            num_replicas=num_decode_replicas, num_gpus=num_gpus,
            quantize_int8=quantize_int8, continuous_batching=True,
            num_slots=num_slots).bind()
    opts = {"num_gpus": int(num_gpus or 0)}
    check_cards(replica_cards(num_prefill_replicas + num_decode_replicas,
                              opts))
    device = device_for(num_gpus)
    prefill = deployment(name=f"{name}-prefill",
                         num_replicas=num_prefill_replicas,
                         ray_actor_options=opts, pool="prefill",
                         scaling_policy=prefill_scaling_policy)(
        PrefillWorker)
    decode = deployment(
        name=f"{name}-decode", num_replicas=num_decode_replicas,
        # Well above num_slots: excess streams block INSIDE the engine's
        # slot wait (where they register as queue depth) instead of in
        # the replica's queue.
        max_ongoing_requests=max(64, 4 * num_slots), stream=True,
        ray_actor_options=opts, pool="decode",
        scaling_policy=decode_scaling_policy)(DecodeWorker)
    ingress = deployment(name=name, stream=True,
                         max_ongoing_requests=64)(DisaggIngress)
    return ingress.bind(
        decode.bind(cfg, params_factory,
                    prefill.bind(cfg, params_factory,
                                 max_prompt_len=max_prompt_len,
                                 quantize_int8=quantize_int8,
                                 device=device, name=name),
                    name=name, num_slots=num_slots,
                    max_prompt_len=max_prompt_len,
                    max_new_tokens=max_new_tokens,
                    quantize_int8=quantize_int8,
                    prefix_cache_mb=prefix_cache_mb, device=device),
        name=name, max_prompt_len=max_prompt_len)
