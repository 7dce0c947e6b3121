"""LLM serving deployments: ``models/generate.py`` behind Serve
(counterpart of the JAX package's ``serve/llm.py``).

- ``build_llm_deployment``: requests coalesce via ``@batch`` into ONE
  ragged ``generate_ragged`` per batch over ``[max_batch_size, bucket]``:
  right-padded prompts with per-row cache positions and per-row
  temperatures, the bucket the batch's longest prompt rounded up to a
  power of two;
- ``build_streaming_llm_deployment``: tokens stream as they land, either
  prefill + one decode step a token per request, or (continuous
  batching) through a ``ContinuousBatchingEngine`` whose slots the
  concurrent streams share.

The replica takes a card with ``num_gpus`` (default 1, in place of the
JAX package's ``num_tpus``); with ``num_gpus=0`` it runs on the CPU. The
classes are module-level (they go to the replica by pickle, by
reference) and take the config, the params factory and the builder's
options as ``bind()`` arguments; ``params_factory`` is a zero-argument
picklable callable that makes (or loads) the params in the replica
process.

A stream through the engine is a ``serve.stream`` hop of its request's
trace (``serve/trace.py``), opened before the prefill (or the splice of
a prefilled blob) and ended after its last token, with the engine's
token stats (count, TTFT, gaps between tokens, abort cause) attached.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import batching
from . import context as serve_context
from . import trace
from .controller import check_cards, replica_cards
from .deployment import Deployment, deployment


def device_for(num_gpus: Optional[int]) -> Optional[str]:
    """The device an LLM replica runs on: its card (None: the card the
    replica process took) unless ``num_gpus`` is 0."""
    return None if num_gpus else "cpu"


def check_builder_cards(num_gpus: Optional[int], num_replicas: int) -> Dict:
    """``ray_actor_options`` for ``num_gpus``; raises, before any spawn,
    where the visible cards cannot give each replica one."""
    opts = {"num_gpus": int(num_gpus or 0)}
    check_cards(replica_cards(num_replicas, opts))
    return opts


def load_params(params_factory, device: torch.device,
                quantize_int8: bool = False) -> Dict[str, Any]:
    """``params_factory()`` on ``device`` (leaves made elsewhere are
    moved), weight-only int8 where asked."""
    params = params_factory()

    def to(t):
        return t if t.device == device else t.to(device)

    params = {k: ({n: to(t) for n, t in v.items()} if k == "layers"
                  else to(v)) for k, v in params.items()}
    if quantize_int8:
        # Decode reads every layer weight a step: halving their bytes is a
        # direct throughput lever (models/quantize.py).
        from ..models.quantize import quantize_params_int8

        params = quantize_params_int8(params)
    return params


def device_ctx(device: torch.device):
    """CUDA's current card is per thread: run a thread's work on the
    replica's card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def parse_request(request: Dict[str, Any], max_new_tokens: int):
    """(ids, n, temperature, eos) of a {"tokens": [...], optional
    "max_new_tokens", "temperature", "eos_id"} request; raises ValueError
    for a malformed one."""
    ids = np.asarray(request["tokens"], np.int64)
    if ids.ndim != 1 or ids.size == 0:
        raise ValueError("tokens must be a non-empty 1-D integer list")
    n = int(request.get("max_new_tokens", max_new_tokens))
    if n <= 0:
        raise ValueError("max_new_tokens must be positive")
    temp = float(request.get("temperature", 0.0))
    eos = request.get("eos_id")
    return ids, min(n, max_new_tokens), temp, None if eos is None else int(eos)


def replica_seed() -> int:
    # Distinct stream per replica: one seed everywhere would make replicas
    # sample identical continuations.
    return int.from_bytes(os.urandom(4), "little")


class LLM:
    """The batched LLM deployment's replica: ``@batch`` coalesces
    concurrent requests into one ``generate_ragged``."""

    def __init__(self, cfg, params_factory, *, name: str = "llm",
                 max_batch_size: int = 4, batch_wait_timeout_s: float = 0.05,
                 max_prompt_len: int = 256, max_new_tokens: int = 64,
                 pad_id: int = 0, quantize_int8: bool = False,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.name = name
        self.max_batch_size = max_batch_size
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.pad_id = pad_id
        self._params = load_params(params_factory, self.device, quantize_int8)
        self._gen = torch.Generator(device=self.device).manual_seed(
            replica_seed())
        # Batch sizes the coalescer formed, in order.
        self.batch_sizes: List[int] = []
        # One batcher per replica, sized by the builder's options.
        self._generate_batch = batching.batch(
            max_batch_size=max_batch_size,
            batch_wait_timeout_s=batch_wait_timeout_s)(self._run_batch)

    def _run_batch(self, requests: List[Dict[str, Any]]):
        from ..models.generate import generate_ragged
        from .llm_engine import bucket_len

        self.batch_sizes.append(len(requests))
        # Per-request validation: one malformed request answers with its
        # own error, never poisoning the coalesced batch.
        results: List[Optional[Dict[str, Any]]] = [None] * len(requests)
        rows: List[tuple] = []  # (request idx, ids, temp, want, trunc)
        for i, req in enumerate(requests):
            try:
                ids = np.asarray(req["tokens"], np.int64)
                if ids.ndim != 1 or ids.size == 0:
                    raise ValueError("tokens must be a non-empty 1-D "
                                     "integer list")
                temp = float(req.get("temperature", 0.0))
                want = int(req.get("max_new_tokens", self.max_new_tokens))
                if want <= 0:
                    raise ValueError("max_new_tokens must be positive")
            except Exception as e:
                results[i] = {"error": f"bad request: {e}"}
                continue
            trunc = len(ids) > self.max_prompt_len
            rows.append((i, ids[-self.max_prompt_len:], temp, want, trunc))
        if rows:
            B = self.max_batch_size
            S = bucket_len(max(len(ids) for _, ids, _, _, _ in rows),
                           self.max_prompt_len)
            toks = np.full((B, S), self.pad_id, np.int64)
            lengths = np.ones(B, np.int64)
            temps = np.zeros(B, np.float32)
            for row, (_, ids, temp, _, _) in enumerate(rows):
                toks[row, :len(ids)] = ids
                lengths[row] = len(ids)
                temps[row] = temp
            with device_ctx(self.device):
                out = generate_ragged(
                    self._params, torch.from_numpy(toks).to(self.device),
                    torch.from_numpy(lengths).to(self.device), self.cfg,
                    self.max_new_tokens,
                    temperature=torch.from_numpy(temps).to(self.device),
                    generator=self._gen).cpu().numpy()
            for row, (i, ids, _, want, trunc) in enumerate(rows):
                n = min(want, self.max_new_tokens)
                res: Dict[str, Any] = {
                    "tokens": [int(t) for t in out[row, :n]]}
                if want > self.max_new_tokens:
                    # Signal the cap instead of silently truncating.
                    res["max_new_tokens_capped"] = self.max_new_tokens
                if trunc:
                    res["prompt_truncated_to"] = self.max_prompt_len
                results[i] = res
        return results

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(request, dict) or "tokens" not in request:
            return {"error": "expected {'tokens': [...]} request body"}
        return self._generate_batch(request)

    def serve_stats(self) -> Dict[str, Any]:
        return {"batch_sizes": list(self.batch_sizes),
                "batches": len(self.batch_sizes)}


def build_llm_deployment(cfg, params_factory, *, name: str = "llm",
                         max_batch_size: int = 4,
                         batch_wait_timeout_s: float = 0.05,
                         max_prompt_len: int = 256,
                         max_new_tokens: int = 64,
                         pad_id: int = 0,
                         num_replicas: int = 1,
                         num_gpus: int = 1,
                         quantize_int8: bool = False) -> Deployment:
    """A deployment generating continuations for {"tokens": [...],
    optional "max_new_tokens", "temperature"} requests; call
    ``.bind()``. Every coalesced batch runs as ONE ragged
    ``generate_ragged``: prompts right-pad with per-row cache positions
    and temperature rides as a per-row vector. ``num_gpus=1`` (the
    default) with too few cards, or no CUDA, raises here."""
    opts = check_builder_cards(num_gpus, num_replicas)
    dep = deployment(name=name, num_replicas=num_replicas,
                     ray_actor_options=opts)(LLM)
    dep.bound_args = (cfg, params_factory)
    dep.bound_kwargs = dict(
        name=name, max_batch_size=max_batch_size,
        batch_wait_timeout_s=batch_wait_timeout_s,
        max_prompt_len=max_prompt_len, max_new_tokens=max_new_tokens,
        pad_id=pad_id, quantize_int8=quantize_int8,
        device=device_for(num_gpus))
    return dep


class StreamingLLM:
    """The streaming LLM deployment's replica: {"token": id} chunks as
    they land, per request or through a continuous-batching engine."""

    def __init__(self, cfg, params_factory, *, name: str = "llm-stream",
                 max_prompt_len: int = 256, max_new_tokens: int = 64,
                 quantize_int8: bool = False,
                 continuous_batching: bool = False, num_slots: int = 4,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.name = name
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self._params = load_params(params_factory, self.device, quantize_int8)
        # Interleaved streams on one replica share one generator, drawn
        # under a lock.
        self._gen = torch.Generator(device=self.device).manual_seed(
            replica_seed())
        self._gen_lock = threading.Lock()
        self._engine = None
        # Streams closed by their caller: the engine's decode steps
        # between the cancel and the slot's release, and the seconds.
        self.cancels: List[Dict[str, Any]] = []
        if continuous_batching:
            from .llm_engine import ContinuousBatchingEngine

            self._engine = ContinuousBatchingEngine(
                cfg, self._params, num_slots=num_slots,
                max_prompt_len=max_prompt_len,
                max_new_tokens=max_new_tokens, seed=replica_seed(), model=name,
                device=self.device)
            self._stop = threading.Event()
            self._ticker = threading.Thread(
                target=self._engine.run_forever, args=(self._stop,),
                daemon=True, name="engine-ticker")
            self._ticker.start()

    def serve_stats(self) -> Dict[str, Any]:
        """Engine load (slot occupancy, blocked submitters), its decode
        steps so far, and the cancelled streams."""
        if self._engine is None:
            return {}
        out: Dict[str, Any] = self._engine.stats()
        out["ticks"] = self._engine.ticks
        out["cancels"] = list(self.cancels)
        return out

    def __call__(self, request: Dict[str, Any]):
        try:
            ids, n, temp, eos = parse_request(request, self.max_new_tokens)
        except Exception as e:
            yield {"error": f"bad request: {e}"}
            return
        ids = ids[-self.max_prompt_len:]
        if self._engine is not None:
            yield from stream_engine(self._engine, self.cancels, ids, n,
                                     temp, eos)
            return
        yield from self._stream_alone(ids, n, temp, eos)

    def _stream_alone(self, ids, n: int, temp: float, eos: Optional[int]):
        """Prefill once, then one decode step a token."""
        from ..models.generate import _gumbel_argmax, decode_step, prefill

        with device_ctx(self.device):
            tokens = torch.from_numpy(ids[None]).to(self.device)
            logits, cache = prefill(self._params, tokens, self.cfg,
                                    self.max_prompt_len + self.max_new_tokens)
        for i in range(n):
            with device_ctx(self.device):
                if temp > 0:
                    with self._gen_lock:
                        tok = _gumbel_argmax(logits / max(temp, 1e-6),
                                             self._gen)
                else:
                    tok = torch.argmax(logits, dim=-1)
                tok_i = int(tok[0])
            yield {"token": tok_i}
            if eos is not None and tok_i == eos:
                return
            if i < n - 1:  # the last yielded token needs no next logits
                with device_ctx(self.device):
                    logits, cache = decode_step(self._params, cache, tok,
                                                self.cfg)

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()


def stream_engine(engine, cancels: List[Dict[str, Any]], ids, n: int,
                  temp: float, eos: Optional[int], *, attach=None,
                  hop_attributes: Optional[Dict[str, Any]] = None):
    """Stream one request's tokens through a running engine: submit (or
    ``attach()``, a prefilled splice), then poll every 5 ms and yield
    {"token": id} chunks as the slot emits them. The caller's cancel
    aborts the engine request at once (freeing the KV slot between
    decode steps, recorded in ``cancels``); a closed generator, a passed
    deadline or an error aborts it in the ``finally``. The whole stream
    is its request's ``serve.stream`` hop (``hop_attributes`` added)."""
    hop = trace.start_hop("serve.stream", kind="decode",
                          attributes=dict(hop_attributes or {},
                                          model=engine.model))
    try:
        # The slot wait is bounded by the request's remaining deadline
        # budget; TTFT measures from system arrival (queue wait counts).
        if attach is not None:
            req = attach()
        else:
            req = engine.submit(
                ids, max_new_tokens=n, temperature=temp, eos_id=eos,
                timeout=serve_context.remaining_s(default=300.0),
                queue_wait_s=serve_context.elapsed_s())
    except TimeoutError as e:
        # Backpressure uses the same error-chunk contract as malformed
        # requests, not a raw stream exception.
        if hop is not None:
            hop.end(status="slot_timeout")
        yield {"error": f"overloaded: {e}"}
        return
    except BaseException as e:
        if hop is not None:
            hop.end(error=type(e).__name__)
        raise

    cancel = (serve_context.get_request_context() or {}).get("cancel")

    def free() -> None:
        ticks = engine.ticks
        if engine.abort(req):
            cancels.append({"ticks_until_free": engine.ticks - ticks,
                            "cancel_to_free_s": time.monotonic() - cancel.at})

    if cancel is not None:
        cancel.add(free)
    sent = 0
    status = "ok"
    try:
        while True:
            if serve_context.cancelled():
                status = "cancelled"
                return
            if serve_context.expired():
                # Deadline passed mid-decode: stop emitting; the finally's
                # abort frees the slot now.
                status = "deadline"
                raise serve_context.DeadlineExceededError(
                    "request deadline passed mid-stream")
            try:
                toks = engine.peek(req)
            except KeyError:
                if serve_context.cancelled():
                    status = "cancelled"
                    return  # aborted by the cancel meanwhile
                raise
            while sent < len(toks):
                yield {"token": toks[sent]}
                sent += 1
            if engine.check_failed() is not None \
                    and not engine.is_done(req):
                status = "engine_failed"
                yield {"error": "generation engine failed"}
                return
            if engine.is_done(req):
                try:
                    tail = engine.pop_result(req)[sent:]
                except RuntimeError as e:
                    status = "engine_failed"
                    yield {"error": str(e)}
                    return
                for tok in tail:
                    yield {"token": tok}
                    sent += 1
                return
            time.sleep(0.005)
    except BaseException as e:
        if status == "ok":
            status = ("cancelled" if isinstance(e, GeneratorExit)
                      else type(e).__name__)
        raise
    finally:
        # A closed generator (the caller went away) or a deadline: abort
        # frees the KV slot between engine steps. After a normal
        # pop_result this is a no-op. The token stats are read first
        # (an abort of a live request records its cause).
        st = engine.token_stats(req) or {}
        if cancel is not None and cancel.event.is_set():
            # The cancel's own abort, where this thread saw the cancel
            # before its callback ran: the first abort records it.
            free()
        engine.abort(req)
        if hop is not None:
            attrs: Dict[str, Any] = {"sent": sent, "status": status}
            for k, v in st.items():
                if v is not None:
                    attrs[k] = round(v, 6) if isinstance(v, float) else v
            hop.end(**attrs)


def build_streaming_llm_deployment(cfg, params_factory, *,
                                   name: str = "llm-stream",
                                   max_prompt_len: int = 256,
                                   max_new_tokens: int = 64,
                                   num_replicas: int = 1,
                                   num_gpus: int = 1,
                                   quantize_int8: bool = False,
                                   continuous_batching: bool = False,
                                   num_slots: int = 4) -> Deployment:
    """Token-by-token streaming generation; call ``.bind()``.

    Each request runs prefill once and then a decode step per token,
    yielding {"token": id} chunks as they land. ``continuous_batching``
    backs the replica with a ContinuousBatchingEngine: ``num_slots``
    concurrent streams share ONE decode tick over a slot-pooled ragged
    cache, joining mid-flight and retiring independently. ``num_gpus=1``
    (the default) with too few cards, or no CUDA, raises here."""
    opts = check_builder_cards(num_gpus, num_replicas)
    dep = deployment(name=name, num_replicas=num_replicas, stream=True,
                     ray_actor_options=opts)(StreamingLLM)
    dep.bound_args = (cfg, params_factory)
    dep.bound_kwargs = dict(
        name=name, max_prompt_len=max_prompt_len,
        max_new_tokens=max_new_tokens, quantize_int8=quantize_int8,
        continuous_batching=continuous_batching, num_slots=num_slots,
        device=device_for(num_gpus))
    return dep
