"""Continuous-batching generation engine (slot-based, vLLM-style shape).

Counterpart of the JAX package's ``serve/llm_engine.py``. A fixed pool of B
slots shares one ragged KV cache (``models/generate.py`` per-row
positions); every tick runs ONE decode step over all slots, and a request
attaches by splicing its prefilled K/V into a free slot mid-flight. Short
requests retire without stalling long ones; new arrivals don't wait for the
batch to drain.

Units of work:
- per-length-bucket prefill of a single prompt (power-of-2 buckets);
- the slot splice: an in-place ``copy_`` of the request's K/V into the
  preallocated cache (the JAX engine rebuilds the cache arrays);
- one decode tick (the [B] ragged decode step + sampling).

Inactive slots still compute through the tick (their rows are ignored at
the host), so their ``pos`` keeps advancing, past ``max_len`` in a
long-lived engine; the decode step clamps their cache writes to the last
slot and the tick never checks for overflow. A splice fully re-initialises
a slot on attach.

The serve trace and metrics plane, as in the JAX engine
(``ray_tpu/serve/llm_engine.py:36-75``, ``:223``, ``:302``, ``:360``,
``:524``, ``:559``, ``:577``, ``:651-660``): the ``serve.prefill`` and
``serve.engine_attach`` hops (``serve/trace.py``), the TTFT,
decode-token, slot and inter-token instruments (:func:`_serve_metrics`,
``util/metrics.py``), and the STREAM_STALLED event (``core/events.py``)
that ``peek`` raises once for a live slot silent for
RTPU_SERVE_STALL_S. The per-request token timeline
(``token_stats``, ``last_token_age``, the ITL observations, the stall
detector) is kept only with RTPU_SERVE_TRACE on: off, it costs one flag
check.

Sampling uses one seeded ``torch.Generator`` on the engine's device, for the
first token (``_pick_host``) and for every tick; greedy decoding is
deterministic and matches the JAX engine token for token.

The prefill handoff blob (``prefill_only`` -> ``attach_prefilled``) holds
CPU tensors rather than numpy arrays (numpy has no bfloat16);
``attach_prefilled`` takes either.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import flags
from ..device import DeviceLike, resolve_device, same_device
from ..models.generate import KVCache, _decode, _gumbel_argmax, prefill
from . import context as serve_context
from . import trace as serve_trace

_serve_metrics_cache = None


def _serve_metrics():
    """The engine's serve instruments, shared by every engine of the
    process and tagged by model: TTFT, decode tokens, busy slots and the
    gap between tokens."""
    global _serve_metrics_cache
    if _serve_metrics_cache is None:
        from ..util.metrics import Counter, Gauge, Histogram

        _serve_metrics_cache = {
            "ttft": Histogram(
                "rtpu_serve_ttft_s",
                description="Serve time-to-first-token: request submit "
                            "to first sampled token (prefill + splice "
                            "wait)",
                boundaries=[0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                            10.0, 30.0],
                tag_keys=("model",)),
            "tokens": Counter(
                "rtpu_serve_decode_tokens_total",
                description="Decode tokens emitted by the "
                            "continuous-batching engine",
                tag_keys=("model",)),
            "slots": Gauge(
                "rtpu_serve_slots_busy",
                description="Continuous-batching slots currently "
                            "generating",
                tag_keys=("model",)),
            "itl": Histogram(
                "rtpu_serve_itl_s",
                description="Serve inter-token latency: gap between "
                            "consecutive sampled tokens of one stream "
                            "(per decode tick, engine-side)",
                boundaries=[0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                            0.5, 1.0, 5.0],
                tag_keys=("model",)),
        }
    return _serve_metrics_cache


# Per-request token-timestamp ring capacity and the bounded finished-stats
# map: enough stamps to characterize ITL tails without unbounded growth.
_TOKEN_RING = 2048
_DONE_STATS_MAX = 1024
# Longest a tick waits for blocked lock takers to get in first (a safety
# bound: a woken taker normally gets the lock within a millisecond).
_YIELD_MAX_S = 0.05


class _CountedLock:
    """The engine lock, counting the threads blocked on it.

    Python's locks are not fair: the ticker releases the lock at the end of
    one tick and takes it again at the start of the next before a woken
    taker runs, so a submit, a ``peek`` or a slot waiter woken by a retire
    could wait for many ticks (a whole request's lifetime, on the CPU). The
    count lets :meth:`ContinuousBatchingEngine.tick` let them in first.
    ``threading.Condition`` takes it like a plain lock; its wait re-takes
    the lock through :meth:`acquire`, so woken waiters are counted too."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        self.blocked = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        with self._count_lock:
            self.blocked += 1
        try:
            return self._lock.acquire(True, timeout)
        finally:
            with self._count_lock:
                self.blocked -= 1

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def bucket_len(n: int, max_len: int, floor: int = 8) -> int:
    """Power-of-2 length bucket (>= floor, <= max_len): bounds the number of
    distinct prefill shapes."""
    S = floor
    while S < n:
        S <<= 1
    return min(S, max_len)


class ContinuousBatchingEngine:
    """B-slot continuous batching over a shared ragged KV cache.

    ``params`` must already live on ``device`` (default: the current CUDA
    device; pass ``device="cpu"`` to run on the CPU)."""

    def __init__(self, cfg, params, *, num_slots: int = 4,
                 max_prompt_len: int = 128, max_new_tokens: int = 64,
                 seed: int = 0, model: str = "",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if not same_device(params["embed"].device, self.device):
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}; move them first")
        self.cfg = cfg
        self.params = params
        self.model = model or "default"
        self._mtags = {"model": self.model}
        self.B = num_slots
        self.max_prompt_len = max_prompt_len
        self.max_new = max_new_tokens
        self.max_len = max_prompt_len + max_new_tokens

        L = cfg.n_layers
        KVH, hd = cfg.kv_heads, cfg.head_dim
        kv_shape = (L, self.B, self.max_len, KVH, hd)
        self.cache = KVCache(
            k=torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device),
            v=torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device),
            pos=torch.zeros((self.B,), dtype=torch.int64,
                            device=self.device))
        self.cur_tok = torch.zeros((self.B,), dtype=torch.int64,
                                   device=self.device)

        # Host-side slot bookkeeping, under the engine lock.
        self.lock = _CountedLock()
        self.active = [False] * self.B
        self.budget = [0] * self.B      # tokens left to emit per slot
        self.eos: List[Optional[int]] = [None] * self.B
        self.temp = np.zeros(self.B, np.float32)
        self.out: List[List[int]] = [[] for _ in range(self.B)]
        # Slots recycle; REQUESTS are the stable identity. submit() returns
        # a request id, finished outputs move to _results keyed by it, and
        # readers can never observe a successor request's tokens.
        self.slot_req: List[Optional[int]] = [None] * self.B
        self._req_seq = 0
        self._req_slot: Dict[int, int] = {}
        self._results: Dict[int, List[int]] = {}
        self._done_ev: Dict[int, threading.Event] = {}
        self._discarded: set = set()
        self.failed: Optional[BaseException] = None
        self._free = list(range(self.B))
        self._free_cv = threading.Condition(self.lock)
        # Token timeline: per-live-request monotonic token stamps in a
        # bounded ring + per-request TTFT; finished requests fold into a
        # bounded summary map. _stall_flagged makes the stall flag
        # exactly-once per request.
        self._token_times: Dict[int, Any] = {}
        self._ttft_vals: Dict[int, float] = {}
        self._token_stats_done: "collections.OrderedDict[int, Dict]" = \
            collections.OrderedDict()
        self._stall_flagged: set = set()
        # Submitters blocked waiting for a slot (queue-depth signal), and
        # the decode steps run so far.
        self._waiting = 0
        self.ticks = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------- device work

    def _device_ctx(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @torch.no_grad()
    def _prefill_one(self, params, tokens, length):
        """[1, S] -> (logits [V], k/v [L, S, KVH, hd])."""
        logits, cache = prefill(params, tokens, self.cfg, tokens.shape[1],
                                lengths=length)
        return logits[0], cache.k[:, 0], cache.v[:, 0]

    def _splice(self, slot: int, k1, v1, length: int, first: int) -> None:
        """Copy one request's K/V [L, S, KVH, hd] into slot ``slot`` of the
        cache in place, zero the rest of the slot, set its position and
        current token."""
        S = k1.shape[1]
        self.cache.k[:, slot, :S].copy_(k1)
        self.cache.v[:, slot, :S].copy_(v1)
        if S < self.max_len:
            self.cache.k[:, slot, S:].zero_()
            self.cache.v[:, slot, S:].zero_()
        self.cache.pos[slot] = length
        self.cur_tok[slot] = first

    @torch.no_grad()
    def _tick(self, params, cache, cur, temps: np.ndarray):
        """One ragged decode step + per-slot sampling -> (next [B], logits
        [B, V], cache)."""
        logits, cache = _decode(params, cache, cur, self.cfg)
        nxt = torch.argmax(logits, dim=-1)
        if (temps > 0).any():
            t = torch.as_tensor(temps, device=self.device)
            sampled = _gumbel_argmax(logits / t[:, None].clamp_min(1e-6),
                                     self._gen)
            nxt = torch.where(t <= 0.0, nxt, sampled)
        return nxt, logits, cache

    # ------------------------------------------------------------ requests

    def _prepare(self, tokens):
        ids = np.asarray(tokens, np.int64)
        if ids.ndim != 1 or ids.size == 0:
            raise ValueError("tokens must be a non-empty 1-D integer list")
        ids = ids[-self.max_prompt_len:]
        S = bucket_len(len(ids), self.max_prompt_len)
        padded = np.zeros((1, S), np.int64)
        padded[0, :len(ids)] = ids
        return (torch.from_numpy(padded).to(self.device),
                torch.tensor([len(ids)], device=self.device), len(ids), S)

    def submit(self, tokens, *, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               timeout: Optional[float] = None,
               arrival_ts: Optional[float] = None,
               queue_wait_s: Optional[float] = None) -> int:
        """Attach a request to a free slot (blocking while all slots busy).
        Returns a stable REQUEST id; poll with peek(), collect with
        result() — valid even after the slot is recycled.

        TTFT is measured from request ARRIVAL: ``queue_wait_s`` is time
        already spent upstream (monotonic, per host), ``arrival_ts`` (epoch
        seconds) the same-process alternative; with neither, arrival is
        now."""
        mono0 = time.monotonic()
        padded, length_t, n, S = self._prepare(tokens)
        # Prefill OUTSIDE the engine lock.
        hop = serve_trace.start_hop(
            "serve.prefill", kind="prefill",
            attributes={"model": self.model, "prompt_len": n, "bucket": S,
                        "local": True})
        try:
            logits1, k1, v1 = self._prefill_one(self.params, padded,
                                                length_t)
        except BaseException as e:
            if hop is not None:
                hop.end(error=type(e).__name__)
            raise
        if hop is not None:
            hop.end()
        return self._attach(k1, v1, n, logits1,
                            max_new_tokens=max_new_tokens,
                            temperature=temperature, eos_id=eos_id,
                            timeout=timeout, arrival_ts=arrival_ts,
                            queue_wait_s=queue_wait_s, mono0=mono0)

    def attach_prefilled(self, k, v, length: int, logits, *,
                         max_new_tokens: Optional[int] = None,
                         temperature: float = 0.0,
                         eos_id: Optional[int] = None,
                         timeout: Optional[float] = None,
                         arrival_ts: Optional[float] = None,
                         queue_wait_s: Optional[float] = None) -> int:
        """Attach a request whose prefill ran ELSEWHERE (a prefill pool's
        handoff or a prefix-cache hit), splicing the K/V straight into a
        free slot with no prefill compute here.

        ``k``/``v`` are one request's [L, S, KVH, hd] (S = any length bucket
        <= max_len) as CPU or device tensors or numpy arrays; ``logits``
        the prefill's last-position [V] row that decides the first token.
        Everything else matches submit()."""
        mono0 = time.monotonic()
        k = torch.as_tensor(k).to(self.device, self.cfg.dtype)
        v = torch.as_tensor(v).to(self.device, self.cfg.dtype)
        if k.dim() != 4 or v.shape != k.shape:
            raise ValueError("k/v must be [L, S, KVH, hd] for one request")
        S = int(k.shape[1])
        length = int(length)
        if not (0 < length <= S <= self.max_len):
            raise ValueError(
                f"bad handoff: length={length} bucket={S} "
                f"max_len={self.max_len}")
        logits = torch.as_tensor(logits).to(self.device, torch.float32)
        return self._attach(k, v, length, logits,
                            max_new_tokens=max_new_tokens,
                            temperature=temperature, eos_id=eos_id,
                            timeout=timeout, arrival_ts=arrival_ts,
                            queue_wait_s=queue_wait_s, mono0=mono0)

    def _attach(self, k1, v1, length: int, logits1: torch.Tensor, *,
                max_new_tokens: Optional[int], temperature: float,
                eos_id: Optional[int], timeout: Optional[float],
                arrival_ts: Optional[float],
                queue_wait_s: Optional[float] = None,
                mono0: Optional[float] = None) -> int:
        """Shared slot-wait + splice tail of submit()/attach_prefilled():
        k1/v1 are [L, S, KVH, hd] on the engine's device, logits1 the [V]
        row. ``mono0`` is the caller's entry stamp so prefill time counts
        toward TTFT.

        The ``serve.engine_attach`` hop covers this process's slot wait
        and splice (the waterfall's "engine slot wait" bar); it rides the
        caller thread's serve context, so it nests under the replica's
        span."""
        hop = serve_trace.start_hop("serve.engine_attach", kind="engine",
                                    attributes={"model": self.model})
        try:
            req = self._attach_locked(
                k1, v1, length, logits1, max_new_tokens=max_new_tokens,
                temperature=temperature, eos_id=eos_id, timeout=timeout,
                arrival_ts=arrival_ts, queue_wait_s=queue_wait_s,
                mono0=mono0, hop=hop)
        except BaseException as e:
            if hop is not None:
                hop.end(error=type(e).__name__)
            raise
        if hop is not None:
            hop.end()
        return req

    def _attach_locked(self, k1, v1, length: int, logits1: torch.Tensor, *,
                       max_new_tokens: Optional[int], temperature: float,
                       eos_id: Optional[int], timeout: Optional[float],
                       arrival_ts: Optional[float],
                       queue_wait_s: Optional[float] = None,
                       mono0: Optional[float] = None, hop=None) -> int:
        if mono0 is None:
            mono0 = time.monotonic()
        with self._free_cv:
            # One monotonic deadline for the whole wait: contended submits
            # that wake repeatedly must not restart the clock each time.
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            self._waiting += 1
            try:
                while not self._free:
                    # A dead ticker recorded its failure and notified this
                    # condition; it will never free a slot.
                    if self.failed is not None:
                        raise RuntimeError(
                            f"engine failed: {self.failed!r}")
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError("no free generation slot")
                    self._free_cv.wait(timeout=remaining)
            finally:
                self._waiting -= 1
            if self.failed is not None:
                raise RuntimeError(f"engine failed: {self.failed!r}")
            slot = self._free.pop()
            self._req_seq += 1
            req = self._req_seq
            self.slot_req[slot] = req
            self._req_slot[req] = slot
            self._done_ev[req] = threading.Event()
            # First token comes from the prefill logits, decided under the
            # lock with the slot's sampling config.
            first = self._pick_host(logits1, temperature)
            local_wait = time.monotonic() - mono0
            if queue_wait_s is not None:
                ttft = max(0.0, float(queue_wait_s)) + local_wait
            elif arrival_ts is not None:
                ttft = max(0.0, time.time() - float(arrival_ts))
            else:
                ttft = local_wait
            m = _serve_metrics()
            m["ttft"].observe(ttft, tags=self._mtags)
            m["tokens"].inc(1.0, tags=self._mtags)
            if serve_trace.enabled():
                self._token_times[req] = collections.deque(
                    [time.monotonic()], maxlen=_TOKEN_RING)
                self._ttft_vals[req] = float(ttft)
            if hop is not None:
                hop.attributes.update(
                    slot=slot, ttft_s=round(float(ttft), 6),
                    slot_wait_s=round(local_wait, 6))
            n = min(max_new_tokens or self.max_new, self.max_new)
            self.active[slot] = True
            self.budget[slot] = n - 1
            self.eos[slot] = eos_id
            self.temp[slot] = temperature
            self.out[slot] = [int(first)]
            self._splice(slot, k1, v1, length, int(first))
            if self.budget[slot] <= 0 or (eos_id is not None
                                          and int(first) == eos_id):
                self._retire_locked(slot)
            m["slots"].set(self.B - len(self._free), tags=self._mtags)
            return req

    def prefill_only(self, tokens):
        """Run this engine's bucketed prefill WITHOUT taking a slot:
        returns ``(k, v, length, logits)`` with k/v [L, S, KVH, hd] (S =
        the length bucket) and logits [V] as CPU tensors — the handoff blob
        attach_prefilled() accepts."""
        padded, length_t, n, _ = self._prepare(tokens)
        logits1, k1, v1 = self._prefill_one(self.params, padded, length_t)
        return k1.cpu(), v1.cpu(), n, logits1.cpu()

    def stats(self) -> Dict[str, float]:
        """Load snapshot: busy/total slots, occupancy in [0,1], and
        submitters blocked on a slot."""
        with self.lock:
            busy = self.B - len(self._free)
            return {"slots_busy": float(busy),
                    "slots_total": float(self.B),
                    "occupancy": busy / float(self.B),
                    "queued": float(self._waiting)}

    def _pick_host(self, logits: torch.Tensor, temperature: float) -> int:
        if temperature <= 0:
            return int(torch.argmax(logits))
        scaled = logits.float() / max(temperature, 1e-6)
        return int(_gumbel_argmax(scaled[None], self._gen)[0])

    def _summarize_locked(self, req: int, *, cause: str = "") -> None:
        """Fold a request's token ring into the bounded finished-stats map
        (at retirement, under the engine lock)."""
        dq = self._token_times.pop(req, None)
        ttft = self._ttft_vals.pop(req, None)
        self._stall_flagged.discard(req)
        if dq is None:
            return
        stamps = list(dq)
        slot = self._req_slot.get(req)
        tokens = len(self.out[slot]) if slot is not None else len(stamps)
        st: Dict[str, Any] = {"tokens": tokens, "ttft_s": ttft,
                              "abort_cause": cause}
        st.update(_itl_summary(stamps))
        self._token_stats_done[req] = st
        while len(self._token_stats_done) > _DONE_STATS_MAX:
            self._token_stats_done.popitem(last=False)

    def _retire_locked(self, slot: int) -> None:
        self.active[slot] = False
        req = self.slot_req[slot]
        if req is not None:
            self._summarize_locked(
                req, cause="discarded" if req in self._discarded else "")
            if req in self._discarded:
                # Consumer went away mid-stream: drop the output instead
                # of storing it for a reader that will never come.
                self._discarded.discard(req)
                self._done_ev.pop(req, None)
            else:
                self._results[req] = list(self.out[slot])
                self._done_ev[req].set()
            self._req_slot.pop(req, None)
            self.slot_req[slot] = None
        self._free.append(slot)
        self._free_cv.notify_all()

    def discard(self, req: int) -> None:
        """Consumer abandoned the request: release its stored output now,
        or mark it to be dropped at retirement."""
        with self.lock:
            if req in self._results or (req in self._done_ev
                                        and req not in self._req_slot):
                self._results.pop(req, None)
                self._done_ev.pop(req, None)
                return
            slot = self._req_slot.get(req)
            if slot is not None:
                self._discarded.add(req)
                self.budget[slot] = 0  # retire at the next tick

    def abort(self, req: int) -> bool:
        """Cancel a request NOW, between engine steps: the slot frees
        immediately and any stored output is dropped. Returns True if the
        request was known (live or finished), False otherwise."""
        with self.lock:
            slot = self._req_slot.get(req)
            if slot is not None:
                # Summarize FIRST with the abort cause: _retire_locked's
                # own summarize is then a no-op.
                self._summarize_locked(req, cause="aborted")
                self._discarded.add(req)
                self._retire_locked(slot)
                _serve_metrics()["slots"].set(
                    self.B - len(self._free), tags=self._mtags)
                return True
            if req in self._results or req in self._done_ev:
                self._results.pop(req, None)
                self._done_ev.pop(req, None)
                return True
            return False

    # ---------------------------------------------------------------- tick

    def tick(self) -> int:
        """One decode step for every active slot; returns #active after.

        The whole tick holds the engine lock, so a splice cannot land
        between the step and the bookkeeping; submit's prefill runs outside
        the lock, so attaches wait at most one tick for the splice: threads
        blocked on the lock go first (see :class:`_CountedLock`)."""
        deadline = time.monotonic() + _YIELD_MAX_S
        while self.lock.blocked and time.monotonic() < deadline:
            time.sleep(1e-4)
        with self.lock:
            if not any(self.active):
                return 0
            nxt, _logits, cache = self._tick(
                self.params, self.cache, self.cur_tok, self.temp)
            nxt_host = nxt.cpu().tolist()
            self.ticks += 1
            self.cache = cache
            self.cur_tok = nxt
            emitted = 0
            now_m = time.monotonic()
            m = _serve_metrics()
            for s in range(self.B):
                if not self.active[s]:
                    continue
                tok = int(nxt_host[s])
                self.out[s].append(tok)
                # Token timeline: one monotonic stamp a token feeds the
                # ITL histogram and the stall detector.
                dq = self._token_times.get(self.slot_req[s])
                if dq is not None:
                    m["itl"].observe(now_m - dq[-1], tags=self._mtags)
                    dq.append(now_m)
                emitted += 1
                self.budget[s] -= 1
                if self.budget[s] <= 0 or (self.eos[s] is not None
                                           and tok == self.eos[s]):
                    self._retire_locked(s)
            if emitted:
                m["tokens"].inc(float(emitted), tags=self._mtags)
                m["slots"].set(self.B - len(self._free), tags=self._mtags)
            return sum(self.active)

    # ------------------------------------------------------------- results

    def result(self, req: int, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finished; returns its tokens. The result
        stays retrievable after slot recycling; pop_result() releases it."""
        ev = self._done_ev.get(req)
        if ev is None:
            raise KeyError(f"unknown request {req}")
        if not ev.wait(timeout=timeout):
            raise TimeoutError(f"request {req} still generating")
        with self.lock:
            if self.failed is not None and req not in self._results:
                raise RuntimeError(
                    f"generation engine failed: {self.failed!r}")
            return list(self._results[req])

    def pop_result(self, req: int) -> List[int]:
        """result() + release the stored output."""
        out = self.result(req)
        with self.lock:
            self._results.pop(req, None)
            self._done_ev.pop(req, None)
        return out

    def is_done(self, req: int) -> bool:
        ev = self._done_ev.get(req)
        return ev is not None and ev.is_set()

    def check_failed(self) -> Optional[BaseException]:
        return self.failed

    def peek(self, req: int) -> List[int]:
        """Tokens emitted so far (streaming consumers poll this). The stall
        detector lives here: a hung ticker cannot run its own watchdog, but
        the polling consumer notices the silence and fires the
        exactly-once STREAM_STALLED event, with a stack capture of every
        thread."""
        stalled_age = None
        with self.lock:
            done = self._results.get(req)
            if done is not None:
                return list(done)
            slot = self._req_slot.get(req)
            if slot is None:
                raise KeyError(f"unknown request {req}")
            out = list(self.out[slot])
            dq = self._token_times.get(req)
            if dq is not None and req not in self._stall_flagged:
                stall_s = float(flags.get("RTPU_SERVE_STALL_S") or 0.0)
                if stall_s > 0:
                    age = time.monotonic() - dq[-1]
                    if age > stall_s:
                        self._stall_flagged.add(req)
                        stalled_age = age
        if stalled_age is not None:
            self._emit_stall(req, stalled_age)
        return out

    def _emit_stall(self, req: int, age_s: float) -> None:
        """Ship the STREAM_STALLED event (outside the engine lock: the
        stack capture walks every thread's frames)."""
        from ..core import events

        rid = serve_context.get_request_id()
        events.emit(
            "WARNING", "STREAM_STALLED",
            f"stream {rid or req} on model {self.model} emitted no "
            f"token for {age_s:.1f}s with a live slot",
            source="serve",
            data={"stack": serve_trace.capture_stacks(),
                  "request_id": rid, "engine_req": req,
                  "model": self.model, "age_s": round(age_s, 3)})

    # ------------------------------------------------------- token stats

    def token_stats(self, req: int) -> Optional[Dict[str, Any]]:
        """Per-request token timeline summary: token count, TTFT, ITL
        mean/p50/p99/max, abort cause (live or finished requests)."""
        with self.lock:
            st = self._token_stats_done.get(req)
            if st is not None:
                return dict(st)
            dq = self._token_times.get(req)
            if dq is None:
                return None
            stamps = list(dq)
            slot = self._req_slot.get(req)
            out: Dict[str, Any] = {
                "tokens": len(self.out[slot]) if slot is not None
                else len(stamps),
                "ttft_s": self._ttft_vals.get(req), "abort_cause": ""}
            out.update(_itl_summary(stamps))
            return out

    def last_token_age(self, req: int) -> Optional[float]:
        """Seconds since the request's newest token (monotonic), None for
        unknown/finished requests."""
        with self.lock:
            dq = self._token_times.get(req)
            if dq is None:
                return None
            return time.monotonic() - dq[-1]

    # ------------------------------------------------------- ticker thread

    def run_forever(self, stop: threading.Event, idle_sleep: float = 0.005):
        """Tick loop for a background thread: ticks while any slot is
        active, sleeps briefly when idle. CUDA work runs on the engine's
        device, whatever the thread's current device."""
        with self._device_ctx():
            while not stop.is_set():
                try:
                    n = self.tick()
                except BaseException as e:  # device/runtime failure
                    # A dead ticker must not strand pollers: record the
                    # failure, wake every waiter, and stop.
                    with self.lock:
                        self.failed = e
                        for ev in self._done_ev.values():
                            ev.set()
                        self._free_cv.notify_all()
                    if not isinstance(e, Exception):
                        raise  # exit and interrupt still end the thread
                    return
                if n == 0:
                    time.sleep(idle_sleep)


def _itl_summary(stamps: List[float]) -> Dict[str, float]:
    itls = [b - a for a, b in zip(stamps, stamps[1:])]
    if not itls:
        return {}
    srt = sorted(itls)
    return {"itl_mean_s": sum(itls) / len(itls),
            "itl_p50_s": srt[len(srt) // 2],
            "itl_p99_s": srt[min(len(srt) - 1, int(len(srt) * 0.99))],
            "itl_max_s": srt[-1]}
