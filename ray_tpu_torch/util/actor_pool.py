"""ActorPool: work balanced over a fixed set of actor handles
(counterpart of the JAX package's ``util/actor_pool.py``, whole): map,
map_unordered, submit, get_next, get_next_unordered, has_next, push,
pop_idle. ``fn(actor, value)`` runs in the caller and returns a ref, so
it may be a lambda; the actors are any of the core's (``core/api.py``).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..core import api


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        # object_id -> (ref, actor) for every in-flight submission.
        self._pending: Dict[str, Tuple[Any, Any]] = {}
        # Submission order for get_next(); ids consumed unordered are
        # skipped when the ordered cursor reaches them.
        self._order: "collections.deque[str]" = collections.deque()
        self._consumed: set = set()

    # ----------------------------------------------------------------- map

    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        """Ordered results; fn(actor, value) -> ObjectRef."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -------------------------------------------------------------- submit

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        while not self._idle:
            # Saturated: recycle the first finishing actor (blocking here
            # keeps map() simple without unbounded submission). Entries whose
            # actor was already recycled carry None and are skipped.
            live = [(oid, ra) for oid, ra in self._pending.items()
                    if ra[1] is not None]
            if not live:
                raise RuntimeError("ActorPool has no actors")
            ready, _ = api.wait([ra[0] for _, ra in live], num_returns=1)
            oid = ready[0].object_id
            ref, actor = self._pending[oid]
            if actor is not None:
                self._idle.append(actor)
                self._pending[oid] = (ref, None)
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._pending[ref.object_id] = (ref, actor)
        self._order.append(ref.object_id)

    def has_next(self) -> bool:
        return any(oid not in self._consumed for oid in self._order)

    def _recycle(self, oid: str) -> Any:
        ref, actor = self._pending.pop(oid)
        if actor is not None:
            self._idle.append(actor)
        self._consumed.add(oid)
        return ref

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order."""
        while self._order and self._order[0] in self._consumed:
            self._consumed.discard(self._order.popleft())
        if not self._order:
            raise StopIteration("no pending results")
        oid = self._order.popleft()
        ref = self._recycle(oid)
        self._consumed.discard(oid)
        return api.get(ref, timeout=timeout)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next COMPLETED result, regardless of submission order."""
        live = [oid for oid in self._order if oid not in self._consumed]
        if not live:
            raise StopIteration("no pending results")
        refs = [self._pending[oid][0] for oid in live]
        ready, _ = api.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result ready within timeout")
        ref = self._recycle(ready[0].object_id)
        return api.get(ref)

    # ------------------------------------------------------------ idle mgmt

    def push(self, actor: Any) -> None:
        self._idle.append(actor)

    def pop_idle(self) -> Optional[Any]:
        return self._idle.pop() if self._idle else None
