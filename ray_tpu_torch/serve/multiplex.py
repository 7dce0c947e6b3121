"""Model multiplexing: many models share one deployment's replicas
(counterpart of the JAX package's ``serve/multiplex.py``).

The loader is wrapped with a per-replica LRU cache; requests carry a
model id (``handle.options(multiplexed_model_id=...)``), which the
replica installs in the request's context on the request's own thread
before the user's code runs (``replica.py``), and the router keeps
per-model affinity (a rendezvous hash over the replicas), so repeated
requests for one model land where it is already loaded.

As in the JAX package, a model is loaded before the least recently used
one is evicted: a replica briefly holds ``max_num_models_per_replica + 1``
models. An evicted model's memory (on the card too) is freed once
nothing else references it.
"""
from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Callable, Optional

from . import context as serve_context


def get_multiplexed_model_id() -> str:
    """Inside a replica handling a multiplexed request: the model id the
    caller asked for ("" where it asked for none)."""
    ctx = serve_context.get_request_context()
    return (ctx or {}).get("multiplexed_model_id") or ""


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorate a model-loader method (or function): calls are cached per
    model id in a per-replica LRU of size ``max_num_models_per_replica``;
    evicted models are dropped."""

    def wrap(loader: Callable) -> Callable:
        # The cache and its lock are made in the replica process, on first
        # use (stored on the instance, or on the wrapper for a function):
        # the class goes to replicas by pickle.
        state_attr = f"_rtpu_mux_{loader.__name__}"

        def _state(owner):
            st = getattr(owner, state_attr, None)
            if st is None:
                st = {"lock": threading.Lock(), "cache": OrderedDict()}
                setattr(owner, state_attr, st)
            return st

        @functools.wraps(loader)
        def wrapper(self_or_id=None, model_id: Optional[str] = None):
            # Both the method (self, model_id?) and the function form.
            if isinstance(self_or_id, str) and model_id is None:
                bound_self, mid = None, self_or_id
            else:
                bound_self, mid = self_or_id, model_id
            if mid is None:
                mid = get_multiplexed_model_id()
            if not mid:
                raise ValueError(
                    "no model id: pass one or call via "
                    "handle.options(multiplexed_model_id=...)")
            st = _state(bound_self if bound_self is not None else wrapper)
            lock, cache = st["lock"], st["cache"]
            with lock:
                if mid in cache:
                    cache.move_to_end(mid)
                    return cache[mid]
            model = loader(bound_self, mid) if bound_self is not None \
                else loader(mid)
            with lock:
                cache[mid] = model
                cache.move_to_end(mid)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
            return model

        return wrapper

    if func is not None:
        return wrap(func)
    return wrap
