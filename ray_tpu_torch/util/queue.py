"""A FIFO queue that processes share, over an async actor (counterpart
of the JAX package's ``util/queue.py``, whole): put and get with block
and timeout, qsize, empty, full, the nowait forms and the all-or-nothing
batch forms.

The backing :class:`_QueueActor` is an async actor (``core/worker.py``):
every call runs on its one event loop, so a ``get`` that waits on an
empty queue holds up no ``put``, and the ``asyncio.Queue`` is made there,
on the loop, at the first call. A :class:`Queue` pickles into tasks and
actors as its actor's handle, so every copy talks to the same actor.
"""
from __future__ import annotations

import asyncio
from typing import Any, List, Optional

from ..core import api


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self._maxsize = maxsize
        self._queue: Optional[asyncio.Queue] = None

    @property
    def q(self) -> asyncio.Queue:
        """The queue, made on the actor's loop where first asked for."""
        if self._queue is None:
            self._queue = asyncio.Queue(maxsize=self._maxsize)
        return self._queue

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            if timeout is None:
                await self.q.put(item)
            else:
                await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            if timeout is None:
                return True, await self.q.get()
            return True, await asyncio.wait_for(self.q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def put_nowait(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def get_nowait(self):
        try:
            return True, self.q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    def put_batch_nowait(self, items) -> bool:
        """All or nothing."""
        if self.q.maxsize and self.q.qsize() + len(items) > self.q.maxsize:
            return False
        for item in items:
            self.q.put_nowait(item)
        return True

    def get_batch_nowait(self, n: int):
        """All or nothing: takes nothing where fewer than ``n`` wait."""
        if self.q.qsize() < n:
            return False, None
        return True, [self.q.get_nowait() for _ in range(n)]

    def qsize(self) -> int:
        return self.q.qsize()

    def maxsize(self) -> int:
        return self.q.maxsize


class Queue:
    """A FIFO queue shared by the driver, tasks and actors. It pickles as
    its actor's handle: every copy talks to the same actor."""

    def __init__(self, maxsize: int = 0, *,
                 actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        self.maxsize = maxsize
        self.actor = api.remote(_QueueActor).options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not api.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        if not api.get(self.actor.put.remote(item, timeout)):
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = api.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        ok, item = api.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        """Raises Full, putting nothing, where the items do not fit."""
        if not api.get(self.actor.put_batch_nowait.remote(list(items))):
            raise Full

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        """Raises Empty, taking nothing, where fewer items wait."""
        ok, items = api.get(self.actor.get_batch_nowait.remote(num_items))
        if not ok:
            raise Empty
        return items

    def qsize(self) -> int:
        return api.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self) -> None:
        api.kill(self.actor)
