"""Distributed FIFO queue backed by a detached-capable actor.

ray parity: python/ray/util/queue.py — Queue with put/get (blocking with
timeout), put/get_nowait, batch variants, qsize/empty/full, shutdown.
The queue lives in one actor; callers on any node share it by handle.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    """asyncio queue in an actor; async methods let blocking put/get park
    on the actor's event loop without holding a worker thread."""

    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self.queue = asyncio.Queue(maxsize)

    def qsize(self) -> int:
        return self.queue.qsize()

    def empty(self) -> bool:
        return self.queue.empty()

    def full(self) -> bool:
        return self.queue.full()

    async def put(self, item, timeout: Optional[float] = None):
        if timeout is None:
            await self.queue.put(item)
            return True
        try:
            await asyncio.wait_for(self.queue.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def put_nowait(self, item) -> bool:
        try:
            self.queue.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def put_nowait_batch(self, items: List[Any]) -> bool:
        """All-or-nothing: nothing enqueues unless the whole batch fits."""
        if self.maxsize and self.queue.qsize() + len(items) > self.maxsize:
            return False
        for item in items:
            self.queue.put_nowait(item)
        return True

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return (True, await self.queue.get())
        try:
            return (True, await asyncio.wait_for(self.queue.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    def get_nowait(self):
        try:
            return (True, self.queue.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    def get_nowait_batch(self, num_items: int):
        out = []
        for _ in range(num_items):
            ok, item = self.get_nowait()
            if not ok:
                break
            out.append(item)
        return out


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        import ray_tpu_torch

        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        # Parked blocking gets must not starve puts: allow many concurrent
        # async method activations on the queue actor.
        opts.setdefault("max_concurrency", 1000)
        cls = ray_tpu_torch.remote(**opts)(_QueueActor)
        self.actor = cls.remote(maxsize)
        self.maxsize = maxsize

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.empty.remote(), timeout=30)

    def full(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.full.remote(), timeout=30)

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch

        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item), timeout=30):
                raise Full
            return
        ok = ray_tpu_torch.get(
            self.actor.put.remote(item, timeout),
            timeout=None if timeout is None else timeout + 30,
        )
        if not ok:
            raise Full

    def put_nowait(self, item):
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]):
        import ray_tpu_torch

        items = list(items)
        ok = ray_tpu_torch.get(self.actor.put_nowait_batch.remote(items), timeout=30)
        if not ok:
            raise Full(f"batch of {len(items)} does not fit")

    def get(self, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch

        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote(), timeout=30)
            if not ok:
                raise Empty
            return item
        ok, item = ray_tpu_torch.get(
            self.actor.get.remote(timeout),
            timeout=None if timeout is None else timeout + 30,
        )
        if not ok:
            raise Empty
        return item

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self.actor.get_nowait_batch.remote(num_items), timeout=30
        )

    def shutdown(self, force: bool = False):
        import ray_tpu_torch

        ray_tpu_torch.kill(self.actor)
