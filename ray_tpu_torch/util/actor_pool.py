"""ActorPool: load-balance tasks over a fixed set of actors.

ray parity: python/ray/util/actor_pool.py:8 — same API (submit/
get_next/get_next_unordered/map/map_unordered/has_next/push/pop_idle).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits = []

    def submit(self, fn: Callable, value: Any):
        """``fn(actor, value) -> ObjectRef``; queued if no actor is idle."""
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in submission order. On timeout the pool state is
        untouched, so the call can simply be retried."""
        import ray_tpu_torch

        if not self.has_next():
            raise StopIteration("no more results")
        future = self._index_to_future[self._next_return_index]
        value = ray_tpu_torch.get(future, timeout=timeout)
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._return_actor(self._future_to_actor.pop(future)[1])
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Whichever pending result finishes first."""
        import ray_tpu_torch

        if not self.has_next():
            raise StopIteration("no more results")
        ready, _ = ray_tpu_torch.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout
        )
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        index, actor = self._future_to_actor.pop(future)
        del self._index_to_future[index]
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def _return_actor(self, actor):
        self._idle.append(actor)
        while self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def map(self, fn: Callable, values: Iterable[Any]):
        for value in values:
            self.submit(fn, value)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for value in values:
            self.submit(fn, value)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor):
        """Add an idle actor to the pool."""
        self._idle.append(actor)
        self._return_actor(self._idle.pop())

    def pop_idle(self):
        """Remove and return an idle actor, or None."""
        return self._idle.pop() if self._idle else None
