"""@serve.multiplexed — many models per replica with LRU load/unload.

Reference parity: ray python/ray/serve/multiplex.py — decorate an async
model loader; calls carry a model id; loaded models are cached per replica
up to ``max_num_models_per_replica`` with least-recently-used eviction.
Concurrent loads of the same id are deduplicated (the cache holds the load
task), and the current model id is a ContextVar so concurrent requests
can't observe each other's ids.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import functools
from typing import Callable, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """ray parity: serve.get_multiplexed_model_id — inside a request,
    the model id this call was routed with."""
    return _current_model_id.get()


def multiplexed(_func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    def decorate(loader):
        caches = {}  # per instance: model_id -> asyncio.Task

        @functools.wraps(loader)
        async def wrapper(*args):
            if len(args) == 2:
                inst, model_id = args
                call = functools.partial(loader, inst)
                key = id(inst)
            else:
                (model_id,) = args
                call = loader
                key = None
            # deferred import: referencing the ContextVar as a closure
            # global would make cloudpickled deployment classes unpicklable
            from ray_tpu_torch.serve import multiplex as _mod

            cache = caches.get(key)
            if cache is None:
                cache = collections.OrderedDict()
                caches[key] = cache
            _mod._current_model_id.set(model_id)
            task = cache.get(model_id)
            if task is None:
                # cache the TASK immediately: a concurrent request for the
                # same id awaits this load instead of double-loading

                async def load():
                    out = call(model_id)
                    if asyncio.iscoroutine(out):
                        out = await out
                    return out

                task = asyncio.ensure_future(load())
                cache[model_id] = task
            cache.move_to_end(model_id)
            try:
                model = await asyncio.shield(task)
            except Exception:
                cache.pop(model_id, None)  # failed loads are retryable
                raise
            while len(cache) > max_num_models_per_replica:
                _old_id, old_task = cache.popitem(last=False)
                if not old_task.done():
                    old_task.cancel()
            return model

        return wrapper

    if _func is not None:
        return decorate(_func)
    return decorate
