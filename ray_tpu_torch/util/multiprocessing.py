"""Drop-in multiprocessing.Pool running on cluster actors.

ray parity: python/ray/util/multiprocessing/pool.py — Pool with
apply/apply_async/map/map_async/imap/imap_unordered/starmap, context
manager, close/terminate/join. Each pool process is one actor; tasks
round-robin over them in chunks.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Iterable, List, Optional


class _PoolActor:
    def run_batch(self, fn_items_star):
        """star=True unpacks each item as *args (starmap/apply); star=False
        passes the item as the single argument (map semantics — a tuple
        item stays one argument, matching stdlib Pool)."""
        fn, items, star = fn_items_star
        if star:
            return [fn(*args) for args in items]
        return [fn(item) for item in items]


class AsyncResult:
    def __init__(self, refs: List, chunks: List[int], single: bool = False):
        self._refs = refs
        self._chunks = chunks
        self._single = single

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        batches = ray_tpu_torch.get(self._refs, timeout=timeout)
        out = list(itertools.chain.from_iterable(batches))
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        import ray_tpu_torch

        done, _ = ray_tpu_torch.wait(
            self._refs, num_returns=len(self._refs), timeout=0
        )
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:
            return False


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (), ray_address: Optional[str] = None):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=ray_address, ignore_reinit_error=True)
        self._size = processes or max(
            int(ray_tpu_torch.cluster_resources().get("CPU", os.cpu_count() or 1)),
            1,
        )
        cls = ray_tpu_torch.remote(num_cpus=1)(_PoolActor)
        self._actors = [cls.remote() for _ in range(self._size)]
        self._closed = False
        if initializer:
            # Run the initializer once per pool actor.
            refs = []
            for a in self._actors:
                refs.append(
                    a.run_batch.remote((lambda: initializer(*initargs), [()], True))
                )
            ray_tpu_torch.get(refs, timeout=120)

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunked(self, iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._size * 4) or 1)
        return [items[i:i + chunksize] for i in range(0, len(items), chunksize)]

    def _submit(self, fn: Callable, chunks: List[list],
                star: bool = False) -> AsyncResult:
        refs = []
        for i, chunk in enumerate(chunks):
            actor = self._actors[i % self._size]
            refs.append(actor.run_batch.remote((fn, chunk, star)))
        return AsyncResult(refs, [len(c) for c in chunks])

    # -- API -----------------------------------------------------------
    def apply(self, fn: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (), kwds: dict = None,
                    callback: Optional[Callable] = None,
                    error_callback: Optional[Callable] = None):
        self._check_open()
        kwds = kwds or {}
        call = (lambda *a: fn(*a, **kwds)) if kwds else fn
        res = self._submit(call, [[tuple(args)]], star=True)
        res._single = True
        if callback is not None or error_callback is not None:
            import threading

            def waiter():
                try:
                    value = res.get()
                except Exception as e:  # noqa: BLE001
                    if error_callback is not None:
                        error_callback(e)
                    return
                if callback is not None:
                    callback(value)

            threading.Thread(target=waiter, daemon=True).start()
        return res

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        return self._submit(fn, self._chunked(iterable, chunksize))

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        chunks = self._chunked([tuple(t) for t in iterable], chunksize)
        return self._submit(fn, chunks, star=True).get()

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        import ray_tpu_torch

        self._check_open()
        chunks = self._chunked(iterable, chunksize or 1)
        refs = [self._actors[i % self._size].run_batch.remote((fn, c, False))
                for i, c in enumerate(chunks)]
        for ref in refs:  # submission order
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        import ray_tpu_torch

        self._check_open()
        chunks = self._chunked(iterable, chunksize or 1)
        pending = {
            self._actors[i % self._size].run_batch.remote((fn, c, False))
            for i, c in enumerate(chunks)
        }
        while pending:
            done, pending_list = ray_tpu_torch.wait(list(pending), num_returns=1)
            pending = set(pending_list)
            yield from ray_tpu_torch.get(done[0])

    # -- lifecycle -----------------------------------------------------
    def close(self):
        self._closed = True

    def terminate(self):
        import ray_tpu_torch

        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
