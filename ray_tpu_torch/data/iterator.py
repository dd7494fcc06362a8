"""DataIterator + streaming split.

Reference parity: ray python/ray/data/iterator.py (iter_batches formats,
local shuffle buffer) and _internal/execution/operators/output_splitter.py
(streaming_split coordinator feeding Train workers). The JAX package's
``iter_jax_batches`` has no counterpart here: ``iter_torch_batches(
device=...)`` lands batches on the card.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks


def _emit(table: Block, batch_format: str):
    acc = BlockAccessor(table)
    return acc.to_batch(batch_format)


def iter_batches_over(bundles, *, batch_size: Optional[int],
                      batch_format: str = "numpy",
                      drop_last: bool = False,
                      shuffle_buffer_size: Optional[int] = None,
                      shuffle_seed: Optional[int] = None) -> Iterator[Any]:
    """Re-batch a stream of (ref, meta) into fixed-size batches, carrying
    remainders across block boundaries (the reference's batcher)."""
    import ray_tpu_torch

    rng = np.random.default_rng(shuffle_seed)
    carry: List[Block] = []
    carry_rows = 0

    def blocks():
        for ref, _m in bundles:
            b = ray_tpu_torch.get(ref)
            if b.num_rows:
                yield b

    source = blocks()
    if shuffle_buffer_size:
        def shuffled(src):
            for b in src:
                perm = rng.permutation(b.num_rows)
                yield BlockAccessor(b).take(list(perm))
        source = shuffled(source)

    if batch_size is None:
        for b in source:
            yield _emit(b, batch_format)
        return

    for block in source:
        carry.append(block)
        carry_rows += block.num_rows
        while carry_rows >= batch_size:
            merged = concat_blocks(carry)
            head = merged.slice(0, batch_size)
            tail = merged.slice(batch_size)
            yield _emit(head, batch_format)
            carry = [tail] if tail.num_rows else []
            carry_rows = tail.num_rows
    if carry_rows and not drop_last:
        yield _emit(concat_blocks(carry), batch_format)


class DataIterator:
    """Iteration facade handed to Train workers (ray parity:
    DataIterator / iterator.py)."""

    def __init__(self, source):
        self._source = source  # Dataset or _SplitStream

    def _bundles(self):
        if hasattr(self._source, "iter_bundles"):
            return self._source.iter_bundles()
        return iter(self._source)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: int = 1, **_ignored) -> Iterator[Any]:
        return iter_batches_over(
            self._bundles(), batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
            shuffle_buffer_size=local_shuffle_buffer_size,
            shuffle_seed=local_shuffle_seed,
        )

    def _iter_mapped_batches(self, convert, *, batch_size, **kwargs):
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy", **kwargs):
            if isinstance(batch, dict):
                yield {k: convert(k, v) for k, v in batch.items()}
            else:
                yield convert(None, batch)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device: Optional[str] = None,
                           **kwargs) -> Iterator[Any]:
        """Batches as torch tensors (ray parity: iter_torch_batches) —
        dict of tensors for tabular data, a single tensor for simple
        blocks. ``dtypes``: torch dtype or {column: dtype}."""
        import numpy as np
        import torch

        def convert(col, arr):
            arr = np.asarray(arr)
            if not arr.flags.writeable:
                # zero-copy view of the object store: a tensor sharing
                # it would make in-place train-loop ops corrupt the store
                arr = arr.copy()
            t = torch.as_tensor(arr)
            want = dtypes.get(col) if isinstance(dtypes, dict) else dtypes
            if want is not None:
                t = t.to(want)
            if device:
                t = t.to(device)
            return t

        return self._iter_mapped_batches(convert, batch_size=batch_size,
                                         **kwargs)

    def iter_rows(self) -> Iterator[Any]:
        import ray_tpu_torch

        for ref, _m in self._bundles():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def materialize(self):
        from ray_tpu_torch.data.dataset import Dataset

        return Dataset.from_bundles(list(self._bundles()))


class _SplitCoordinator:
    """Actor: executes the dataset and hands out blocks to n consumers on
    demand. Re-executes the dataset for every epoch — a consumer that
    starts iterating again (epoch e+1) triggers a fresh pump once the
    previous epoch is fully drained, matching the reference's per-epoch
    streaming_split semantics. ``equal=True`` gives every consumer exactly
    the same row count (boundary blocks are sliced)."""

    def __init__(self, dataset, n: int, equal: bool):
        self._dataset = dataset
        self._n = n
        self._equal = equal
        self._queues = [collections.deque() for _ in range(n)]
        self._epoch = 0
        self._done = False
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        try:
            if self._equal:
                splits = self._dataset.split(self._n, equal=True)
                for i, part in enumerate(splits):
                    for item in part.iter_bundles():
                        with self._cv:
                            self._queues[i].append(item)
                            self._cv.notify_all()
            else:
                i = 0
                for item in self._dataset.iter_bundles():
                    with self._cv:
                        self._queues[i % self._n].append(item)
                        i += 1
                        self._cv.notify_all()
        finally:
            with self._cv:
                self._done = True
                self._cv.notify_all()

    def next(self, consumer: int, epoch: int):
        """Next (ref, meta) of ``epoch`` for this consumer; None at the
        epoch's end. Asking for a later epoch restarts execution once the
        current epoch is drained."""
        with self._cv:
            while True:
                if epoch < self._epoch:
                    return None  # that epoch is over
                if epoch == self._epoch:
                    if self._queues[consumer]:
                        return self._queues[consumer].popleft()
                    if self._done:
                        return None
                else:  # epoch > self._epoch: previous epoch must finish
                    # a consumer moving on abandons its own leftovers
                    # (early break mid-epoch must not deadlock the advance)
                    self._queues[consumer].clear()
                    if self._done and not any(self._queues):
                        self._epoch = epoch
                        self._done = False
                        self._thread = threading.Thread(
                            target=self._pump, daemon=True
                        )
                        self._thread.start()
                        continue
                self._cv.wait(timeout=1.0)


class _SplitStream:
    """Iterable over one consumer's share of a streaming split. Each
    ``iter()`` is one epoch: the coordinator re-runs the dataset."""

    def __init__(self, coordinator, idx: int):
        self._coord = coordinator
        self._idx = idx
        self._epoch = -1

    def __iter__(self):
        import ray_tpu_torch

        self._epoch += 1
        while True:
            item = ray_tpu_torch.get(
                self._coord.next.remote(self._idx, self._epoch)
            )
            if item is None:
                return
            yield item


def build_streaming_split(dataset, n: int, *, equal: bool = False
                          ) -> List[DataIterator]:
    import ray_tpu_torch

    coord_cls = ray_tpu_torch.remote(num_cpus=0)(_SplitCoordinator)
    coord = coord_cls.remote(dataset, n, equal)
    return [DataIterator(_SplitStream(coord, i)) for i in range(n)]
