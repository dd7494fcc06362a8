"""Dataset: lazy, distributed, columnar-blocked data pipelines.

Reference parity: ray python/ray/data/dataset.py (5.2k LoC facade) — same
user surface (map_batches/filter/groupby/sort/random_shuffle/repartition/
iter_batches/streaming_split/write_*), rebuilt over this package's logical
plan + streaming executor instead of the reference's physical-operator tree.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np

from ray_tpu_torch.data import datasource as ds
from ray_tpu_torch.data._internal import executor as X
from ray_tpu_torch.data._internal import logical as L
from ray_tpu_torch.data.block import (
    VALUE_COL,
    Block,
    BlockAccessor,
    BlockMetadata,
    DelegatingBlockBuilder,
    Schema,
    Table,
    concat_blocks,
    rows_to_block,
)


def _row_fn_to_block_fn(fn: Callable, kind: str,
                        fn_args=None, fn_kwargs=None) -> Callable:
    """Lift a per-row UDF into a per-block transform."""
    fn_args = fn_args or ()
    fn_kwargs = fn_kwargs or {}

    def block_fn(block: Block) -> Block:
        acc = BlockAccessor(block)
        builder = DelegatingBlockBuilder()
        for row in acc.iter_rows():
            if kind == "map":
                builder.add(fn(row, *fn_args, **fn_kwargs))
            elif kind == "flat_map":
                for out in fn(row, *fn_args, **fn_kwargs):
                    builder.add(out)
            elif kind == "filter":
                if fn(row, *fn_args, **fn_kwargs):
                    builder.add(row)
        out = builder.build()
        # keep schema for empty outputs
        return out if out.num_rows or not block.num_rows else block.slice(0, 0)

    return block_fn


def _batch_fn_to_block_fn(fn: Callable, batch_size: Optional[int],
                          batch_format: str, fn_args=None, fn_kwargs=None,
                          zero_copy: bool = False) -> Callable:
    from ray_tpu_torch.data.block import _to_table

    fn_args = fn_args or ()
    fn_kwargs = fn_kwargs or {}

    def block_fn(block: Block) -> Block:
        acc = BlockAccessor(block)
        n = acc.num_rows()
        outs = []
        step = batch_size or max(n, 1)
        for start in range(0, max(n, 1), step):
            sub = BlockAccessor(acc.slice(start, min(start + step, n)))
            batch = sub.to_batch(batch_format)
            out = fn(batch, *fn_args, **fn_kwargs)
            outs.append(_to_table(out))
            if n == 0:
                break
        return concat_blocks(outs)

    return block_fn


class Dataset:
    """A lazy pipeline of blocks. All transforms return a new Dataset."""

    def __init__(self, dag: L.LogicalOp):
        self._dag = dag
        self._cached: Optional[List[X.RefBundle]] = None
        self._exec_stats = None  # ExecStats from the last execution

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @staticmethod
    def from_read_tasks(tasks: List[ds.ReadTask], parallelism: int) -> "Dataset":
        return Dataset(L.Read(tasks, parallelism))

    @staticmethod
    def from_bundles(bundles: List[X.RefBundle]) -> "Dataset":
        refs = [r for r, _ in bundles]
        metas = [m for _, m in bundles]
        d = Dataset(L.InputData(refs, metas))
        d._cached = list(bundles)
        return d

    def _plan(self) -> L.LogicalPlan:
        return L.LogicalPlan(self._dag)

    # ------------------------------------------------------------------
    # transforms (lazy)
    # ------------------------------------------------------------------
    def map(self, fn: Callable, *, compute=None, fn_args=None, fn_kwargs=None,
            num_cpus: Optional[float] = None, concurrency=None, **_ignored
            ) -> "Dataset":
        return self._add_map("Map", _row_fn_to_block_fn(fn, "map", fn_args,
                                                        fn_kwargs),
                             fn, compute, concurrency, num_cpus)

    def flat_map(self, fn: Callable, *, compute=None, concurrency=None,
                 num_cpus: Optional[float] = None, **_ignored) -> "Dataset":
        return self._add_map("FlatMap",
                             _row_fn_to_block_fn(fn, "flat_map"),
                             fn, compute, concurrency, num_cpus)

    def filter(self, fn: Callable, *, compute=None, concurrency=None,
               num_cpus: Optional[float] = None, **_ignored) -> "Dataset":
        return self._add_map("Filter", _row_fn_to_block_fn(fn, "filter"),
                             fn, compute, concurrency, num_cpus)

    def map_batches(self, fn: Union[Callable, type], *,
                    batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    compute=None, concurrency=None,
                    fn_args=None, fn_kwargs=None,
                    fn_constructor_args=None, fn_constructor_kwargs=None,
                    num_cpus: Optional[float] = None,
                    zero_copy_batch: bool = False, **_ignored) -> "Dataset":
        if isinstance(fn, type):
            # Stateful callable class -> actor pool.
            ctor_args = fn_constructor_args or ()
            ctor_kwargs = fn_constructor_kwargs or {}
            n = concurrency or 1
            if isinstance(n, (tuple, list)):
                n = n[-1]
            cls = fn

            def fn_factory():
                inst = cls(*ctor_args, **ctor_kwargs)
                return _batch_fn_to_block_fn(
                    inst, batch_size, batch_format, fn_args, fn_kwargs
                )

            op = L.MapBlocks(
                "MapBatches(actors)", self._dag, fn_factory,
                compute=("actors", int(n)),
                resources={"CPU": num_cpus} if num_cpus else {},
            )
            return Dataset(op)
        block_fn = _batch_fn_to_block_fn(fn, batch_size, batch_format,
                                         fn_args, fn_kwargs, zero_copy_batch)
        return self._add_map("MapBatches", block_fn, fn, compute, concurrency,
                             num_cpus)

    def _add_map(self, name, block_fn, fn, compute, concurrency, num_cpus
                 ) -> "Dataset":
        if compute is not None or (concurrency and not callable(fn)):
            pass  # actor compute only via class UDFs (map_batches)
        op = L.MapBlocks(
            name, self._dag, block_fn, compute=None,
            resources={"CPU": num_cpus} if num_cpus else {},
        )
        return Dataset(op)

    # -- column ops ----------------------------------------------------
    def add_column(self, name: str, fn: Callable, **kw) -> "Dataset":
        def block_fn(block: Block) -> Block:
            import pandas as pd

            df = block.to_pandas()
            col = fn(df)
            if name in df.columns:
                df[name] = col
            else:
                df.insert(len(df.columns), name, col)
            return Table.from_pandas(df)

        return Dataset(L.MapBlocks("AddColumn", self._dag, block_fn))

    def drop_columns(self, cols: List[str], **kw) -> "Dataset":
        return Dataset(L.MapBlocks(
            "DropColumns", self._dag, lambda b: BlockAccessor(b).drop(cols)
        ))

    def select_columns(self, cols: List[str], **kw) -> "Dataset":
        return Dataset(L.MapBlocks(
            "SelectColumns", self._dag, lambda b: BlockAccessor(b).select(cols)
        ))

    def rename_columns(self, mapping: Dict[str, str], **kw) -> "Dataset":
        return Dataset(L.MapBlocks(
            "RenameColumns", self._dag, lambda b: BlockAccessor(b).rename(mapping)
        ))

    # -- all-to-all ----------------------------------------------------
    def repartition(self, num_blocks: int, *, shuffle: bool = False
                    ) -> "Dataset":
        def fn(bundles):
            if shuffle:
                def part(block, n):
                    shuffled = BlockAccessor(block).random_shuffle_indices(None)
                    return _round_robin_split(shuffled, n)

                return X.shuffle_exchange(bundles, num_blocks, part)
            return X.shuffle_exchange(bundles, num_blocks, _contiguous_split)

        return Dataset(L.AllToAll("Repartition", self._dag, fn))

    def random_shuffle(self, *, seed: Optional[int] = None, **kw) -> "Dataset":
        def fn(bundles):
            n = max(len(bundles), 1)

            def part(block, n_out, seed=seed):
                acc = BlockAccessor(block)
                shuffled = acc.random_shuffle_indices(seed)
                return _round_robin_split(shuffled, n_out)

            out = X.shuffle_exchange(bundles, n, part)
            # shuffle the reduce outputs' internal order too
            import ray_tpu_torch

            def reshuffle(block, seed=seed):
                return BlockAccessor(block).random_shuffle_indices(seed)

            rr = ray_tpu_torch.remote(num_returns=2)(
                lambda b: (lambda o: (o, BlockMetadata.for_block(o)))(reshuffle(b))
            )
            final = []
            for ref, _m in out:
                bref, mref = rr.remote(ref)
                final.append((bref, mref))
            return [(b, ray_tpu_torch.get(m)) for b, m in final]

        return Dataset(L.AllToAll("RandomShuffle", self._dag, fn))

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        def fn(bundles):
            rng = np.random.default_rng(seed)
            order = rng.permutation(len(bundles))
            return [bundles[i] for i in order]

        return Dataset(L.AllToAll("RandomizeBlockOrder", self._dag, fn))

    def sort(self, key: Union[str, List[str]], descending: bool = False
             ) -> "Dataset":
        key0 = key if isinstance(key, str) else key[0]

        def fn(bundles):
            import ray_tpu_torch

            if not bundles:
                return bundles
            n = len(bundles)
            # sample boundaries from first block
            first = ray_tpu_torch.get(bundles[0][0])
            bounds = BlockAccessor(first).sample_boundaries(key0, n)

            def part(block, n_out):
                acc = BlockAccessor(block)
                sorted_b = acc.sort_by(key, descending)
                parts = BlockAccessor(sorted_b).range_partition(
                    key0, bounds, descending
                )
                while len(parts) < n_out:
                    parts.append(sorted_b.slice(0, 0))
                return parts[:n_out]

            def red(parts):
                merged = concat_blocks(parts)
                return BlockAccessor(merged).sort_by(key, descending)

            out = X.shuffle_exchange(bundles, n, part, red)
            return out if not descending else out

        return Dataset(L.AllToAll("Sort", self._dag, fn))

    def groupby(self, key: Union[str, List[str]]):
        from ray_tpu_torch.data.grouped_data import GroupedData

        return GroupedData(self, [key] if isinstance(key, str) else list(key))

    def limit(self, n: int) -> "Dataset":
        return Dataset(L.Limit(self._dag, n))

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(L.Union([self._dag] + [o._dag for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return Dataset(L.Zip(self._dag, other._dag))

    # ------------------------------------------------------------------
    # execution / consumption
    # ------------------------------------------------------------------
    def _bundles(self) -> List[X.RefBundle]:
        if self._cached is None:
            from ray_tpu_torch.data.context import DataContext
            from ray_tpu_torch.data._internal.stats import ExecStats

            stats = ExecStats() if DataContext.get_current().enable_stats \
                else None
            self._cached = X.execute(self._plan(), stats=stats)
            self._exec_stats = stats
        return self._cached

    def iter_bundles(self) -> Iterator[X.RefBundle]:
        if self._cached is not None:
            return iter(self._cached)
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data._internal.stats import ExecStats

        stats = ExecStats() if DataContext.get_current().enable_stats \
            else None
        self._exec_stats = stats
        return X.execute_streaming(self._plan(), stats=stats)

    def materialize(self) -> "Dataset":
        out = Dataset.from_bundles(self._bundles())
        out._exec_stats = self._exec_stats  # stats survive materialization
        return out

    def count(self) -> int:
        return sum(m.num_rows for _, m in self._bundles())

    def num_blocks(self) -> int:
        return len(self._bundles())

    def size_bytes(self) -> int:
        return sum(m.size_bytes for _, m in self._bundles())

    def schema(self) -> Optional[Schema]:
        for _r, m in self._bundles():
            if m.schema is not None and len(m.schema) > 0:
                return m.schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def input_files(self) -> List[str]:
        out = []
        for _r, m in self._bundles():
            out.extend(m.input_files or [])
        return out

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        import ray_tpu_torch

        for ref, _m in self.iter_bundles():
            block = ray_tpu_torch.get(ref)
            for row in BlockAccessor(block).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self, limit: Optional[int] = None) -> List[Any]:
        rows = self.take(limit or 10**12)
        return rows

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy"):
        for b in self.iter_batches(batch_size=batch_size,
                                   batch_format=batch_format):
            return b
        raise ValueError("dataset is empty, cannot take a batch")

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[Any]:
        import ray_tpu_torch

        for ref, _m in self.iter_bundles():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: int = 1, **_ignored) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import iter_batches_over

        return iter_batches_over(
            self.iter_bundles(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            shuffle_buffer_size=local_shuffle_buffer_size,
            shuffle_seed=local_shuffle_seed,
        )

    def iterator(self):
        from ray_tpu_torch.data.iterator import DataIterator

        return DataIterator(self)

    def to_pandas(self, limit: Optional[int] = None):
        import ray_tpu_torch

        tables = [ray_tpu_torch.get(r) for r, _ in self._bundles()]
        t = concat_blocks(tables)
        if limit:
            t = t.slice(0, limit)
        return t.to_pandas()

    def to_arrow_refs(self) -> List[Any]:
        import ray_tpu_torch

        conv = ray_tpu_torch.remote(lambda b: BlockAccessor(b).to_arrow())
        return [conv.remote(r) for r, _ in self._bundles()]

    def to_numpy_refs(self) -> List[Any]:
        import ray_tpu_torch

        conv = ray_tpu_torch.remote(
            lambda b: BlockAccessor(b).to_batch("numpy")
        )
        return [conv.remote(r) for r, _ in self._bundles()]

    def unique(self, column: str) -> List[Any]:
        import ray_tpu_torch

        vals = set()
        for ref, _m in self.iter_bundles():
            col = ray_tpu_torch.get(ref).column(column)
            vals.update(col.tolist())
        return sorted(vals)

    # -- simple aggregates over a column --------------------------------
    def _col_agg(self, on: Optional[str], npfn) -> Any:
        import ray_tpu_torch

        on = on or VALUE_COL
        agg = ray_tpu_torch.remote(
            lambda b, c=on: npfn(np.asarray(b.column(c))) if b.num_rows else None
        )
        parts = [agg.remote(r) for r, _ in self._bundles()]
        vals = [v for v in ray_tpu_torch.get(parts) if v is not None]
        return npfn(np.asarray(vals)) if vals else None

    def sum(self, on: Optional[str] = None):
        import ray_tpu_torch

        on = on or VALUE_COL
        agg = ray_tpu_torch.remote(
            lambda b, c=on: float(np.asarray(b.column(c)).sum()) if b.num_rows else 0.0
        )
        return float(sum(ray_tpu_torch.get([agg.remote(r) for r, _ in self._bundles()])))

    def min(self, on: Optional[str] = None):
        return self._col_agg(on, np.min)

    def max(self, on: Optional[str] = None):
        return self._col_agg(on, np.max)

    def mean(self, on: Optional[str] = None):
        import ray_tpu_torch

        on = on or VALUE_COL
        agg = ray_tpu_torch.remote(
            lambda b, c=on: (float(np.asarray(b.column(c)).sum()), b.num_rows)
        )
        parts = ray_tpu_torch.get([agg.remote(r) for r, _ in self._bundles()])
        total = sum(p[0] for p in parts)
        n = sum(p[1] for p in parts)
        return total / n if n else None

    def std(self, on: Optional[str] = None, ddof: int = 1):
        import ray_tpu_torch

        on = on or VALUE_COL
        vals = []
        for ref, _m in self._bundles():
            vals.append(np.asarray(ray_tpu_torch.get(ref).column(on)))
        allv = np.concatenate(vals) if vals else np.array([])
        return float(np.std(allv, ddof=ddof)) if allv.size else None

    # -- splits ---------------------------------------------------------
    def split(self, n: int, *, equal: bool = False, locality_hints=None
              ) -> List["Dataset"]:
        bundles = self._bundles()
        if equal:
            return self._split_equal(n)
        groups: List[List[X.RefBundle]] = [[] for _ in range(n)]
        for i, b in enumerate(bundles):
            groups[i % n].append(b)
        return [Dataset.from_bundles(g) for g in groups]

    def _split_equal(self, n: int) -> List["Dataset"]:
        import ray_tpu_torch

        total = self.count()
        per = total // n
        splits, acc, need = [], [], per
        it = iter(self._bundles())
        carry = None
        for k in range(n):
            rows_needed = per
            group: List[X.RefBundle] = []
            while rows_needed > 0:
                if carry is not None:
                    ref, meta = carry
                    carry = None
                else:
                    try:
                        ref, meta = next(it)
                    except StopIteration:
                        break
                if meta.num_rows <= rows_needed:
                    group.append((ref, meta))
                    rows_needed -= meta.num_rows
                else:
                    block = ray_tpu_torch.get(ref)
                    head = BlockAccessor(block).slice(0, rows_needed)
                    tail = BlockAccessor(block).slice(rows_needed, meta.num_rows)
                    group.append(
                        (ray_tpu_torch.put(head), BlockMetadata.for_block(head))
                    )
                    carry = (ray_tpu_torch.put(tail), BlockMetadata.for_block(tail))
                    rows_needed = 0
            splits.append(Dataset.from_bundles(group))
        return splits

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        import ray_tpu_torch

        rows = self.take_all()
        bounds = [0] + list(indices) + [len(rows)]
        out = []
        for a, b in itertools.pairwise(bounds):
            chunk = rows[a:b]
            block = rows_to_block(chunk) if chunk else Table({})
            out.append(Dataset.from_bundles(
                [(ray_tpu_torch.put(block), BlockMetadata.for_block(block))]
            ))
        return out

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None) -> List["Dataset"]:
        d = self.random_shuffle(seed=seed) if shuffle else self
        n = d.count()
        k = int(n * (1 - test_size))
        mat = d.materialize()
        return mat.split_at_indices([k])

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List["Any"]:
        from ray_tpu_torch.data.iterator import build_streaming_split

        return build_streaming_split(self, n, equal=equal)

    # -- writes ---------------------------------------------------------
    def _write(self, writer, path: str, **kw) -> List[str]:
        import ray_tpu_torch

        w = ray_tpu_torch.remote(writer)
        refs = [
            w.remote(r, path, i, **kw)
            for i, (r, _m) in enumerate(self.iter_bundles())
        ]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str, **kw) -> None:
        self._write(ds.write_block_parquet, path, **kw)

    def write_csv(self, path: str, **kw) -> None:
        self._write(ds.write_block_csv, path, **kw)

    def write_json(self, path: str, **kw) -> None:
        self._write(ds.write_block_json, path, **kw)

    def write_numpy(self, path: str, *, column: str = "data", **kw) -> None:
        self._write(ds.write_block_numpy, path, column=column)

    # ------------------------------------------------------------------
    def stats(self) -> str:
        """Per-operator execution stats (ray parity: Dataset.stats() /
        _internal/stats.py DatasetStats summary). Covers both cached
        executions and drained streaming iterations (iter_bundles)."""
        bundles = self._cached
        if bundles is None:
            if self._exec_stats is not None and self._exec_stats.ops:
                return self._exec_stats.summary()
            return "(dataset not yet executed)"
        head = (
            f"Dataset: {len(bundles)} blocks, "
            f"{sum(m.num_rows for _, m in bundles)} rows, "
            f"{sum(m.size_bytes for _, m in bundles)} bytes"
        )
        if self._exec_stats is not None and self._exec_stats.ops:
            return head + "\n" + self._exec_stats.summary()
        return head

    def __repr__(self):
        name = self._dag.name
        if self._cached is not None:
            n = sum(m.num_rows for _, m in self._cached)
            return f"Dataset(op={name}, num_rows={n}, blocks={len(self._cached)})"
        return f"Dataset(op={name}, lazy)"


def _contiguous_split(block: Block, n: int) -> List[Block]:
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    per, rem = divmod(rows, n)
    out, start = [], 0
    for i in range(n):
        step = per + (1 if i < rem else 0)
        out.append(acc.slice(start, start + step))
        start += step
    return out


def _round_robin_split(block: Block, n: int) -> List[Block]:
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    return [acc.take(list(range(i, rows, n))) for i in range(n)]
