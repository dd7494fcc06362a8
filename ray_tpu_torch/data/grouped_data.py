"""GroupedData: groupby aggregations and map_groups.

Reference parity: ray python/ray/data/grouped_data.py + data/aggregate/ —
hash-partition exchange then per-partition grouped reduction.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from ray_tpu_torch.data._internal import executor as X
from ray_tpu_torch.data._internal import logical as L
from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    BlockMetadata,
    DelegatingBlockBuilder,
    concat_blocks,
)

_AGG_FNS = {
    "sum": np.sum,
    "min": np.min,
    "max": np.max,
    "mean": np.mean,
    "std": lambda a: np.std(a, ddof=1),
    "count": len,
}


class GroupedData:
    def __init__(self, dataset, keys: List[str]):
        self._ds = dataset
        self._keys = keys

    # ------------------------------------------------------------------
    def _exchange(self, per_group_fn: Callable[[tuple, Block], Any]):
        """Hash-partition by key, then apply per_group_fn to each group."""
        keys = self._keys

        def fn(bundles):
            if not bundles:
                return bundles
            n = len(bundles)

            def part(block, n_out):
                return BlockAccessor(block).hash_partition(keys, n_out)

            def red(parts):
                merged = concat_blocks(parts)
                if merged.num_rows == 0:
                    return merged
                acc = BlockAccessor(merged)
                builder = DelegatingBlockBuilder()
                for gk in acc.group_keys(keys):
                    sub = acc.filter_by_key(keys, gk)
                    out = per_group_fn(gk, sub)
                    if isinstance(out, list):
                        for r in out:
                            builder.add(r)
                    elif isinstance(out, dict):
                        builder.add(out)
                    else:
                        builder.add_batch(out)
                return builder.build()

            return X.shuffle_exchange(bundles, n, part, red)

        from ray_tpu_torch.data.dataset import Dataset

        return Dataset(L.AllToAll("Aggregate", self._ds._dag, fn))

    # ------------------------------------------------------------------
    def aggregate(self, **named: Dict[str, tuple]):
        """aggregate(out_col=("in_col", "sum"), ...)"""
        keys = self._keys
        specs = dict(named)

        def per_group(gk, sub: Block):
            row = {k: v for k, v in zip(keys, gk)}
            for out_col, (in_col, how) in specs.items():
                col = np.asarray(sub.column(in_col))
                row[out_col] = _AGG_FNS[how](col) if len(col) else None
            return row

        return self._exchange(per_group)

    def _simple(self, how: str, on: Union[str, List[str], None]):
        keys = self._keys

        def per_group(gk, sub: Block):
            row = {k: v for k, v in zip(keys, gk)}
            cols = (
                [on] if isinstance(on, str)
                else on if on
                else [c for c in sub.column_names if c not in keys]
            )
            for c in cols:
                arr = np.asarray(sub.column(c))
                row[f"{how}({c})"] = (
                    _AGG_FNS[how](arr) if len(arr) else None
                )
            return row

        return self._exchange(per_group)

    def sum(self, on=None):
        return self._simple("sum", on)

    def min(self, on=None):
        return self._simple("min", on)

    def max(self, on=None):
        return self._simple("max", on)

    def mean(self, on=None):
        return self._simple("mean", on)

    def std(self, on=None):
        return self._simple("std", on)

    def count(self):
        keys = self._keys

        def per_group(gk, sub: Block):
            row = {k: v for k, v in zip(keys, gk)}
            row["count()"] = sub.num_rows
            return row

        return self._exchange(per_group)

    def map_groups(self, fn: Callable, *, batch_format: str = "pyarrow",
                   **_ignored):
        def per_group(gk, sub: Block):
            batch = BlockAccessor(sub).to_batch(batch_format)
            return fn(batch)

        return self._exchange(per_group)
