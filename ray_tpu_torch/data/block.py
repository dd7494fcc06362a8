"""Block layer: the unit of data a Dataset moves through the cluster.

A block is a ``Table``: the port's own columnar table, a mapping from
column name to a numpy array (N, ...) with every column N rows long. It
rides the shared-memory object store zero-copy on read, through pickle-5
out-of-band buffers. ``BlockAccessor`` bundles the per-block operations the
physical operators need.

Reference parity: ray python/ray/data/block.py (BlockAccessor),
_internal/arrow_block.py (ArrowBlockAccessor). The reference's block is a
``pyarrow.Table``; this one needs neither pyarrow nor pandas, so the core
Data path runs on a machine that has neither. A multi-dimensional column
keeps its per-row shape (what the reference's ``tensor_column`` does with
Arrow's fixed-shape tensor type). Strings and other Python objects are
``object`` columns, where ``None`` is null; float nulls are NaN.

pyarrow and pandas are imported only where a caller asks for them:
``Table.from_arrow`` / ``to_arrow``, ``from_pandas`` / ``to_pandas``, and
the batch formats "pyarrow" and "pandas".
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Union

import numpy as np

# Batches cross the user boundary in one of these shapes.
BatchFormat = ("pyarrow", "pandas", "numpy", "dict")

# Tables with a single unnamed value column (simple datasets: range(),
# from_items([1,2,3])) use this column name, like the reference's
# TENSOR_COLUMN_NAME / "item" convention.
VALUE_COL = "item"


def _loaded_instance(obj: Any, module: str, name: str) -> bool:
    """``isinstance(obj, module.name)`` without importing ``module``: an
    object of a type from a module no one imported cannot exist."""
    mod = sys.modules.get(module)
    return mod is not None and isinstance(obj, getattr(mod, name))


def column_from_values(values: Iterable[Any]) -> np.ndarray:
    """One column from per-row Python values, typed as ``pyarrow.array``
    would type them: bools, int64, float64 (ints and floats together, and
    ints with a ``None``, whose nulls become NaN), a stacked tensor column
    where every row is an ndarray of one shape and dtype, else ``object``
    (strings, bytes, lists, dicts; ``None`` stays ``None``)."""
    values = list(values)
    kinds = set()
    has_null = False
    for v in values:
        if v is None:
            has_null = True
        elif isinstance(v, (bool, np.bool_)):
            kinds.add("b")
        elif isinstance(v, (int, np.integer)):
            kinds.add("i")
        elif isinstance(v, (float, np.floating)):
            kinds.add("f")
        elif isinstance(v, np.ndarray) and v.dtype != object:
            kinds.add(("a", v.shape, v.dtype.str))
        else:
            kinds.add("o")
        if len(kinds) > 1 and not kinds <= {"i", "f"}:
            break
    if kinds == {"b"} and not has_null:
        return np.array(values, dtype=bool)
    if kinds == {"i"} and not has_null:
        return np.array(values, dtype=np.int64)
    if kinds and kinds <= {"i", "f"}:
        return np.array([np.nan if v is None else v for v in values],
                        dtype=np.float64)
    if len(kinds) == 1 and not has_null and isinstance(next(iter(kinds)),
                                                      tuple):
        return np.stack(values)
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _as_column(values: Any) -> np.ndarray:
    """A column from an array or a sequence: numpy arrays stay as they are
    (no copy), except fixed-width strings, which become ``object``."""
    if isinstance(values, np.ndarray):
        if values.ndim == 0:
            raise ValueError("a column needs one value per row, got a "
                             "0-d array")
        if values.dtype.kind in "US":
            return values.astype(object)
        return values
    if _loaded_instance(values, "pandas", "Series"):
        return _as_column(values.to_numpy())
    return column_from_values(values)


@dataclass(frozen=True)
class Schema:
    """A block's column names, numpy dtypes and per-row shapes (the
    reference returns ``pyarrow.Schema``)."""

    names: tuple
    types: tuple
    shapes: tuple

    def __len__(self) -> int:
        return len(self.names)


class Table(Mapping):
    """A columnar table: column name -> numpy array (N, ...), every column
    N rows long. Column order is insertion order. Row operations (slice,
    take, filter) return new tables; a slice is a view of the same
    memory."""

    __slots__ = ("_cols", "_n")

    def __init__(self, columns: Optional[Mapping[str, Any]] = None):
        cols = {str(k): _as_column(v) for k, v in (columns or {}).items()}
        lengths = {len(v) for v in cols.values()}
        if len(lengths) > 1:
            raise ValueError(
                "every column of a block must have the same length, got "
                + ", ".join(f"{k}: {len(v)}" for k, v in cols.items()))
        self._cols = cols
        self._n = lengths.pop() if lengths else 0

    @classmethod
    def _trusted(cls, cols: Dict[str, np.ndarray], n: int) -> "Table":
        t = cls.__new__(cls)
        t._cols, t._n = cols, n
        return t

    def __reduce__(self):
        # a dict of arrays: pickle-5 carries each array out of band
        return (Table._trusted, (self._cols, self._n))

    # -- mapping ---------------------------------------------------------
    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._cols)

    def __len__(self) -> int:
        return len(self._cols)

    def __repr__(self):
        return (f"Table(num_rows={self._n}, columns="
                f"{[(k, v.dtype.str, v.shape[1:]) for k, v in self._cols.items()]})")

    # -- the pyarrow.Table surface the executor uses ---------------------
    @property
    def num_rows(self) -> int:
        return self._n

    @property
    def column_names(self) -> List[str]:
        return list(self._cols)

    @property
    def nbytes(self) -> int:
        """Bytes of the column buffers (an ``object`` column counts its
        pointers, not the objects they point to)."""
        return sum(v.nbytes for v in self._cols.values())

    @property
    def schema(self) -> Schema:
        return Schema(tuple(self._cols),
                      tuple(v.dtype for v in self._cols.values()),
                      tuple(v.shape[1:] for v in self._cols.values()))

    def column(self, name: str) -> np.ndarray:
        return self._cols[name]

    def slice(self, offset: int = 0, length: Optional[int] = None) -> "Table":
        """Rows [offset, offset + length), as ``pyarrow.Table.slice``."""
        offset = min(max(offset, 0), self._n)
        end = self._n if length is None else min(offset + length, self._n)
        end = max(end, offset)
        return Table._trusted({k: v[offset:end] for k, v in self._cols.items()},
                              end - offset)

    def take(self, indices) -> "Table":
        idx = np.asarray(indices, dtype=np.int64)
        return Table._trusted({k: v[idx] for k, v in self._cols.items()},
                              len(idx))

    def filter(self, mask) -> "Table":
        mask = np.asarray(mask, dtype=bool)
        return Table._trusted({k: v[mask] for k, v in self._cols.items()},
                              int(mask.sum()))

    def select(self, columns: List[str]) -> "Table":
        return Table._trusted({c: self._cols[c] for c in columns}, self._n)

    def rename_columns(self, names: List[str]) -> "Table":
        return Table._trusted(dict(zip(names, self._cols.values())), self._n)

    def to_pylist(self) -> List[Dict[str, Any]]:
        """One dict a row: Python scalars from numeric columns, an ndarray
        a row from a tensor column, the objects of an ``object`` column."""
        cols = {k: (list(v) if v.ndim > 1 or v.dtype == object
                    else v.tolist()) for k, v in self._cols.items()}
        return [dict(zip(cols, row)) for row in zip(*cols.values())] \
            if cols else []

    # -- lazy bridges --------------------------------------------------
    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({k: (list(v) if v.ndim > 1 else v)
                             for k, v in self._cols.items()},
                            index=pd.RangeIndex(self._n))

    @classmethod
    def from_pandas(cls, df) -> "Table":
        cols = {}
        for name in df.columns:
            arr = df[name].to_numpy()
            # object columns: strings stay objects; rows of equal-shape
            # arrays (Concatenator's output) become a tensor column
            cols[name] = column_from_values(arr) if arr.dtype == object \
                else arr
        return cls(cols)

    def to_arrow(self):
        import pyarrow as pa

        cols = {}
        for k, v in self._cols.items():
            if v.ndim > 1:
                cols[k] = pa.FixedShapeTensorArray.from_numpy_ndarray(
                    np.ascontiguousarray(v))
            elif v.dtype == object:
                cols[k] = pa.array(list(v))
            else:
                cols[k] = pa.array(v)
        return pa.table(cols)

    @classmethod
    def from_arrow(cls, table) -> "Table":
        import pyarrow as pa

        cols = {}
        for name in table.column_names:
            col = table.column(name).combine_chunks()
            if isinstance(col.type, pa.FixedShapeTensorType):
                cols[name] = col.to_numpy_ndarray()
            elif (pa.types.is_integer(col.type) or
                  pa.types.is_floating(col.type) or
                  pa.types.is_boolean(col.type)):
                cols[name] = col.to_numpy(zero_copy_only=False)
            else:
                cols[name] = column_from_values(col.to_pylist())
        return cls(cols)


Block = Table


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Schema] = None
    input_files: Optional[List[str]] = None

    @staticmethod
    def for_block(block: Block, input_files: Optional[List[str]] = None
                  ) -> "BlockMetadata":
        return BlockMetadata(
            num_rows=block.num_rows,
            size_bytes=block.nbytes,
            schema=block.schema,
            input_files=input_files,
        )


def _to_table(batch: Any) -> Block:
    """Coerce any user-returned batch into a block."""
    if isinstance(batch, Table):
        return batch
    if batch is None:
        return Table({})
    if _loaded_instance(batch, "pandas", "DataFrame"):
        return Table.from_pandas(batch)
    if _loaded_instance(batch, "pyarrow", "Table"):
        return Table.from_arrow(batch)
    if isinstance(batch, dict):
        return Table(batch)
    if isinstance(batch, list):
        return rows_to_block(batch)
    raise TypeError(f"cannot convert batch of type {type(batch)} to a block")


def rows_to_block(rows: List[Any]) -> Block:
    """Build a block from a list of rows (dicts or bare values)."""
    if rows and isinstance(rows[0], dict):
        cols: Dict[str, list] = {k: [] for k in rows[0]}
        for r in rows:
            for k in cols:
                cols[k].append(r.get(k))
        return Table({k: column_from_values(v) for k, v in cols.items()})
    return Table({VALUE_COL: column_from_values(rows)})


def _concat_column(parts: List[Optional[np.ndarray]], lengths: List[int]
                   ) -> np.ndarray:
    """Concatenate one column over blocks; a block without it contributes
    nulls (NaN where every present part is floating, else ``None``)."""
    present = [p for p in parts if p is not None]
    floating = all(p.dtype.kind == "f" for p in present)
    filled = []
    for p, n in zip(parts, lengths):
        if p is None:
            p = np.full((n,) + present[0].shape[1:], np.nan) if floating \
                else np.full(n, None, dtype=object)
        filled.append(p)
    return np.concatenate(filled)


def concat_blocks(blocks: List[Block]) -> Block:
    """Concatenate rows; columns are the union of the blocks' in order of
    first appearance, as Arrow's schema-promoting concat."""
    blocks = [b for b in blocks if b is not None and b.num_rows > 0]
    if not blocks:
        return Table({})
    if len(blocks) == 1:
        return blocks[0]
    names = list(dict.fromkeys(c for b in blocks for c in b.column_names))
    lengths = [b.num_rows for b in blocks]
    return Table._trusted(
        {c: _concat_column([b._cols.get(c) for b in blocks], lengths)
         for c in names}, sum(lengths))


def _sort_ranks(col: np.ndarray) -> np.ndarray:
    """Each row's rank among the column's distinct values (ascending)."""
    _, inverse = np.unique(col, return_inverse=True)
    return inverse.reshape(-1)


class BlockAccessor:
    """Operations over one block (ray parity: data/block.py BlockAccessor)."""

    def __init__(self, block: Block):
        self._t = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # -- shape ---------------------------------------------------------
    def num_rows(self) -> int:
        return self._t.num_rows

    def size_bytes(self) -> int:
        return self._t.nbytes

    def schema(self) -> Schema:
        return self._t.schema

    def metadata(self) -> BlockMetadata:
        return BlockMetadata.for_block(self._t)

    # -- conversions ---------------------------------------------------
    def to_arrow(self):
        return self._t.to_arrow()

    def to_pandas(self):
        return self._t.to_pandas()

    def to_numpy(self, columns: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
        cols = columns or self._t.column_names
        return {c: self._t.column(c) for c in cols}

    def to_batch(self, batch_format: str):
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("numpy", "dict"):
            out = self.to_numpy()
            if batch_format == "numpy" and set(out) == {VALUE_COL}:
                return out[VALUE_COL]
            return out
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def iter_rows(self) -> Iterable[Any]:
        simple = self._t.column_names == [VALUE_COL]
        for chunk in self._t.to_pylist():
            yield chunk[VALUE_COL] if simple else chunk

    # -- slicing -------------------------------------------------------
    def slice(self, start: int, end: int) -> Block:
        return self._t.slice(start, end - start)

    def take(self, indices: List[int]) -> Block:
        return self._t.take(indices)

    def select(self, columns: List[str]) -> Block:
        return self._t.select(columns)

    def drop(self, columns: List[str]) -> Block:
        keep = [c for c in self._t.column_names if c not in columns]
        return self._t.select(keep)

    def rename(self, mapping: Dict[str, str]) -> Block:
        names = [mapping.get(c, c) for c in self._t.column_names]
        return self._t.rename_columns(names)

    # -- compute -------------------------------------------------------
    def sort_by(self, key: Union[str, List[str]], descending: bool = False) -> Block:
        """Stable sort on one or more keys, as Arrow's ``sort_by``: the
        first key decides, ties keep their order."""
        keys = [key] if isinstance(key, str) else list(key)
        if self._t.num_rows == 0:
            return self._t
        ranks = [_sort_ranks(self._t.column(k)) for k in keys]
        if descending:
            ranks = [-r for r in ranks]
        return self._t.take(np.lexsort(ranks[::-1]))

    def sample_boundaries(self, key: str, n: int) -> List[Any]:
        """Sample n-1 split points for range partitioning."""
        col = np.asarray(self._t.column(key))
        if len(col) == 0 or n <= 1:
            return []
        qs = np.linspace(0, 1, n + 1)[1:-1]
        return list(np.quantile(col, qs, method="nearest"))

    def range_partition(self, key: str, boundaries: List[Any],
                        descending: bool = False) -> List[Block]:
        """Split into len(boundaries)+1 blocks by key ranges."""
        if not boundaries:
            return [self._t]
        col = np.asarray(self._t.column(key))
        idx = np.searchsorted(np.asarray(boundaries), col, side="right")
        if descending:
            idx = len(boundaries) - idx
        return [self._t.filter(idx == p)
                for p in range(len(boundaries) + 1)]

    def hash_partition(self, key: Union[str, List[str]], n: int) -> List[Block]:
        if n <= 1:
            return [self._t]
        import zlib

        keys = [key] if isinstance(key, str) else list(key)
        h = np.zeros(self._t.num_rows, dtype=np.uint64)
        for k in keys:
            vals = self._t.column(k).tolist()
            # crc32 of the value repr: deterministic ACROSS PROCESSES —
            # builtin hash() is salted per interpreter, which would split
            # one group over several partitions when map tasks run in
            # different workers.
            h = h * np.uint64(1000003) + np.array(
                [zlib.crc32(repr(v).encode()) for v in vals],
                dtype=np.uint64,
            )
        part = (h % np.uint64(n)).astype(np.int64)
        return [self._t.filter(part == p) for p in range(n)]

    def random_shuffle_indices(self, seed: Optional[int]) -> Block:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self._t.num_rows)
        return self._t.take(perm)

    # -- aggregation helpers -------------------------------------------
    def group_keys(self, keys: List[str]) -> List[tuple]:
        cols = [self._t.column(k).tolist() for k in keys]
        return list(dict.fromkeys(zip(*cols))) if cols else []

    def filter_by_key(self, keys: List[str], value: tuple) -> Block:
        mask = np.ones(self._t.num_rows, dtype=bool)
        for k, v in zip(keys, value):
            mask &= np.asarray(self._t.column(k) == v, dtype=bool)
        return self._t.filter(mask)


class DelegatingBlockBuilder:
    """Accumulate rows / batches into output blocks capped at a target size
    (ray parity: _internal/delegating_block_builder.py)."""

    def __init__(self, target_rows: Optional[int] = None):
        self._rows: List[Any] = []
        self._tables: List[Block] = []
        self._target = target_rows

    def add(self, row: Any):
        self._rows.append(row)

    def add_batch(self, batch: Any):
        self._flush_rows()
        self._tables.append(_to_table(batch))

    def _flush_rows(self):
        if self._rows:
            self._tables.append(rows_to_block(self._rows))
            self._rows = []

    def num_rows(self) -> int:
        return sum(t.num_rows for t in self._tables) + len(self._rows)

    def build(self) -> Block:
        self._flush_rows()
        return concat_blocks(self._tables)
