"""Read API: the ``ray_tpu_torch.data.read_* / from_*`` entry points
(ray parity: python/ray/data/read_api.py)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data import datasource as ds
from ray_tpu_torch.data.block import BlockMetadata, Table, _to_table
from ray_tpu_torch.data.dataset import Dataset

DEFAULT_PARALLELISM = 8


def _par(parallelism: int) -> int:
    return parallelism if parallelism and parallelism > 0 else DEFAULT_PARALLELISM


def range(n: int, *, parallelism: int = -1, **_kw) -> Dataset:  # noqa: A001
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.range_tasks(n, p), p)


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1,
                 **_kw) -> Dataset:
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.range_tensor_tasks(n, shape, p), p)


def from_items(items: List[Any], *, parallelism: int = -1, **_kw) -> Dataset:
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.items_tasks(items, p), p)


def read_parquet(paths, *, parallelism: int = -1,
                 columns: Optional[List[str]] = None, **_kw) -> Dataset:
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.parquet_tasks(paths, p, columns), p)


def read_csv(paths, *, parallelism: int = -1, **arrow_csv_kwargs) -> Dataset:
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.csv_tasks(paths, p, **arrow_csv_kwargs), p)


def read_json(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.json_tasks(paths, p), p)


def read_numpy(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.numpy_tasks(paths, p), p)


def read_binary_files(paths, *, include_paths: bool = False,
                      parallelism: int = -1, **_kw) -> Dataset:
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.binary_tasks(paths, p, include_paths), p)


def from_pandas(dfs, *, parallelism: int = -1) -> Dataset:
    import ray_tpu_torch

    if not isinstance(dfs, list):
        dfs = [dfs]
    bundles = []
    for df in dfs:
        t = Table.from_pandas(df)
        bundles.append((ray_tpu_torch.put(t), BlockMetadata.for_block(t)))
    return Dataset.from_bundles(bundles)


def from_numpy(arrays, *, column: str = "data", parallelism: int = -1) -> Dataset:
    import ray_tpu_torch

    if not isinstance(arrays, list):
        arrays = [arrays]
    bundles = []
    for arr in arrays:
        t = Table({column: arr})
        bundles.append((ray_tpu_torch.put(t), BlockMetadata.for_block(t)))
    return Dataset.from_bundles(bundles)


def from_arrow(tables, *, parallelism: int = -1) -> Dataset:
    import ray_tpu_torch

    if not isinstance(tables, list):
        tables = [tables]
    return from_blocks([Table.from_arrow(t) for t in tables])


def from_arrow_refs(refs: List[Any]) -> Dataset:
    """Refs to pyarrow Tables; each becomes a block in a task."""
    import ray_tpu_torch

    conv = ray_tpu_torch.remote(num_returns=2)(
        lambda t: (lambda b: (b, BlockMetadata.for_block(b)))(
            Table.from_arrow(t)))
    pairs = [conv.remote(r) for r in refs]
    return Dataset.from_bundles(
        [(b, ray_tpu_torch.get(m)) for b, m in pairs]
    )


def from_blocks(blocks: List[Any]) -> Dataset:
    """One block per entry, each put in the object store by the caller,
    with no task: a ``Table`` or a mapping of column name to array (N,
    ...). The counterpart of ``from_arrow`` that needs no pyarrow."""
    import ray_tpu_torch

    bundles = []
    for b in blocks:
        t = _to_table(b)
        bundles.append((ray_tpu_torch.put(t), BlockMetadata.for_block(t)))
    return Dataset.from_bundles(bundles)


def read_images(paths, *, size: Optional[tuple] = None,
                mode: Optional[str] = None, include_paths: bool = False,
                parallelism: int = -1, **_kw) -> Dataset:
    """ray parity: read_images (data/datasource/image_datasource.py)."""
    p = _par(parallelism)
    return Dataset.from_read_tasks(
        ds.image_tasks(paths, p, size=size, mode=mode,
                       include_paths=include_paths), p
    )


def read_tfrecords(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    """ray parity: read_tfrecords — tf.train.Example protos parsed without
    a tensorflow dependency."""
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.tfrecord_tasks(paths, p), p)


def read_webdataset(paths, *, parallelism: int = -1, **_kw) -> Dataset:
    """ray parity: read_webdataset — tar shards, one row per sample key."""
    p = _par(parallelism)
    return Dataset.from_read_tasks(ds.webdataset_tasks(paths, p), p)


def read_sql(sql: str, connection_factory, *, parallelism: int = -1,
             **_kw) -> Dataset:
    """ray parity: read_sql — any DB-API connection factory (sqlite3,
    psycopg2, ...)."""
    p = _par(parallelism)
    return Dataset.from_read_tasks(
        ds.sql_tasks(sql, connection_factory, p), p
    )


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline=None, parallelism: int = -1, **_kw) -> Dataset:
    """ray parity: read_mongo — _id-sliced partitioned read of a MongoDB
    collection; requires pymongo (clear error here if absent)."""
    p = _par(parallelism)
    return Dataset.from_read_tasks(
        ds.mongo_tasks(uri, database, collection, pipeline=pipeline,
                       parallelism=p), p
    )
