"""The port's Data (``ray_tpu_torch.data``) beside the reference's, on the
CPU.

One port cluster and one reference cluster run for the whole module. Every
case of ``tests/test_data.py`` runs the same program through both packages
(``_both``), and where the outcome is deterministic the two results are
held equal, after both are turned into plain Python values (the reference's
come out of Arrow scalars, the port's out of numpy). Where the reference
case checks ``iter_jax_batches`` with a sharding, the port's checks
``iter_torch_batches(device=...)``; where it runs a ``DataParallelTrainer``
the port runs a ``TorchTrainer`` over 2 gloo workers.

Then the seams: the port's blocks are its own numpy tables, not
``pyarrow.Table`` s (``Table`` against Arrow on typing, nulls, sort, concat
and the hash partition; zero-copy through the object store), the core path
runs in a process where neither pyarrow nor pandas can be imported, a
``map_batches`` actor leases CPUs only and sees the card as the driver
does, and ``from_blocks`` makes a Dataset with no task. Programs are
defined inside the tests so they travel to the workers by value.
"""

import importlib
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=4)
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _py(x):
    """Plain Python values: numpy scalars and arrays become numbers and
    lists, tuples lists."""
    if isinstance(x, dict):
        return {k: _py(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_py(v) for v in x]
    if isinstance(x, np.ndarray):
        return _py(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def _both(program, *args):
    """``program(data, *args)`` through the reference, then the port; the
    port's result after asserting that both are equal."""
    ref = program(importlib.import_module("ray_tpu.data"), *args)
    got = program(importlib.import_module("ray_tpu_torch.data"), *args)
    assert _py(got) == _py(ref)
    return got


# ---------------------------------------------------------------------------
# the cases of tests/test_data.py
# ---------------------------------------------------------------------------

def test_range_count_take(clusters):
    def program(data):
        d = data.range(100, parallelism=4)
        return [d.count(), d.num_blocks(), d.take(5), d.sum(), d.min(),
                d.max(), d.mean()]

    assert _py(_both(program)) == [100, 4, [0, 1, 2, 3, 4], 4950.0, 0, 99,
                                   49.5]


def test_from_items_rows(clusters):
    def program(data):
        d = data.from_items([{"a": i} for i in range(10)], parallelism=2)
        return [d.count(), d.columns(), d.take(2)]

    assert _both(program) == [10, ["a"], [{"a": 0}, {"a": 1}]]


def test_map_filter_flatmap_fusion(clusters):
    def program(data):
        d = (
            data.range(20, parallelism=2)
            .map(lambda x: x + 1)
            .filter(lambda x: x % 2 == 0)
            .flat_map(lambda x: [x, -x])
        )
        return [d._plan().optimized().dag.name, d.take_all()]

    name, rows = _both(program)
    assert "->" in name
    assert rows[:4] == [2, -2, 4, -4]
    assert len(rows) == 20


def test_map_batches_formats(clusters):
    def program(data):
        d = data.range(10, parallelism=2)
        out = d.map_batches(lambda b: {"x": b * 2}, batch_format="numpy")
        out2 = d.map_batches(lambda df: df, batch_format="pandas")
        out3 = d.map_batches(lambda t: t, batch_format="pyarrow")
        return [out.take(3), out2.count(), out3.count(), out2.take_all(),
                out3.take_all()]

    got = _both(program)
    assert got[:3] == [[{"x": 0}, {"x": 2}, {"x": 4}], 10, 10]


def test_map_batches_actor_pool(clusters):
    def program(data):
        class Doubler:
            def __init__(self, k=2):
                self.k = k

            def __call__(self, batch):
                return {"x": batch * self.k}

        d = data.range(12, parallelism=3).map_batches(
            Doubler, concurrency=2, fn_constructor_kwargs={"k": 3},
            batch_format="numpy",
        )
        return d.take_all()

    rows = _both(program)
    assert sorted(r["x"] for r in rows) == [i * 3 for i in range(12)]


def test_groupby_aggregations(clusters):
    def program(data):
        d = data.from_items(
            [{"k": i % 3, "v": float(i)} for i in range(30)], parallelism=3
        )
        return [d.groupby("k").count().take_all(),
                d.groupby("k").mean("v").take_all(),
                d.groupby("k").aggregate(s=("v", "sum"),
                                         m=("v", "max")).take_all()]

    counts, means, _ = _both(program)
    assert {r["k"]: r["count()"] for r in counts} == {0: 10, 1: 10, 2: 10}
    means = {r["k"]: r["mean(v)"] for r in means}
    assert means[0] == np.mean([i for i in range(30) if i % 3 == 0])


def test_groupby_map_groups(clusters):
    def program(data):
        d = data.from_items([{"k": i % 2, "v": i} for i in range(10)],
                            parallelism=2)
        out = d.groupby("k").map_groups(
            lambda t: [{"k": t.column("k")[0].as_py(), "n": t.num_rows}]
        )
        # a dict back is one row
        nump = d.groupby("k").map_groups(
            lambda b: {"k": int(b["k"][0]), "s": int(b["v"].sum())},
            batch_format="numpy")
        return [sorted(out.take_all(), key=lambda r: r["k"]),
                sorted(nump.take_all(), key=lambda r: r["k"])]

    rows, sums = _both(program)
    assert rows == [{"k": 0, "n": 5}, {"k": 1, "n": 5}]
    assert sums == [{"k": 0, "s": 20}, {"k": 1, "s": 25}]


def test_sort(clusters):
    def program(data):
        d = data.from_items([{"a": (7 * i) % 20, "i": i} for i in range(20)],
                            parallelism=4)
        return [d.sort("a").take_all(),
                d.sort("a", descending=True).take_all()]

    asc, desc = _both(program)
    asc = [r["a"] for r in asc]
    desc = [r["a"] for r in desc]
    assert asc == sorted(asc)
    assert desc == sorted(desc, reverse=True)


def test_random_shuffle_and_repartition(clusters):
    def program(data):
        d = data.range(50, parallelism=5)
        rep = d.repartition(2)
        return [d.random_shuffle(seed=7).take_all(), rep.num_blocks(),
                rep.count(), rep.take_all()]

    vals, blocks, count, _ = _both(program)
    assert sorted(vals) == list(range(50))
    assert vals != list(range(50))
    assert blocks == 2 and count == 50


def test_limit_union_zip(clusters):
    def program(data):
        d = data.range(100, parallelism=4)
        z = data.range(5).zip(data.range(5).map(lambda x: x * 10))
        return [d.limit(7).take_all(), d.union(data.range(5)).count(),
                z.take_all()]

    limited, count, zipped = _both(program)
    assert limited == list(range(7)) and count == 105
    assert zipped == [{"item": i, "item_1": i * 10} for i in range(5)]


def test_iter_batches_rebatching(clusters):
    def program(data):
        d = data.range(100, parallelism=7)  # uneven blocks
        return [[len(b) for b in d.iter_batches(batch_size=32)],
                [len(b) for b in d.iter_batches(batch_size=32,
                                                drop_last=True)],
                [b.tolist() for b in d.iter_batches(batch_size=32)]]

    sizes, dropped, _ = _both(program)
    assert sizes == [32, 32, 32, 4]
    assert dropped == [32, 32, 32]


def test_split_and_streaming_split(clusters):
    def program(data):
        d = data.range(30, parallelism=6)
        parts = d.split(3)
        eq = d.split(3, equal=True)
        got = []
        for it in d.streaming_split(2):
            for batch in it.iter_batches(batch_size=None):
                got.extend(np.asarray(batch).tolist())
        return [[p.take_all() for p in parts], [p.count() for p in eq],
                sorted(got)]

    parts, eq, got = _both(program)
    assert sum(len(p) for p in parts) == 30
    assert eq == [10, 10, 10]
    assert got == list(range(30))


def test_parquet_roundtrip(clusters, tmp_path):
    def program(data, root):
        d = data.from_items([{"a": i, "b": str(i)} for i in range(25)],
                            parallelism=3)
        out = str(root / data.__name__ / "pq")
        d.write_parquet(out)
        back = data.read_parquet(out)
        return [back.count(), sorted(back.take_all(), key=lambda r: r["a"])]

    count, rows = _both(program, tmp_path)
    assert count == 25
    assert [r["a"] for r in rows] == list(range(25))
    assert rows[3] == {"a": 3, "b": "3"}


def test_csv_json_roundtrip(clusters, tmp_path):
    def program(data, root):
        d = data.from_items([{"a": i, "b": i * 0.5} for i in range(10)],
                            parallelism=2)
        csv_dir = str(root / data.__name__ / "csv")
        d.write_csv(csv_dir)
        json_dir = str(root / data.__name__ / "json")
        d.write_json(json_dir)
        back = data.read_json(json_dir)
        return [data.read_csv(csv_dir).take_all(), back.count(),
                sorted(back.take_all(), key=lambda r: r["a"])]

    csv_rows, count, rows = _both(program, tmp_path)
    assert len(csv_rows) == 10 and count == 10
    assert {r["a"] for r in rows} == set(range(10))


def test_from_pandas_numpy_arrow(clusters):
    import pandas as pd
    import pyarrow as pa

    def program(data):
        df = pd.DataFrame({"x": [1, 2, 3]})
        return [data.from_pandas(df).count(),
                data.from_numpy(np.arange(5)).count(),
                data.from_arrow(pa.table({"y": [1, 2]})).count(),
                data.from_pandas(df).to_pandas()["x"].tolist(),
                data.from_numpy(np.arange(6).reshape(3, 2)).take_batch(3)]

    got = _both(program)
    assert got[:4] == [3, 5, 2, [1, 2, 3]]
    assert got[4]["data"].shape == (3, 2)


def test_column_ops(clusters):
    def program(data):
        d = data.from_items([{"a": i, "b": i * 2} for i in range(5)])
        out = d.add_column("c", lambda df: df["a"] + df["b"])
        return [out.take(1), out.select_columns(["c"]).columns(),
                out.drop_columns(["c"]).columns(),
                sorted(out.rename_columns({"a": "z"}).columns()),
                out.take_all()]

    got = _both(program)
    assert got[0] == [{"a": 0, "b": 0, "c": 0}]
    assert got[1] == ["c"] and got[2] == ["a", "b"]
    assert set(got[3]) == {"z", "b", "c"}


def test_unique_and_stats(clusters):
    def program(data):
        d = data.from_items([{"a": i % 4} for i in range(16)])
        return [d.unique("a"), "rows" in d.materialize().stats()]

    assert _both(program) == [[0, 1, 2, 3], True]


def test_train_test_split(clusters):
    def program(data):
        tr, te = data.range(100).train_test_split(test_size=0.25)
        return [tr.count(), te.count(), te.take_all()]

    tr, te, _ = _both(program)
    assert tr == 75 and te == 25


def test_dataset_with_trainer(clusters):
    """datasets= flows into workers via train.get_dataset_shard: the
    reference's ``DataParallelTrainer`` and the port's ``TorchTrainer``
    over 2 gloo workers (``BASELINE.json``'s "2 CPU workers")."""
    def make_loop(pkg):
        def loop(config):
            import importlib

            train = importlib.import_module(f"{pkg}.train")
            shard = train.get_dataset_shard("train")
            total = 0
            for batch in shard.iter_batches(batch_size=8):
                total += len(batch)
            train.report({"rows": total})
        return loop

    from ray_tpu import train as jtrain
    from ray_tpu_torch import data, train

    want = jtrain.DataParallelTrainer(
        make_loop("ray_tpu"),
        scaling_config=ray_tpu.air.ScalingConfig(num_workers=2),
        datasets={"train": ray_tpu.data.range(64, parallelism=4)},
    ).fit()
    result = train.TorchTrainer(
        make_loop("ray_tpu_torch"),
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False),
        datasets={"train": data.range(64, parallelism=4)},
    ).fit()
    assert want.error is None and result.error is None, result.error
    # each worker saw a disjoint share; the LAST report is kept per worker —
    # both workers' rows sum to the dataset size
    assert result.metrics["rows"] * 2 == 64
    assert result.metrics["rows"] == want.metrics["rows"]


def test_streaming_split_multi_epoch(clusters):
    """Each iter() over a split is one epoch; the coordinator re-executes
    (regression: second epoch silently yielded nothing)."""
    def program(data):
        its = data.range(12, parallelism=4).streaming_split(2, equal=True)
        epochs = []
        # epoch advance is a barrier: every consumer must drain its share
        # before the coordinator re-executes (lockstep train workers do).
        for _ in range(3):
            for it in its:
                rows = []
                for b in it.iter_batches(batch_size=None):
                    rows.extend(np.asarray(b).tolist())
                epochs.append(rows)
        return epochs

    epochs = _both(program)
    assert [len(r) for r in epochs] == [6] * 6
    # every epoch yields the same rows in the same order
    assert epochs[0::2] == [epochs[0]] * 3 and epochs[1::2] == [epochs[1]] * 3


def test_streaming_split_equal_rows(clusters):
    """equal=True slices boundary blocks so every consumer sees the same
    row count (regression: flag was ignored)."""
    def program(data):
        # 3 uneven blocks: 7, 2, 1 rows
        d = data.from_items(list(range(7))).union(
            data.from_items([7, 8]), data.from_items([9])
        ).materialize()
        counts = []
        for it in d.streaming_split(2, equal=True):
            counts.append(sum(len(b) for b in it.iter_batches(
                batch_size=None)))
        return counts

    assert _both(program) == [5, 5]


def test_sort_with_an_empty_range_partition(clusters):
    """Boundaries sampled from the first block can leave a partition with
    no row (here the string key "s2" under descending order). The
    reference's reduce then sorts a table with no columns and raises; the
    port's sorts the rows there are."""
    def make(data):
        return data.from_items([{"a": i, "s": f"s{i % 3}"}
                                for i in range(12)], parallelism=3)

    got = make(ray_tpu_torch.data).sort("s", descending=True).take_all()
    assert [r["s"] for r in got] == ["s2"] * 4 + ["s1"] * 4 + ["s0"] * 4
    assert sorted(r["a"] for r in got) == list(range(12))
    with pytest.raises(ray_tpu.TaskError, match="Invalid sort key"):
        make(ray_tpu.data).sort("s", descending=True).take_all()


def test_tensor_columns_preserve_shape(clusters):
    """Multi-dim ndarray columns round-trip with shape (regression: was
    flattened to (N, prod))."""
    def program(data):
        d = data.range(8, parallelism=2).map_batches(
            lambda b: {"img": np.ones((len(b), 4, 4), np.float32)
                       * b[:, None, None].astype(np.float32)},
            batch_format="numpy",
        )
        return [d.take_batch(8)["img"],
                data.range_tensor(6, shape=(2, 3)).take_batch(6)["data"]]

    img, tensor = _both(program)
    assert img.shape == (8, 4, 4) and img.dtype == np.float32
    assert tensor.shape == (6, 2, 3)


def test_groupby_string_keys_across_processes(clusters):
    """Hash partitioning must be deterministic across worker processes
    (regression: builtin hash() salting split string-key groups)."""
    def program(data):
        d = data.from_items(
            [{"k": f"key-{i % 3}", "v": i} for i in range(30)], parallelism=3
        )
        return d.groupby("k").count().take_all()

    rows = _both(program)
    assert len(rows) == 3, rows
    assert {r["count()"] for r in rows} == {10}, rows


def test_streaming_split_abandoned_epoch(clusters):
    """Breaking out of an epoch early must not deadlock the next epoch
    (regression: leftover items blocked the epoch barrier)."""
    def program(data):
        its = data.range(12, parallelism=4).streaming_split(1)
        it = iter(its[0]._source)
        next(it)  # consume one block, abandon the rest
        rows = []
        for b in its[0].iter_batches(batch_size=None):  # epoch 2
            rows.extend(np.asarray(b).tolist())
        return sorted(rows)

    assert _both(program) == list(range(12))


def test_iter_torch_batches(clusters):
    import torch

    def program(data):
        ds = data.from_items([{"x": float(i), "y": i} for i in range(10)])
        return list(ds.iterator().iter_torch_batches(
            batch_size=4, dtypes={"x": torch.float32}
        ))

    batches = _both(lambda data: [{k: v.numpy() for k, v in b.items()}
                                  for b in program(data)])
    assert len(batches) == 3
    got = program(importlib.import_module("ray_tpu_torch.data"))
    assert isinstance(got[0]["x"], torch.Tensor)
    assert got[0]["x"].dtype == torch.float32
    assert sum(int(b["y"].sum()) for b in got) == sum(range(10))
    # a batch never shares the store's read-only memory
    assert all(b["x"].numpy().flags.writeable for b in got)


def test_iter_torch_batches_on_a_device(clusters):
    """The reference's ``iter_jax_batches(sharding=...)`` becomes
    ``iter_torch_batches(device=...)`` on the worker's own shard: tensors
    land on the device asked for, with the reference's values."""
    import torch

    from ray_tpu_torch import data

    ref = ray_tpu.data.from_items([{"x": float(i)} for i in range(16)])
    want = [np.asarray(b["x"]) for b in
            ref.iterator().iter_jax_batches(batch_size=8)]
    ds = data.from_items([{"x": float(i)} for i in range(16)])
    shard = ds.streaming_split(1)[0]
    for device in ("cpu", torch.device("cpu")):
        batches = list(shard.iter_torch_batches(batch_size=8, device=device))
        assert len(batches) == 2
        assert all(b["x"].device == torch.device("cpu") for b in batches)
        np.testing.assert_array_equal(
            np.concatenate([b["x"].numpy() for b in batches]),
            np.concatenate(want))
    assert sum(float(b["x"].sum()) for b in batches) == float(sum(range(16)))

    # a partial final batch stays unless drop_last is asked for, as in the
    # reference's iter_torch_batches
    ds10 = data.from_items([{"x": float(i)} for i in range(10)])
    assert [len(b["x"]) for b in ds10.iterator().iter_torch_batches(
        batch_size=8, device="cpu")] == [8, 2]
    b10 = list(ds10.iterator().iter_torch_batches(batch_size=8,
                                                  device="cpu",
                                                  drop_last=True))
    assert len(b10) == 1 and b10[0]["x"].shape == (8,)


# ---------------------------------------------------------------------------
# the seams
# ---------------------------------------------------------------------------

def test_table_types_columns_as_arrow_does():
    """``column_from_values`` against ``pyarrow.array`` on the same rows:
    the same values, numpy's dtype for Arrow's type, nulls as NaN (floats)
    or None (objects)."""
    import pyarrow as pa

    from ray_tpu_torch.data.block import Table, column_from_values

    cases = {
        "ints": ([1, 2, 3], np.int64),
        "floats": ([0.5, 1, 2], np.float64),
        "bools": ([True, False], np.bool_),
        "strings": (["a", None, "c"], np.object_),
        "bytes": ([b"x", b"yz"], np.object_),
        "int nulls": ([1, None, 3], np.float64),
        "lists": ([[1, 2], [3]], np.object_),
        "empty": ([], np.object_),
    }
    for name, (values, dtype) in cases.items():
        col = column_from_values(values)
        assert col.dtype == dtype, name
        want = pa.array(values).to_pylist()
        got = [None if isinstance(v, float) and np.isnan(v) else v
               for v in col.tolist()]
        assert got == want, name
    rows = [np.full((2, 3), i, np.float32) for i in range(4)]
    col = column_from_values(rows)
    assert col.shape == (4, 2, 3) and col.dtype == np.float32
    t = Table({"img": col, "s": ["a", "b", "c", "d"]})
    assert t.schema.names == ("img", "s")
    assert t.schema.shapes == ((2, 3), ())
    with pytest.raises(ValueError, match="same length"):
        Table({"a": [1, 2], "b": [1]})


def test_table_matches_arrow_on_slice_take_concat_and_sort():
    import pyarrow as pa

    from ray_tpu_torch.data.block import BlockAccessor, Table, concat_blocks

    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, 40)
    b = rng.integers(0, 3, 40)
    s = np.array([f"s{i % 5}" for i in range(40)], dtype=object)
    t = Table({"a": a, "b": b, "s": s})
    at = pa.table({"a": a, "b": b, "s": list(s)})
    for key, desc in ((["a", "b"], False), (["b", "s"], True), ("s", False)):
        got = BlockAccessor(t).sort_by(key, desc).to_pylist()
        keys = [key] if isinstance(key, str) else key
        want = at.sort_by([(k, "descending" if desc else "ascending")
                           for k in keys]).to_pylist()
        assert got == want, key
    assert t.slice(5, 3).to_pylist() == at.slice(5, 3).to_pylist()
    assert t.slice(38).to_pylist() == at.slice(38).to_pylist()
    assert t.take([3, 1]).to_pylist() == at.take([3, 1]).to_pylist()
    other = Table({"a": np.arange(2), "z": [1.5, 2.5]})
    got = concat_blocks([t.slice(0, 2), other])
    want = pa.concat_tables([at.slice(0, 2), pa.table({"a": np.arange(2),
                                                       "z": [1.5, 2.5]})],
                            promote_options="default")
    assert got.column_names == want.column_names
    rows = [{k: (None if isinstance(v, float) and np.isnan(v) else v)
             for k, v in r.items()} for r in got.to_pylist()]
    assert rows == want.to_pylist()


def test_hash_partition_equals_the_reference_row_by_row():
    """The port's partitioner sends every row where the reference's does
    (crc32 of each value's repr: stable across processes)."""
    import pyarrow as pa

    from ray_tpu.data.block import BlockAccessor as RefAccessor
    from ray_tpu_torch.data.block import BlockAccessor, Table

    keys = [f"key-{i % 7}" for i in range(50)]
    nums = list(range(50))
    t = Table({"k": keys, "n": nums})
    at = pa.table({"k": keys, "n": nums})
    for key in ("k", ["k", "n"]):
        got = [p.to_pylist() for p in BlockAccessor(t).hash_partition(key, 4)]
        want = [p.to_pylist() for p in RefAccessor(at).hash_partition(key, 4)]
        assert got == want


def test_block_rides_the_store_zero_copy(clusters):
    """A block's numpy columns are pickle-5 out-of-band buffers: a block
    read back from the object store shares its memory with the store (so
    arrays come back read-only), and ``iter_torch_batches`` copies them."""
    from ray_tpu_torch.data.block import Table

    t = Table({"x": np.arange(100_000, dtype=np.float32),
               "s": ["a"] * 100_000})
    buffers = []
    pickle.dumps(t, protocol=5, buffer_callback=buffers.append)
    assert len(buffers) == 1 and buffers[0].raw().nbytes == 400_000
    back = ray_tpu_torch.get(ray_tpu_torch.put(t))
    assert isinstance(back, Table) and back.num_rows == 100_000
    assert not back["x"].flags.writeable
    np.testing.assert_array_equal(back["x"], t["x"])


def test_from_blocks_puts_blocks_without_a_task(clusters):
    from ray_tpu_torch import data

    cols = {"image": np.zeros((10, 3, 4, 4), np.float32),
            "label": np.arange(10)}
    ds = data.from_blocks([{k: v[:6] for k, v in cols.items()},
                           data.Table({k: v[6:] for k, v in cols.items()})])
    assert ds.num_blocks() == 2 and ds.count() == 10
    assert "(dataset not yet executed)" not in ds.stats()
    assert ds.stats().startswith("Dataset: 2 blocks, 10 rows")
    assert ds.schema().shapes == ((3, 4, 4), ())
    batch = ds.take_batch(10)
    assert batch["image"].shape == (10, 3, 4, 4)
    assert batch["label"].tolist() == list(range(10))


def test_arrow_and_pandas_bridges(clusters):
    """pyarrow and pandas in and out: ``to_arrow_refs`` gives Arrow tables,
    ``from_arrow_refs`` takes them, the "pyarrow" and "pandas" batch
    formats give their objects."""
    import pandas as pd
    import pyarrow as pa

    from ray_tpu_torch import data

    ds = data.from_items([{"a": i, "s": str(i)} for i in range(6)],
                         parallelism=2)
    tables = ray_tpu_torch.get(ds.to_arrow_refs())
    assert all(isinstance(t, pa.Table) for t in tables)
    assert sum(t.num_rows for t in tables) == 6
    back = data.from_arrow_refs([ray_tpu_torch.put(t) for t in tables])
    assert back.take_all() == ds.take_all()
    assert isinstance(ds.take_batch(3, batch_format="pandas"), pd.DataFrame)
    assert isinstance(ds.take_batch(3, batch_format="pyarrow"), pa.Table)


def test_map_batches_actors_lease_cpus_and_see_the_drivers_devices(
        clusters):
    """A class in ``map_batches`` runs in actors that lease ``{"CPU":
    num_cpus}`` and nothing else (no ``num_gpus``, as in the reference);
    the raylet leaves ``CUDA_VISIBLE_DEVICES`` as the driver has it, so an
    actor reaches the same cards as the driver."""
    from ray_tpu_torch import data
    from ray_tpu_torch.data._internal import logical as L

    class Env:
        def __call__(self, batch):
            import os

            return {"cvd": [str(os.environ.get("CUDA_VISIBLE_DEVICES"))],
                    "pid": [os.getpid()]}

    ds = data.range(4, parallelism=2).map_batches(Env, concurrency=2,
                                                   num_cpus=1)
    assert isinstance(ds._dag, L.MapBlocks)
    assert ds._dag.compute == ("actors", 2)
    assert ds._dag.resources == {"CPU": 1}
    rows = ds.take_all()
    assert {r["cvd"] for r in rows} == {
        str(os.environ.get("CUDA_VISIBLE_DEVICES"))}
    assert os.getpid() not in {r["pid"] for r in rows}


NO_ARROW_PROGRAM = '''
def program(data, rt):
    import numpy as np
    import torch

    class Add:
        def __init__(self, k):
            self.k = k

        def __call__(self, batch):
            return {"x": batch["a"] + self.k, "s": batch["s"]}

    items = data.from_items([{"a": i, "s": f"s{i % 3}"} for i in range(12)],
                            parallelism=3)
    out = {}
    out["range"] = data.range(20, parallelism=4).take_all()
    out["from_numpy"] = data.from_numpy(
        np.arange(12).reshape(6, 2)).take_batch(6)["data"]
    out["from_items"] = items.take_all()
    out["map"] = data.range(10, parallelism=2).map(
        lambda x: {"v": x * 3}).take_all()
    out["map_batches"] = data.range(10, parallelism=2).map_batches(
        lambda b: {"x": b * 2}).take_all()
    out["map_batches_actors"] = items.map_batches(
        Add, concurrency=2, fn_constructor_args=(100,)).take_all()
    out["filter"] = items.filter(lambda r: r["a"] % 2 == 0).take_all()
    out["sort"] = items.sort("a", descending=True).take_all()
    out["groupby"] = items.groupby("s").sum("a").take_all()
    out["random_shuffle"] = data.range(30, parallelism=3).random_shuffle(
        seed=5).take_all()
    out["split"] = [p.take_all() for p in
                    data.range(30, parallelism=6).split(3, equal=True)]
    its = data.range(12, parallelism=4).streaming_split(2, equal=True)
    out["streaming_split"] = [[b.tolist() for b in it.iter_batches(
        batch_size=None)] for it in its]
    out["iter_torch_batches"] = [
        {k: v.tolist() for k, v in b.items()}
        for b in data.from_items([{"x": float(i), "y": i}
                                  for i in range(10)]
                                 ).iterator().iter_torch_batches(
            batch_size=4)]

    def arrow_in_worker():
        try:
            import pyarrow  # noqa: F401
        except ImportError:
            return "blocked"
        return "imported"

    if rt is not None:
        out["worker_pyarrow"] = rt.get(rt.remote(arrow_in_worker).remote())
    return out
'''


def test_core_path_runs_without_pyarrow_or_pandas(clusters, tmp_path):
    """In a process where ``import pyarrow`` and ``import pandas`` fail
    (``sys.modules`` entries of None, and shadow packages that raise on the
    workers' path), the port's core Data path gives the reference's
    answers."""
    for name in ("pyarrow", "pandas"):
        shadow = tmp_path / "shadow" / name
        shadow.mkdir(parents=True)
        (shadow / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    script = tmp_path / "no_arrow.py"
    script.write_text(textwrap.dedent('''
        import sys
        sys.modules["pyarrow"] = sys.modules["pandas"] = None
        import json
        import numpy as np
        import ray_tpu_torch as rt
        from ray_tpu_torch import data
        ''') + NO_ARROW_PROGRAM + textwrap.dedent('''
        def plain(x):
            if isinstance(x, dict):
                return {k: plain(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [plain(v) for v in x]
            if isinstance(x, np.ndarray):
                return plain(x.tolist())
            if isinstance(x, np.generic):
                return x.item()
            return x

        rt.init(num_cpus=4)
        try:
            out = program(data, rt)
        finally:
            rt.shutdown()
        out["loaded"] = sorted(m for m in ("pyarrow", "pandas")
                               if sys.modules.get(m) is not None)
        print(json.dumps(plain(out)))
        '''))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tmp_path / "shadow"), str(REPO)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=240,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got.pop("loaded") == []
    assert got.pop("worker_pyarrow") == "blocked"

    scope = {}
    exec(NO_ARROW_PROGRAM, scope)
    want = _py(scope["program"](importlib.import_module("ray_tpu.data"),
                                None))
    assert got == want


def test_port_data_modules_import_no_jax_and_nothing_of_ray_tpu():
    """The AST walk of ``tests/test_torch_serve_llm.py`` takes every
    ``ray_tpu_torch/**/*.py``; here it is run on this slice's modules
    alone, and on no other import of pyarrow or pandas than a lazy one
    (inside a function)."""
    import ast

    files = sorted((REPO / "ray_tpu_torch" / "data").rglob("*.py"))
    files += [REPO / "ray_tpu_torch" / "train" / "predictor.py",
              REPO / "ray_tpu_torch" / "tools" / "data_runs.py"]
    assert len(files) == 16
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                names = [node.value] if node.value == "ray_tpu" or \
                    node.value.startswith("ray_tpu.") else []
            for name in names:
                root = name.split(".")[0]
                assert root not in {"jax", "jaxlib", "flax", "optax",
                                    "ray_tpu"}, f"{f}: {name}"
                if root in ("pyarrow", "pandas"):
                    assert id(node) not in top, f"{f}: {name} at the top"
