"""The port's extended datasources and preprocessors beside the
reference's, on the CPU (the cases of ``tests/test_data_extended.py``).

Each case runs the same program through both packages, one cluster of
each for the module, and holds the results equal after turning them into
plain Python values. The preprocessors compute through pandas (present on
this box only; the port imports it lazily, as the reference does).
Datasources and record formats are defined inside the tests so they
travel to the workers by value.
"""

import importlib
import sqlite3
import struct
import tarfile

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

from tests.test_torch_data import _py


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=4)
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _both(program, *args):
    ref = program(importlib.import_module("ray_tpu.data"), *args)
    got = program(importlib.import_module("ray_tpu_torch.data"), *args)
    assert _py(got) == _py(ref)
    return got


def test_read_images(clusters, tmp_path):
    from PIL import Image

    for i in range(4):
        arr = np.full((8, 8, 3), i * 10, dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img_{i}.png")

    def program(data):
        ds = data.read_images(str(tmp_path), size=(4, 4), include_paths=True)
        return ds.take_batch(10, batch_format="numpy")

    batch = _both(program)
    assert batch["image"].shape == (4, 4, 4, 3)
    assert batch["image"].dtype == np.uint8
    assert all(p.endswith(".png") for p in batch["path"])


def _write_tfrecord(path, examples):
    """Hand-encode tf.train.Example protos + TFRecord framing."""

    def varint(n):
        out = b""
        while True:
            b7 = n & 0x7F
            n >>= 7
            out += bytes([b7 | (0x80 if n else 0)])
            if not n:
                return out

    def ld(field, payload):  # length-delimited field
        return varint((field << 3) | 2) + varint(len(payload)) + payload

    with open(path, "wb") as f:
        for ex in examples:
            feats = b""
            for key, value in ex.items():
                if isinstance(value, bytes):
                    flist = ld(1, ld(1, value))  # bytes_list
                elif isinstance(value, float):
                    flist = ld(2, ld(1, struct.pack("<f", value)))
                else:
                    flist = ld(3, ld(1, varint(int(value))))
                entry = ld(1, key.encode()) + ld(2, flist)
                feats += ld(1, entry)
            payload = ld(1, feats)  # Example.features
            f.write(struct.pack("<Q", len(payload)))
            f.write(b"\x00" * 4)
            f.write(payload)
            f.write(b"\x00" * 4)


def test_read_tfrecords(clusters, tmp_path):
    path = str(tmp_path / "data.tfrecord")
    _write_tfrecord(path, [
        {"name": b"alice", "age": 30, "score": 1.5},
        {"name": b"bob", "age": 25, "score": 2.5},
    ])

    def program(data):
        return sorted(data.read_tfrecords(path).take_all(),
                      key=lambda r: r["age"])

    rows = _both(program)
    assert rows[0]["name"] == b"bob" and rows[0]["age"] == 25
    assert abs(rows[1]["score"] - 1.5) < 1e-6


def test_read_webdataset(clusters, tmp_path):
    import io

    shard = tmp_path / "shard_0.tar"
    with tarfile.open(shard, "w") as tf:
        for key, cls in [("s0", "cat"), ("s1", "dog")]:
            for ext, payload in [("txt", f"text-{key}".encode()),
                                 ("cls", cls.encode())]:
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))

    rows = _both(lambda data: data.read_webdataset(str(tmp_path)).take_all())
    assert len(rows) == 2
    assert rows[0]["__key__"] == "s0" and rows[0]["cls"] == "cat"
    assert rows[1]["txt"] == "text-s1"


def test_read_sql(clusters, tmp_path):
    db = str(tmp_path / "test.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?)",
                     [(1, "a"), (2, "b"), (3, "c")])
    conn.commit()
    conn.close()

    def program(data):
        import sqlite3

        return data.read_sql("SELECT * FROM t ORDER BY id",
                             lambda: sqlite3.connect(db)).take_all()

    rows = _both(program)
    assert [r["name"] for r in rows] == ["a", "b", "c"]
    assert [r["id"] for r in rows] == [1, 2, 3]


def test_standard_and_minmax_scaler(clusters):
    import pandas as pd

    df = pd.DataFrame({"x": [0.0, 1.0, 2.0, 3.0],
                       "y": [10.0, 20.0, 30.0, 40.0]})

    def program(data):
        pp = data.preprocessors
        ds = data.from_pandas(df)
        scaler = pp.StandardScaler(["x"])
        out = scaler.fit_transform(ds).to_pandas().sort_values("y")
        mm = pp.MinMaxScaler(["y"]).fit(ds)
        out2 = mm.transform(ds).to_pandas()
        # serving-time single batch
        served = mm.transform_batch({"x": [9.9], "y": [25.0]})
        return [out.to_dict("list"), scaler.stats_, out2.to_dict("list"),
                served.to_dict("list")]

    out, _, out2, served = _both(program)
    np.testing.assert_allclose(np.mean(out["x"]), 0.0, atol=1e-9)
    np.testing.assert_allclose(np.std(out["x"]), 1.0, atol=1e-9)
    assert min(out2["y"]) == 0.0 and max(out2["y"]) == 1.0
    np.testing.assert_allclose(served["y"], [0.5])


def test_label_onehot_imputer_concat_chain(clusters):
    import pandas as pd

    df = pd.DataFrame({
        "cat": ["a", "b", "a", "c"],
        "v": [1.0, np.nan, 3.0, np.nan],
        "w": [1.0, 1.0, 1.0, 1.0],
    })

    def program(data):
        pp = data.preprocessors
        ds = data.from_pandas(df)
        out = {}
        le = pp.LabelEncoder("cat").fit(ds)
        out["label"] = sorted(le.transform(ds).to_pandas()["cat"].tolist())
        oh = pp.OneHotEncoder(["cat"]).fit(ds)
        onehot = oh.transform(ds).to_pandas()
        out["onehot_columns"] = sorted(onehot.columns)
        out["onehot"] = {c: onehot[c].tolist() for c in sorted(onehot)
                         if c.startswith("cat")}
        imp = pp.SimpleImputer(["v"], strategy="mean").fit(ds)
        out["imputed"] = sorted(imp.transform(ds).to_pandas()["v"])
        chain = pp.Chain(
            pp.SimpleImputer(["v"], strategy="constant", fill_value=0.0),
            pp.Concatenator(["v", "w"], output_column_name="vec"),
        )
        vec = chain.fit_transform(ds).to_pandas()
        out["columns"] = sorted(vec.columns)
        out["vec"] = [np.asarray(v).tolist() for v in vec["vec"]]
        served = chain.transform_batch({"cat": ["a"], "v": [np.nan],
                                        "w": [5.0]})
        out["served"] = np.asarray(served["vec"].iloc[0]).tolist()
        with pytest.raises(pp.PreprocessorNotFittedError):
            pp.StandardScaler(["x"]).transform(ds)
        return out

    out = _both(program)
    assert out["label"] == [0, 0, 1, 2]
    assert {"cat_a", "cat_b", "cat_c"} <= set(out["onehot"])
    assert sum(out["onehot"]["cat_a"]) == 2
    np.testing.assert_allclose(out["imputed"], [1.0, 2.0, 2.0, 3.0])
    assert "vec" in out["columns"] and len(out["vec"][0]) == 2
    np.testing.assert_allclose(out["served"], [0.0, 5.0])


def test_custom_file_based_datasource(clusters, tmp_path):
    """The docstring's worked example: a length-prefixed record format
    plugged in via FileBasedDatasource + read_datasource."""
    for shard in range(3):
        with open(tmp_path / f"part-{shard}.rec", "wb") as f:
            for i in range(4):
                payload = f"s{shard}r{i}".encode()
                f.write(len(payload).to_bytes(4, "little"))
                f.write(payload)
    (tmp_path / "ignored.txt").write_text("not a rec file")

    def program(data):
        class RecordDatasource(data.FileBasedDatasource):
            _FILE_EXTENSIONS = ["rec"]

            def _read_file(self, f, path):
                rows = []
                while True:
                    hdr = f.read(4)
                    if not hdr:
                        break
                    n = int.from_bytes(hdr, "little")
                    rows.append({"payload": f.read(n)})
                return rows

        ds = data.read_datasource(RecordDatasource(str(tmp_path)),
                                  parallelism=2)
        # streams through the executor like any built-in reader
        return [ds.take_all(),
                ds.map(lambda r: {"n": len(r["payload"])}).take_all()]

    rows, lengths = _both(program)
    assert len(rows) == 12
    assert {r["payload"] for r in rows} == {
        f"s{s}r{i}".encode() for s in range(3) for i in range(4)
    }
    assert lengths[0]["n"] == 4


def test_custom_datasource_base(clusters):
    """Bare Datasource contract: synthesize blocks without files."""
    def program(data):
        class Squares(data.Datasource):
            def get_read_tasks(self, parallelism):
                def make(lo, hi):
                    return lambda: [{"x": i, "sq": i * i}
                                    for i in range(lo, hi)]
                step = 10
                return [make(i, i + step) for i in range(0, 30, step)]

        return data.read_datasource(Squares()).take_all()

    rows = _both(program)
    assert len(rows) == 30
    assert all(r["sq"] == r["x"] ** 2 for r in rows)


def test_read_mongo_gated_on_pymongo():
    """pymongo is absent in this image: read_mongo must raise the
    documented ImportError at CALL time (not inside a worker task)."""
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        data = importlib.import_module(f"{pkg}.data")
        with pytest.raises(ImportError, match="pymongo"):
            data.read_mongo("mongodb://localhost:27017", "db", "coll")
