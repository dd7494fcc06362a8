"""The port's own native library (``ray_tpu_torch/_private/csrc/``: the
object store, the GCS log store and the scheduler behind a C ABI), built
by ``native_store`` into ``build/ray_tpu_torch/`` at first load.

The reference's cases of ``tests/test_native_store.py`` and
``tests/test_native_unit.py`` run through the port's names (the unit suite
built from the port's copy of ``native_test.cpp``). Then: loading the
library builds it from the port's sources under the build directory and
leaves the reference's ``src/`` byte for byte and mtime as it was, and no
module of the port joins a path to the reference's ``src/`` or
``ray_tpu/`` tree.
"""

import ast
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ray_tpu_torch._private import native_store, object_store
from ray_tpu_torch._private.ids import ObjectID

REPO = Path(__file__).resolve().parents[1]

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the native library")


@pytest.fixture(scope="module")
def native():
    """The port's library, built here first: a compiler error fails the
    case with g++'s stderr (``build`` raises it) instead of leaving the
    runtime on the Python store."""
    native_store.build("librtpu_store", native_store.LIB_SOURCES,
                       shared=True)
    assert native_store.available()


def _on_the_library(test):
    """A case on the built library: skipped only where there is no g++."""
    return needs_gxx(pytest.mark.usefixtures("native")(test))


def _oid(i: int) -> ObjectID:
    return ObjectID(bytes([i]) * ObjectID.SIZE)


@_on_the_library
def test_native_write_python_read(tmp_path):
    d = str(tmp_path)
    payload = np.arange(1000, dtype=np.int64)
    native_store.write_object(
        d, _oid(1).hex(), b"meta", [payload.tobytes()], payload.nbytes
    )
    buf = object_store.read_object(d, _oid(1))
    assert buf is not None
    assert buf.metadata == b"meta"
    assert np.frombuffer(buf.data, np.int64).tolist() == payload.tolist()
    buf.release()


@_on_the_library
def test_python_write_native_read(tmp_path):
    d = str(tmp_path)
    object_store.write_object(d, _oid(2), b"m2", [b"hello", b"world"], 10)
    out = native_store.open_object(d, _oid(2).hex())
    assert out is not None
    handle, metadata, data = out
    assert metadata == b"m2"
    assert bytes(data) == b"helloworld"
    del data
    native_store.release(handle)
    assert native_store.object_exists(d, _oid(2).hex())


@_on_the_library
def test_native_store_eviction_and_pinning(tmp_path):
    d = str(tmp_path)
    store = native_store.NativeLocalObjectStore(d, capacity_bytes=4096)
    blob = b"x" * 1000
    for i in range(3):
        store.put(_oid(i + 1), b"", [blob], len(blob))
    assert store.used_bytes() <= 4096
    store.pin(_oid(3))
    # two more puts force eviction of the oldest unpinned objects
    store.put(_oid(4), b"", [blob], len(blob))
    store.put(_oid(5), b"", [blob], len(blob))
    assert store.contains(_oid(3))  # pinned survived
    assert store.used_bytes() <= 4096
    ids = {o.hex() for o in store.object_ids()}
    assert _oid(3).hex() in ids

    # everything pinned and full -> ObjectStoreFullError
    for oid in store.object_ids():
        store.pin(oid)
    with pytest.raises(object_store.ObjectStoreFullError):
        store.put(_oid(9), b"", [b"y" * 4000], 4000)


@_on_the_library
def test_native_store_zero_copy_writable_buffer(tmp_path):
    d = str(tmp_path)
    arr = np.arange(256, dtype=np.uint8)
    native_store.write_object(d, _oid(7).hex(), b"", [memoryview(arr)],
                              arr.nbytes)
    buf = object_store.read_object(d, _oid(7))
    assert bytes(buf.data) == arr.tobytes()
    buf.release()


@_on_the_library
def test_cluster_uses_native_store(tmp_path):
    """End-to-end: put/get through the runtime rides the native store."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2)
    try:
        big = np.random.default_rng(0).standard_normal(100_000)
        ref = ray_tpu_torch.put(big)
        out = ray_tpu_torch.get(ref, timeout=30)
        np.testing.assert_array_equal(out, big)
    finally:
        ray_tpu_torch.shutdown()


@_on_the_library
def test_native_log_store_roundtrip(tmp_path):
    """C++ append-log KV store: put/tombstone/replay/compaction across
    reopen (the GCS persistence backend; csrc/log_store.cpp)."""
    from ray_tpu_torch._private.gcs_store import NativeLogStore

    path = str(tmp_path / "gcs.log")
    s = NativeLogStore(path)
    for i in range(100):
        s.put("kv", ("ns", f"k{i}".encode()), f"v{i}".encode())
    for i in range(0, 100, 2):
        s.put("kv", ("ns", f"k{i}".encode()), None)  # delete evens
    s.put("actor", b"aid", {"state": "ALIVE"})
    s.close()

    s2 = NativeLogStore(path)
    tables = s2.load()
    assert len(tables["kv"]) == 50
    assert tables["kv"][("ns", b"k1")] == b"v1"
    assert ("ns", b"k0") not in tables["kv"]
    assert tables["actor"][b"aid"]["state"] == "ALIVE"
    s2.close()

    # torn tail: truncate mid-record; replay keeps the intact prefix
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 3)
    s3 = NativeLogStore(path)
    tables = s3.load()
    assert len(tables.get("kv", {})) in (49, 50)
    s3.close()


@needs_gxx
def test_native_cpp_unit_suite():
    """The C ABI's unit suite (the port's copy of ``native_test.cpp``),
    built into the build directory and run."""
    binary = native_store.build(
        "native_test", ("native_test.cpp",) + native_store.LIB_SOURCES,
        shared=False)
    assert binary.parent == native_store.BUILD_DIR
    run = subprocess.run([str(binary)], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "checks passed" in run.stdout


def _snapshot(root: Path):
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns,
                     hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(root.iterdir()) if p.is_file()}


def test_loading_builds_the_ports_library_and_leaves_src_untouched(
        tmp_path):
    """A fresh process loads the library through a build directory of its
    own: g++ compiles ``csrc/`` there, the process maps that file, and the
    reference's ``src/`` keeps every file's bytes and mtime."""
    assert native_store.BUILD_DIR == REPO / "build" / "ray_tpu_torch"
    assert native_store.CSRC == REPO / "ray_tpu_torch" / "_private" / "csrc"
    assert native_store.library_path().parent == native_store.BUILD_DIR
    before = _snapshot(REPO / "src")
    build_dir = tmp_path / "build" / "ray_tpu_torch"
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from ray_tpu_torch._private import native_store as n\n"
        "n.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = n.load_library()\n"
        "print(lib._name)\n"
        "print(len(open('/proc/self/maps').read().split(lib._name)) - 1)\n")
    run = subprocess.run([sys.executable, "-c", code, str(build_dir)],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert run.returncode == 0, run.stderr[-2000:]
    name, maps = run.stdout.split()
    built = sorted(build_dir.glob("librtpu_store-*.so"))
    assert [str(p) for p in built] == [name]
    assert int(maps) > 0  # the built file is the one mapped
    assert Path(name).name == native_store.library_path().name
    assert _snapshot(REPO / "src") == before


def _joins_the_reference_tree(node) -> bool:
    """A path join whose literal names the reference's ``src`` or
    ``ray_tpu`` tree: ``os.path.join(..., "src")``, ``root / "ray_tpu"``
    or an f-string part ``/src/...``."""

    def names_it(s):
        s = s.strip("/")
        return s in ("src", "ray_tpu") or s.startswith(("src/",
                                                         "ray_tpu/"))

    if isinstance(node, ast.Call) and (
            getattr(node.func, "attr", None) == "join" or
            getattr(node.func, "id", None) in ("Path", "PurePath")):
        return any(isinstance(a, ast.Constant) and isinstance(a.value, str)
                   and names_it(a.value) for a in node.args)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        return isinstance(node.right, ast.Constant) and isinstance(
            node.right.value, str) and names_it(node.right.value)
    if isinstance(node, ast.JoinedStr):
        return any(isinstance(v, ast.Constant) and isinstance(v.value, str)
                   and v.value.startswith(("/src", "/ray_tpu/"))
                   for v in node.values)
    return False


def test_no_port_module_joins_a_path_into_the_reference_tree():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    found = []
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        found += [f"{f.relative_to(REPO)}:{n.lineno}"
                  for n in ast.walk(tree) if _joins_the_reference_tree(n)]
    assert found == []
    # the walk catches the joins the port used to make
    for bad in ('os.path.join(os.path.dirname(root), "src")',
                'REPO / "ray_tpu/rllib/tuned_examples"',
                'f"{root}/src/librtpu_store.so"'):
        assert any(_joins_the_reference_tree(n)
                   for n in ast.walk(ast.parse(bad))), bad
