"""The port's counterpart of ``tests/test_external_storage.py`` (7 cases),
through ``ray_tpu_torch`` on the port's own clusters
(``tests/torch_fixtures.py``) with the reference's expected values: every
case is carried under its own name, through the port's copy of the plugin,
``tests/torch_external_store_plugin.py``.
``test_spill_layout_is_the_references`` restores one package's spill
through the other's backend.

The reference's description:

External object-spill backends (ray parity:
python/ray/_private/external_storage.py + local_object_manager.h:40):
URI-pluggable spill, restart recovery from an external URI, and the
chaos path through a real cluster with the plugin hook.
"""

import numpy as np
import pytest

import tests.torch_external_store_plugin  # registers mocks3:// in this process
from ray_tpu_torch._private.external_storage import (
    FileSystemStorage,
    make_external_storage,
)
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import LocalObjectStore


def test_filesystem_storage_roundtrip(tmp_path):
    st = make_external_storage(f"file://{tmp_path}/ext")
    assert isinstance(st, FileSystemStorage)
    src = tmp_path / "src.bin"
    src.write_bytes(b"payload" * 1000)
    st.spill("k1", str(src))
    assert st.exists("k1")
    dst = tmp_path / "back.bin"
    assert st.restore("k1", str(dst))
    assert dst.read_bytes() == b"payload" * 1000
    st.delete("k1")
    assert not st.exists("k1")
    assert not st.restore("k1", str(dst))


def test_scheme_routing(tmp_path):
    assert make_external_storage(None) is None
    assert isinstance(make_external_storage(str(tmp_path)),
                      FileSystemStorage)
    assert make_external_storage(f"mocks3://{tmp_path}/m") is not None
    with pytest.raises(ValueError, match="unknown external storage"):
        make_external_storage("azureblob://x")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_spill_layout_is_the_references(tmp_path, writer):
    """A file:// spill written by either package restores through the
    other: the same key, the same path, the same bytes."""
    from ray_tpu._private import external_storage as ref

    uri = f"file://{tmp_path}/ext"
    port_st, ref_st = make_external_storage(uri), \
        ref.make_external_storage(uri)
    src = tmp_path / "src.bin"
    src.write_bytes(bytes(range(256)) * 300)
    a, b = (port_st, ref_st) if writer == "port" else (ref_st, port_st)
    a.spill("obj", str(src))
    assert b.exists("obj")
    dst = tmp_path / "back.bin"
    assert b.restore("obj", str(dst))
    assert dst.read_bytes() == src.read_bytes()
    b.delete("obj")
    assert not a.exists("obj")


def _fill_past_capacity(store, n=6, size=64 * 1024):
    oids = []
    for i in range(n):
        oid = ObjectID((bytes([i]) * 28))
        payload = bytes([i]) * size
        store.put(oid, b"meta", [payload], len(payload))
        store.pin(oid)  # pinned primaries spill rather than evict
        oids.append((oid, payload))
    return oids


def test_spill_through_custom_scheme(tmp_path):
    store = LocalObjectStore(
        str(tmp_path / "shm"), capacity_bytes=200 * 1024,
        spill_dir=f"mocks3://{tmp_path}/remote",
    )
    oids = _fill_past_capacity(store)
    stats = store.spilled_stats()
    assert stats["spilled_bytes_total"] > 0
    # the bytes really moved through the driver's layout
    assert (tmp_path / "remote" / "manifest.json").exists()
    # every object still addressable; spilled ones restore on get
    for oid, payload in oids:
        buf = store.get(oid)
        assert buf is not None
        assert bytes(buf.data) == payload
        buf.release()


def test_externally_spilled_objects_survive_store_restart(tmp_path):
    """The raylet-restart contract: a FRESH store (new ledger — the old
    raylet died) restores objects its predecessor spilled to the external
    URI, because spill keys are object-id-derived."""
    uri = f"mocks3://{tmp_path}/remote"
    store = LocalObjectStore(str(tmp_path / "shm1"), 200 * 1024, uri)
    oids = _fill_past_capacity(store)
    spilled = [
        (oid, payload) for oid, payload in oids if oid in store._spilled
    ]
    assert spilled, "nothing spilled; capacity too large for the test"

    store2 = LocalObjectStore(str(tmp_path / "shm2"), 200 * 1024, uri)
    for oid, payload in spilled:
        assert store2.contains(oid)
        buf = store2.get(oid)
        assert buf is not None, f"restart recovery failed for {oid}"
        assert bytes(buf.data) == payload
        buf.release()


class _CountingBackend:
    """exists() counter — the probe-budget contract under test."""

    def __init__(self):
        self.exists_calls = 0
        self.present = set()

    def exists(self, key):
        self.exists_calls += 1
        return key in self.present

    def spill(self, key, local_path):
        self.present.add(key)

    def restore(self, key, local_path):
        return False

    def delete(self, key):
        self.present.discard(key)


def test_contains_probes_external_backend_at_most_once(tmp_path):
    """ADVICE item: contains() for an id the backend doesn't hold must
    cost at most ONE external round trip (the restore path's documented
    contract) — routine containment checks for objects living on other
    nodes were paying a backend head per call."""
    store = LocalObjectStore(str(tmp_path / "shm"), 1024 * 1024,
                             f"mocks3://{tmp_path}/remote")
    backend = _CountingBackend()
    store._external = backend
    oid = ObjectID(b"\x07" * 28)
    for _ in range(5):
        assert not store.contains(oid)
    assert backend.exists_calls == 1  # first miss cached, 4 hits free
    # the object landing locally clears the cached miss: a later spill of
    # THIS id is probeable again
    payload = b"x" * 128
    store.put(oid, b"meta", [payload], len(payload))
    assert store.contains(oid)  # local hit, no probe
    store.delete(oid)
    backend.present.add(oid.hex() + ".obj")
    assert store.contains(oid)  # re-probed and found externally
    assert backend.exists_calls == 2


def test_register_external_clears_cached_probe_miss(tmp_path):
    store = LocalObjectStore(str(tmp_path / "shm"), 1024 * 1024,
                             f"mocks3://{tmp_path}/remote")
    backend = _CountingBackend()
    store._external = backend
    oid = ObjectID(b"\x08" * 28)
    assert not store.contains(oid)
    assert oid in store._probe_missed
    # a worker writes the object directly into shm and registers it
    from ray_tpu_torch._private.object_store import write_object

    write_object(str(tmp_path / "shm"), oid, b"m", [b"data"], 4)
    store.register_external(oid)
    assert oid not in store._probe_missed
    assert store.contains(oid)


def test_cluster_spills_through_plugin_scheme(tmp_path, monkeypatch):
    """e2e: a real cluster configured with the plugin scheme spills under
    memory pressure and restores on get (the IO-worker-style path)."""
    monkeypatch.setenv("RAY_TPU_TORCH_external_storage_setup_module",
                       "tests.torch_external_store_plugin")
    monkeypatch.setenv("RAY_TPU_TORCH_object_spill_dir",
                       f"mocks3://{tmp_path}/cluster_remote")
    # small store so a handful of arrays forces spilling
    monkeypatch.setenv("RAY_TPU_TORCH_object_store_memory", str(8 * 1024 * 1024))

    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2)
    try:
        refs = []
        arrays = []
        for i in range(8):
            a = np.full(2 * 1024 * 1024, i, dtype=np.uint8)
            arrays.append(a)
            refs.append(ray_tpu_torch.put(a))
        # everything must still be retrievable (later puts spilled earlier
        # ones); correctness beats placement here
        for i, (r, a) in enumerate(zip(refs, arrays)):
            got = ray_tpu_torch.get(r, timeout=60)
            assert got.nbytes == a.nbytes and got[0] == i
            del got
        assert (tmp_path / "cluster_remote" / "manifest.json").exists()
    finally:
        ray_tpu_torch.shutdown()
