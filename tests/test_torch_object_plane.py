"""The port's counterpart of ``tests/test_object_plane.py`` (5 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name. The cases under "torch tensors through the object plane" are the
port's own: a CUDA tensor travels as its host bytes and a device tag and is
rebuilt on the reader's card, or on the CPU where the reader sees none
(``_private/serialization.py``); a CPU tensor pickles in-band, as the
reference's ``jax.Array`` does. On the card, ``chip_smoke.py`` phase 36
puts real CUDA tensors.

The reference's description:

Object-plane robustness: spilling, restore, pull admission, OOM defense.

Reference analogs: ray python/ray/tests/test_object_spilling.py,
test_out_of_memory_killer — spill under store pressure instead of erroring
(local_object_manager.h:40), restore on access, kill workers under host
memory pressure (memory_monitor.h:52).
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import LocalObjectStore

from tests.torch_fixtures import port_cluster  # noqa: F401


def _mk_store(tmp_path, capacity, native=False):
    store_dir = str(tmp_path / "store")
    spill_dir = str(tmp_path / "spill")
    if native:
        from ray_tpu_torch._private import native_store

        if not native_store.available():
            pytest.skip("native store unavailable")
        return native_store.NativeLocalObjectStore(store_dir, capacity, spill_dir)
    return LocalObjectStore(store_dir, capacity, spill_dir)


@pytest.mark.parametrize("native", [False, True])
def test_store_spills_pinned_objects_past_capacity(tmp_path, native):
    """Filling the store to 2x capacity with PINNED objects spills instead
    of raising; spilled objects remain addressable and restore on get."""
    store = _mk_store(tmp_path, capacity=1 << 20, native=native)
    payload = b"x" * (300 * 1024)
    oids = []
    for _ in range(8):  # ~2.4MB total vs 1MB capacity
        oid = ObjectID.from_random()
        store.put(oid, b"", [payload], len(payload))
        store.pin(oid)
        oids.append(oid)
    assert store.used_bytes() <= (1 << 20)
    stats = store.spilled_stats()
    assert stats["spilled_bytes_total"] > 0
    # every object is still addressable; get() restores spilled ones
    for oid in oids:
        assert store.contains(oid)
        buf = store.get(oid)
        assert buf is not None
        assert bytes(buf.data) == payload
        buf.release()


@pytest.mark.parametrize("native", [False, True])
def test_store_delete_removes_spilled_file(tmp_path, native):
    store = _mk_store(tmp_path, capacity=256 * 1024, native=native)
    payload = b"y" * (200 * 1024)
    a, b = ObjectID.from_random(), ObjectID.from_random()
    store.put(a, b"", [payload], len(payload))
    store.pin(a)
    store.put(b, b"", [payload], len(payload))  # spills a
    assert store.contains(a)
    store.delete(a)
    assert not store.contains(a)
    spill_files = os.listdir(str(tmp_path / "spill"))
    assert spill_files == []


def test_pull_gate_priority_order():
    """Get-priority pulls are admitted before task-arg pulls when slots
    free up (ray: pull_manager.h:31 BundlePriority)."""
    import asyncio

    from ray_tpu_torch._private.raylet import (
        PULL_PRIO_GET,
        PULL_PRIO_TASK_ARGS,
        _PullGate,
    )

    async def run():
        gate = _PullGate(max_concurrent=1, byte_budget=1 << 20)
        order = []
        await gate.acquire(PULL_PRIO_GET)  # occupy the only slot

        async def worker(tag, prio):
            await gate.acquire(prio)
            order.append(tag)
            gate.release_slot()

        # Queue a low-priority waiter first, then a high-priority one.
        t1 = asyncio.create_task(worker("args", PULL_PRIO_TASK_ARGS))
        await asyncio.sleep(0.05)
        t2 = asyncio.create_task(worker("get", PULL_PRIO_GET))
        await asyncio.sleep(0.05)
        gate.release_slot()
        await asyncio.gather(t1, t2)
        return order

    order = asyncio.run(run())
    assert order == ["get", "args"]


def test_big_object_roundtrip_through_cluster(port_cluster):
    """A large object transfers between nodes in chunks and survives store
    pressure on the receiving side."""
    cluster = port_cluster
    cluster.add_node(num_cpus=1)
    cluster.add_node(num_cpus=1, resources={"there": 1.0})
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)

    @ray_tpu_torch.remote(resources={"there": 0.5})
    def far_sum(arr):
        return float(arr.sum())

    arr = np.ones(6_000_000, dtype=np.float32)  # ~24MB: multiple 8MB chunks
    ref = ray_tpu_torch.put(arr)
    assert ray_tpu_torch.get(far_sum.remote(ref), timeout=120) == 6_000_000.0


def test_memory_monitor_kills_worker(port_cluster, tmp_path, monkeypatch):
    """Driving the (test-injected) memory usage over threshold kills the
    busiest retriable worker; the task errors with an OOM message after
    retries exhaust."""
    gauge = tmp_path / "memusage"
    gauge.write_text("0.0")
    monkeypatch.setenv("RAY_TPU_TORCH_memory_monitor_test_path", str(gauge))
    monkeypatch.setenv("RAY_TPU_TORCH_memory_monitor_refresh_ms", "100")
    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    @ray_tpu_torch.remote(max_retries=0)
    def hog():
        import time as _t

        _t.sleep(30)
        return 1

    ref = hog.remote()
    time.sleep(1.0)  # let it dispatch
    gauge.write_text("0.99")
    with pytest.raises(Exception, match="memory"):
        ray_tpu_torch.get(ref, timeout=60)


# ---------------------------------------------------------------------------
# torch tensors through the object plane (_private/serialization.py)
# ---------------------------------------------------------------------------


class _CudaPayload:
    """Pickles exactly as the port's pickler reduces a CUDA tensor (its host
    bytes plus the writer's device tag), so a box with no card can feed a
    reader such a payload."""

    def __init__(self, t, device_tag="cuda:0"):
        self.t, self.device_tag = t, device_tag

    def __reduce__(self):
        from ray_tpu_torch._private.serialization import _reduce_cuda_tensor

        fn, (host, dtype, shape, _, grad) = _reduce_cuda_tensor(self.t)
        return fn, (host, dtype, shape, self.device_tag, grad)


def _tensors():
    import torch

    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(1024, 1024, generator=g),  # 4 MiB: out of band
        "bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "i64": torch.arange(7, dtype=torch.int64),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.empty(0, 4),
    }


def test_cuda_tensor_payload_rebuilds_on_the_cpu_without_a_card():
    """A CUDA tensor's payload, read where no card is visible, gives a CPU
    tensor equal to the bit, of the same dtype and shape, writable and not
    aliasing the store's bytes; 4 MiB cross as one out-of-band buffer."""
    import pickle

    import torch

    from ray_tpu_torch._private import serialization

    assert not torch.cuda.is_available()
    tensors = _tensors()
    sv = serialization.serialize({k: _CudaPayload(t)
                                  for k, t in tensors.items()})
    meta = pickle.loads(sv.metadata)
    assert meta["buf_lens"] == [4 << 20]
    data = bytearray(sv.to_bytes())
    out = serialization.deserialize(sv.metadata, memoryview(data))
    for k, t in tensors.items():
        got = out[k]
        assert got.device.type == "cpu" and got.dtype == t.dtype, k
        assert tuple(got.shape) == tuple(t.shape), k
        assert torch.equal(got, t), k  # no NaN among them: bitwise
    before = out["f32"].clone()
    data[-8:] = b"\xff" * 8  # the store's bytes change: the copy does not
    out["f32"].add_(1.0)  # and the tensor is writable
    torch.testing.assert_close(out["f32"], before + 1.0, rtol=0, atol=0)


def test_cuda_payload_keeps_a_leaf_gradient_flag():
    import torch

    from ray_tpu_torch._private import serialization

    leaf = torch.ones(3, requires_grad=True)
    sv = serialization.serialize(_CudaPayload(leaf))
    got = serialization.deserialize(sv.metadata, sv.to_bytes())
    assert got.requires_grad and got.is_leaf
    torch.testing.assert_close(got.detach(), leaf.detach())


def test_cpu_tensor_pickles_in_band_like_the_references_array():
    """Host side the two packages agree: a 4 MiB CPU tensor pickles in-band
    (torch's storage blob), as the reference's ``jax.Array`` does; the same
    bytes as numpy take one out-of-band buffer in both."""
    import pickle

    import jax.numpy as jnp
    import torch

    from ray_tpu._private import serialization as ref
    from ray_tpu_torch._private import serialization

    arr = np.random.default_rng(0).standard_normal((1024, 1024),
                                                   dtype=np.float32)

    def oob(mod, value):
        return len(pickle.loads(mod.serialize(value).metadata)["buf_lens"])

    assert oob(serialization, torch.from_numpy(arr)) == 0
    assert oob(ref, jnp.asarray(arr)) == 0
    assert oob(serialization, arr) == oob(ref, arr) == 1
    sv = serialization.serialize(torch.from_numpy(arr))
    got = serialization.deserialize(sv.metadata, sv.to_bytes())
    assert torch.equal(got, torch.from_numpy(arr))


def test_card_hidden_reader_gets_a_cuda_tensors_values(port_cluster):
    """An actor with the card hidden (``CUDA_VISIBLE_DEVICES=""``, as every
    RLlib env runner starts) reads a CUDA tensor's payload from the store
    as a CPU tensor with its values (``chip_smoke.py`` phase 36 puts real
    CUDA tensors)."""
    import torch

    port_cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=port_cluster.address)

    @ray_tpu_torch.remote(num_gpus=0,
                          runtime_env={"env_vars": {"CUDA_VISIBLE_DEVICES": ""}})
    class Reader:
        def read(self, refs):
            import torch as th

            import ray_tpu_torch as port

            out = port.get(refs[0])
            return (th.cuda.is_available(),
                    {k: (v.device.type, v.dtype, v) for k, v in out.items()})

    tensors = _tensors()
    ref = ray_tpu_torch.put({k: _CudaPayload(t) for k, t in tensors.items()})
    visible, got = ray_tpu_torch.get(Reader.remote().read.remote([ref]),
                                     timeout=60)
    assert visible is False
    for k, t in tensors.items():
        dev, dtype, v = got[k]
        assert dev == "cpu" and dtype == t.dtype, k
        assert torch.equal(v, t), k
