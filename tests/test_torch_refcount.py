"""The port's counterpart of ``tests/test_refcount.py`` (5 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name; the two slow cases stay in the slow lane, as the reference's do.

The reference's description:

Distributed reference counting: borrower protocol + lineage reconstruction.

Scenario parity with the reference's reference-count and object-recovery
tests (ray: src/ray/core_worker/test/reference_count_test.cc,
python/ray/tests/test_reconstruction.py):

- an object whose only remaining reference is held by a remote borrower
  stays alive until the borrower drops it, then is freed (no forever-pin);
- a lost plasma object backed by lineage is transparently re-executed.
"""

import gc
import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import object_store
from ray_tpu_torch._private.worker import global_worker

from tests.torch_fixtures import port_regular_fn  # noqa: F401


def _wait_for(pred, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {msg}")


def test_borrower_keeps_object_alive_then_release_frees(port_regular_fn):
    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            self.ref = None

        def hold(self, refs):
            self.ref = refs[0]
            return True

        def peek(self):
            return int(ray_tpu_torch.get(self.ref, timeout=30)[0])

        def drop(self):
            self.ref = None
            gc.collect()
            return True

    cw = global_worker.core_worker
    h = Holder.remote()
    data = np.full(1 << 19, 7, dtype=np.int64)  # 4MB -> plasma
    ref = ray_tpu_torch.put(data)
    oid = ref.binary()
    assert ray_tpu_torch.get(h.hold.remote([ref]), timeout=60)

    # Drop the owner's local ref: the actor's borrow must keep it alive.
    del ref
    gc.collect()
    time.sleep(1.5)
    assert oid in cw._owned, "object freed while a borrower still holds it"
    assert ray_tpu_torch.get(h.peek.remote(), timeout=60) == 7

    # Borrower drops its ref: the owner's poll resolves and the object frees.
    assert ray_tpu_torch.get(h.drop.remote(), timeout=60)
    _wait_for(lambda: oid not in cw._owned, timeout=30,
              msg="object freed after borrower release")


@pytest.mark.slow  # ~63s of reconstruction timeouts: slow lane (tier-1 budget)
def test_lineage_reconstruction_on_lost_object(port_regular_fn, tmp_path):
    marker = str(tmp_path / "runs")

    @ray_tpu_torch.remote
    def produce():
        with open(marker, "a") as f:
            f.write("x")
        return np.arange(1 << 19, dtype=np.float64)  # 4MB -> plasma

    ref = produce.remote()
    v1 = ray_tpu_torch.get(ref, timeout=60)
    assert open(marker).read() == "x"

    cw = global_worker.core_worker
    assert object_store.object_exists(cw.store_dir, ref.id())
    # simulate losing the only plasma copy (slab entry or .obj file)
    assert object_store.discard_local(cw.store_dir, ref.id())

    v2 = ray_tpu_torch.get(ref, timeout=120)
    np.testing.assert_array_equal(v1, v2)
    assert open(marker).read() == "xx", "producing task was not re-executed"


@pytest.mark.slow  # ~62s of reconstruction timeouts: slow lane (tier-1 budget)
def test_put_objects_are_not_reconstructable(port_regular_fn):
    ref = ray_tpu_torch.put(np.zeros(1 << 19, dtype=np.float64))
    v = ray_tpu_torch.get(ref, timeout=60)
    assert v.shape == (1 << 19,)
    cw = global_worker.core_worker
    assert object_store.discard_local(cw.store_dir, ref.id())
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=30)


def test_actor_created_with_ref_arg(port_regular_fn):
    """Actor creation with a pending ObjectRef argument: the creation-args
    pin path must not block the worker's IO loop, and the arg object must
    survive as long as the actor can restart (creation spec replay)."""

    @ray_tpu_torch.remote
    def produce():
        return np.full(1 << 19, 11, dtype=np.int64)

    @ray_tpu_torch.remote(max_restarts=1)
    class Consumer:
        def __init__(self, data):
            self.first = int(data[0])

        def read(self):
            return self.first

    ref = produce.remote()
    c = Consumer.remote(ref)
    assert ray_tpu_torch.get(c.read.remote(), timeout=60) == 11
    # The runtime stays responsive (the deadlock regression froze the loop).
    assert ray_tpu_torch.get(produce.remote(), timeout=60)[0] == 11


def test_borrow_through_returned_container(port_regular_fn):
    """A task returns a dict holding a ref to an object it put: the nested
    object must outlive the task and be fetchable through the container."""

    @ray_tpu_torch.remote
    def make():
        inner = ray_tpu_torch.put(np.full(1 << 19, 3, dtype=np.int64))
        return {"inner": inner}

    box = ray_tpu_torch.get(make.remote(), timeout=60)
    inner_val = ray_tpu_torch.get(box["inner"], timeout=60)
    assert int(inner_val[0]) == 3
