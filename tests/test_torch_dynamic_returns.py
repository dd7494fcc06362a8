"""The port's counterpart of ``tests/test_dynamic_returns.py`` (6 cases),
through ``ray_tpu_torch`` on the port's own clusters
(``tests/torch_fixtures.py``) with the reference's expected values: every
case is carried under its own name;
``test_dynamic_item_lineage_reconstruction`` stays in the slow lane, as the
reference's does.

The reference's description:

num_returns="dynamic": generator tasks yield a variable number of
objects; the visible ref resolves to the per-item ObjectRefs
(ray parity: task_manager.h:96 ObjectRefStream / dynamic generators).
"""

import numpy as np
import pytest

import ray_tpu_torch

from tests.torch_fixtures import port_regular  # noqa: F401


@ray_tpu_torch.remote(num_returns="dynamic")
def splitter(n):
    for i in range(n):
        # big enough that items always go to plasma
        yield np.full(64 * 1024, i, dtype=np.uint8)


def test_dynamic_returns_roundtrip(port_regular):
    ref = splitter.remote(5)
    item_refs = ray_tpu_torch.get(ref, timeout=60)
    assert isinstance(item_refs, list) and len(item_refs) == 5
    for i, r in enumerate(item_refs):
        arr = ray_tpu_torch.get(r, timeout=60)
        assert arr.shape == (64 * 1024,) and int(arr[0]) == i


def test_dynamic_returns_empty_and_list(port_regular):
    assert ray_tpu_torch.get(splitter.remote(0), timeout=60) == []

    @ray_tpu_torch.remote(num_returns="dynamic")
    def from_list():
        return [b"a" * 200_000, b"b" * 200_000]  # plain iterable works too

    refs = ray_tpu_torch.get(from_list.remote(), timeout=60)
    assert [ray_tpu_torch.get(r, timeout=60)[:1] for r in refs] == [b"a", b"b"]


@pytest.mark.slow  # ~60s of reconstruction timeouts: slow lane (tier-1 budget)
def test_dynamic_item_lineage_reconstruction(port_regular):
    """Deleting a dynamic item's plasma file behind the runtime triggers
    re-execution of the producing task (lineage adopted by the caller)."""
    import os

    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch._private import object_store

    ref = splitter.remote(3)
    item_refs = ray_tpu_torch.get(ref, timeout=60)
    target = item_refs[1]
    # drop the backing copy (slab entry or .obj file) behind the runtime
    store_dir = global_worker.core_worker.store_dir
    assert object_store.object_exists(store_dir, target.id())
    assert object_store.discard_local(store_dir, target.id())
    arr = ray_tpu_torch.get(target, timeout=120)
    assert int(arr[0]) == 1 and arr.shape == (64 * 1024,)


def test_dynamic_generator_error_surfaces_and_cleans_up(port_regular):
    import glob
    import os

    from ray_tpu_torch._private.worker import global_worker

    @ray_tpu_torch.remote(num_returns="dynamic", max_retries=0)
    def bad(n):
        for i in range(n):
            yield np.full(64 * 1024, i, dtype=np.uint8)
        raise RuntimeError("boom after yields")

    import pytest

    from ray_tpu_torch._private.serialization import TaskError

    ref = bad.remote(3)
    with pytest.raises(TaskError, match="boom"):
        ray_tpu_torch.get(ref, timeout=60)
    # partial items were unlinked, not orphaned, on the executing node
    store_dir = global_worker.core_worker.store_dir
    tid_hex = ref.id().task_id().binary().hex()
    leftovers = [p for p in glob.glob(os.path.join(store_dir, "*"))
                 if tid_hex in os.path.basename(p)]
    assert leftovers == [], leftovers


def test_dynamic_nested_ref_in_item_survives(port_regular):
    inner = ray_tpu_torch.put(b"payload" * 50_000)

    @ray_tpu_torch.remote(num_returns="dynamic")
    def wrap(rl):
        # rl is a container, so rl[0] stays an ObjectRef (top-level args
        # are materialized; nested refs travel as refs)
        yield {"inner": rl[0]}

    refs = ray_tpu_torch.get(wrap.remote([inner]), timeout=60)
    item = ray_tpu_torch.get(refs[0], timeout=60)
    del inner  # only the nested ref inside the item keeps it alive now
    import gc

    gc.collect()
    assert ray_tpu_torch.get(item["inner"], timeout=60)[:7] == b"payload"


def test_dynamic_rejected_for_actor_methods(port_regular):
    import pytest

    @ray_tpu_torch.remote
    class A:
        def gen(self):
            yield 1

    a = A.remote()
    with pytest.raises(ValueError, match="not supported for actor"):
        a.gen.options(num_returns="dynamic")
    ray_tpu_torch.kill(a)
