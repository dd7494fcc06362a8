"""The port's util shims (``ActorPool``, ``Queue``, ``multiprocessing.Pool``,
the joblib backend and the dask scheduler) on the CPU, beside the
reference's.

The reference's cases of ``tests/test_util_extras.py`` (the two workflow
cases are in ``tests/test_torch_workflow.py``) and the four dask cases of
``tests/test_util_shims.py`` run through ``ray_tpu_torch`` with their
expected values. The shims' pure parts are also held against the
reference's on the same inputs: dask's ``_toposort`` and its cycle error,
``Pool._chunked``, and ``_QueueActor``'s order under the batch calls.
Callables that travel to workers are made inside functions, so they
travel by value and no worker imports this module.
"""

import asyncio

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue

rt = ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _doubler():
    @rt.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    return Doubler


def _sq_fns():
    def sq(x):
        return x * x

    def first(t):
        return t[0]

    return sq, first


def _graph_fns():
    def add(a, b):
        return a + b

    def inc(x):
        return x + 1

    return add, inc


# ---------------------------------------------------------------------------
# ActorPool (the port's existing util/actor_pool.py)
# ---------------------------------------------------------------------------

def test_actor_pool_map_ordered(cluster):
    Doubler = _doubler()
    pool = ActorPool([Doubler.remote() for _ in range(2)])
    assert list(pool.map(lambda a, v: a.double.remote(v), range(6))) == [
        0, 2, 4, 6, 8, 10,
    ]


def test_actor_pool_unordered_and_queueing(cluster):
    Doubler = _doubler()
    pool = ActorPool([Doubler.remote() for _ in range(2)])
    # More submissions than actors: excess queue and drain via returns.
    out = sorted(pool.map_unordered(lambda a, v: a.double.remote(v), range(5)))
    assert out == [0, 2, 4, 6, 8]
    assert pool.pop_idle() is not None


# ---------------------------------------------------------------------------
# Queue
# ---------------------------------------------------------------------------

def test_queue_basics(cluster):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    assert q.qsize() == 2 and q.full()
    with pytest.raises(Full):
        q.put(3, block=False)
    assert q.get() == 1
    assert q.get() == 2
    assert q.empty()
    with pytest.raises(Empty):
        q.get(block=False)
    with pytest.raises(Empty):
        q.get(timeout=0.2)


def test_queue_blocking_across_tasks(cluster):
    q = Queue()

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return True

    ref = producer.remote(q, 3)
    got = [q.get(timeout=30) for _ in range(3)]
    assert got == [0, 1, 2]
    assert rt.get(ref, timeout=30)


def test_queue_actor_batch_order_equals_the_reference():
    """``_QueueActor`` in-process in both packages: the same calls give the
    same answers in the same order (the batch put is all-or-nothing)."""
    from ray_tpu.util import queue as jqueue
    from ray_tpu_torch.util import queue as tqueue

    async def script(cls):
        a = cls(maxsize=5)
        out = [a.put_nowait_batch([1, 2, 3]),
               a.put_nowait_batch([4, 5, 6]),  # does not fit: nothing goes in
               a.qsize(),
               a.put_nowait(4), a.put_nowait(5), a.put_nowait(6),
               a.full(),
               a.get_nowait_batch(2),
               await a.put(7, timeout=0.05),
               await a.put(8, timeout=0.05),
               await a.get(timeout=0.05),
               a.get_nowait_batch(10),
               a.get_nowait(),
               await a.get(timeout=0.05),
               a.empty()]
        return out

    want = asyncio.run(script(jqueue._QueueActor))
    got = asyncio.run(script(tqueue._QueueActor))
    assert got == want
    assert got[7] == [1, 2] and got[11] == [4, 5, 7, 8]


# ---------------------------------------------------------------------------
# multiprocessing.Pool and the joblib backend
# ---------------------------------------------------------------------------

def test_multiprocessing_pool(cluster):
    from ray_tpu_torch.util.multiprocessing import Pool

    sq, _ = _sq_fns()
    with Pool(processes=2) as pool:
        assert pool.map(sq, range(8)) == [x * x for x in range(8)]
        assert pool.apply(sq, (5,)) == 25
        r = pool.apply_async(sq, (6,))
        assert r.get(timeout=60) == 36
        assert sorted(pool.imap_unordered(sq, range(4))) == [0, 1, 4, 9]
        assert list(pool.imap(sq, range(4))) == [0, 1, 4, 9]
        assert pool.starmap(pow, [(2, 3), (3, 2)]) == [8, 9]


def test_multiprocessing_pool_tuple_items(cluster):
    """map passes each item as ONE argument (stdlib contract): tuple items
    must not be star-unpacked."""
    from ray_tpu_torch.util.multiprocessing import Pool

    _, first = _sq_fns()
    with Pool(processes=2) as pool:
        assert pool.map(sum, [(1, 2), (3, 4)]) == [3, 7]
        assert pool.map(first, [(1, 2), (3, 4)]) == [1, 3]
        assert list(pool.imap(first, [(9, 0)])) == [9]


@pytest.mark.parametrize("n_items,size,chunksize", [
    (0, 2, None), (7, 2, None), (8, 2, None), (100, 3, None), (13, 4, 5),
    (5, 1, 1), (40, 2, 7),
])
def test_pool_chunks_equal_the_reference(n_items, size, chunksize):
    """``Pool._chunked`` cuts the same chunks as the reference's."""
    from ray_tpu.util.multiprocessing import Pool as JPool
    from ray_tpu_torch.util.multiprocessing import Pool as TPool

    def chunks(cls):
        pool = cls.__new__(cls)  # no actors: _chunked reads only the size
        pool._size = size
        return pool._chunked(range(n_items), chunksize)

    assert chunks(TPool) == chunks(JPool)


def test_joblib_backend(cluster):
    import joblib

    from ray_tpu_torch.util.joblib import register_ray

    sq, _ = _sq_fns()
    register_ray()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
        out = joblib.Parallel()(joblib.delayed(sq)(i) for i in range(6))
    assert out == [0, 1, 4, 9, 16, 25]


# ---------------------------------------------------------------------------
# dask graphs (tests/test_util_shims.py)
# ---------------------------------------------------------------------------

def test_dask_graph_executes(cluster):
    from ray_tpu_torch.util.dask import ray_dask_get

    add, inc = _graph_fns()
    dsk = {
        "a": 1,
        "b": (inc, "a"),          # 2
        "c": (inc, "b"),          # 3
        "d": (add, "b", "c"),     # 5
        "e": (add, "d", 10),      # 15
    }
    assert ray_dask_get(dsk, "e") == 15
    assert ray_dask_get(dsk, ["b", "d", "e"]) == [2, 5, 15]


def test_dask_nested_lists_and_tasks(cluster):
    from ray_tpu_torch.util.dask import ray_dask_get

    add, inc = _graph_fns()
    dsk = {
        "xs": [1, 2, 3],
        "sum": (sum, "xs"),
        "both": (add, (inc, 4), "sum"),  # inline nested task: 5 + 6
    }
    assert ray_dask_get(dsk, "both") == 11


def test_dask_nested_task_with_key_args(cluster):
    from ray_tpu_torch.util.dask import ray_dask_get

    add, inc = _graph_fns()
    dsk = {
        "a": (inc, 1),                    # 2
        "b": (add, (inc, "a"), 1),        # nested task referencing a key
        "lst": ["a"],                     # list-of-keys graph value
    }
    assert ray_dask_get(dsk, "b") == 4
    assert ray_dask_get(dsk, "lst") == [2]


def test_dask_cycle_detected(cluster):
    from ray_tpu_torch.util.dask import ray_dask_get

    _, inc = _graph_fns()
    dsk = {"a": (inc, "b"), "b": (inc, "a")}
    with pytest.raises(ValueError, match="cycle"):
        ray_dask_get(dsk, "a")


def _graphs():
    add, inc = _graph_fns()
    return {
        "chain": {"a": 1, "b": (inc, "a"), "c": (add, "a", "b"),
                  "d": (add, "b", "c"), "e": (sum, ["b", "c", "d", "d"])},
        "reversed": {"e": (sum, ["d", "c"]), "d": (add, "c", "b"),
                     "c": (inc, "b"), "b": (inc, "a"), "a": 0},
        "nested": {"xs": [1, 2, 3], "sum": (sum, "xs"),
                   "both": (add, "sum", (sum, [1, 2, 2])),
                   "k": (add, (inc, "sum"), ("xs", "both"))},
        "unhashable": {"a": (sum, [[1], {"x": 1}]), "b": (inc, "a")},
    }


@pytest.mark.parametrize("name", ["chain", "reversed", "nested",
                                  "unhashable"])
def test_dask_toposort_equals_the_reference(name):
    from ray_tpu.util.dask import _toposort as jtoposort
    from ray_tpu_torch.util.dask import _toposort as ttoposort

    dsk = _graphs()[name]
    assert ttoposort(dsk) == jtoposort(dsk)


@pytest.mark.parametrize("dsk_keys", [("a", "b"), ("x", "y", "z")])
def test_dask_cycle_error_equals_the_reference(dsk_keys):
    from ray_tpu.util.dask import _toposort as jtoposort
    from ray_tpu_torch.util.dask import _toposort as ttoposort

    _, inc = _graph_fns()
    # each key depends on the next, the last on the first
    dsk = {k: (inc, dsk_keys[(i + 1) % len(dsk_keys)])
           for i, k in enumerate(dsk_keys)}
    with pytest.raises(ValueError) as want:
        jtoposort(dsk)
    with pytest.raises(ValueError) as got:
        ttoposort(dsk)
    assert str(got.value) == str(want.value)
