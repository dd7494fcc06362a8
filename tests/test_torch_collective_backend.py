"""The port's counterpart of ``tests/test_collective_backend.py`` (18 cases),
through ``ray_tpu_torch`` on the port's own clusters
(``tests/torch_fixtures.py``) with the reference's expected values: every
case is carried, all but one under its own name:
``test_jax_trainer_overlap_grads_e2e`` is
``test_torch_trainer_overlap_grads_e2e``, ``TorchTrainer`` over a gloo
process group with the same loop and checks. The ``fake_cw`` fixture is the
port's own (a threaded fake KV in place of the port's GCS).
``test_wire_codec_equals_the_reference`` and
``test_chunk_layout_equals_the_reference`` hold the wire codec and the
chunk schedule to the reference's on the same inputs.

The reference's description:

Collective backend beyond parity: chunked + quantized + straggler levers.

Covers the three config-flagged transport levers end to end:

- Chunked reduce-scatter+allgather correctness against numpy references
  (all ops, uneven shapes, int dtypes) on a threaded fake-KV world.
- The int8 quantization harness: error within the analytic per-block
  bound, bit-identical results on every rank, exact full-precision
  fallback for non-SUM/MEAN, and the wire-vs-logical byte accounting.
- Straggler scheduling units (fetch-order reordering off/on threshold,
  EWMA folding) and the flags-off pin: with all three levers disabled
  the store path is byte-identical to the monolithic exchange.
- Abort and epoch interplay: abort_group unwedges a mid-chunk wait with
  CollectiveWorldChangedError, epoch re-formation cannot join a dead
  generation's chunk sub-keys, and rank-0 seq GC covers chunk keys.
- Steptrace: a chunked op merges to ONE collective row per (group, seq)
  with chunk records riding alongside; e2e 2-worker TorchTrainer with
  overlap_grads=True shows collective spans interleaved with compute
  phase spans.
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import steptrace
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch._private.rpcio import EventLoopThread
from ray_tpu_torch.util.collective import CollectiveWorldChangedError
from ray_tpu_torch.util.collective import collective as colmod

from tests.torch_fixtures import port_regular  # noqa: F401

pytestmark = pytest.mark.collective


# ---------------------------------------------------------------------------
# fake core worker: dict-backed KV behind the real async rendezvous path
# ---------------------------------------------------------------------------


class _FakeGcs:
    def __init__(self, kv, lock):
        self.kv, self.lock = kv, lock

    async def request(self, method, p):
        with self.lock:
            if method == "kv_put":
                self.kv[p["key"]] = p["value"]
                return {"added": True}
            if method == "kv_get":
                return self.kv.get(p["key"])
            if method == "kv_del":
                doomed = [k for k in self.kv if k.startswith(p["key"])]
                for k in doomed:
                    del self.kv[k]
                return {"deleted": len(doomed)}
            raise ValueError(method)


class _FakeCw:
    def __init__(self, kv, lock, io):
        self.gcs = _FakeGcs(kv, lock)
        self.io = io


@pytest.fixture
def fake_cw(monkeypatch):
    kv, lock = {}, threading.Lock()
    io = EventLoopThread(name="col-test-io")
    cw = _FakeCw(kv, lock, io)
    monkeypatch.setattr(colmod, "_cw", lambda: cw)
    old = (cfg.collective_chunk_bytes, cfg.collective_quant,
           cfg.collective_straggler_threshold)
    yield kv
    cfg.update({"collective_chunk_bytes": old[0],
                "collective_quant": old[1],
                "collective_straggler_threshold": old[2]})
    io.loop.call_soon_threadsafe(io.loop.stop)


def _run_world(world, arrays, op, quant="", chunk_bytes=1024, name="cb",
               seq=1, timeout=30.0):
    """Run one chunked allreduce across ``world`` threaded ranks; returns
    [(result, tel)] per rank."""
    cfg.update({"collective_chunk_bytes": chunk_bytes})
    results, errs = [None] * world, [None] * world

    def worker(r):
        g = colmod._Group(name, world, r, "store")
        try:
            tel = {"wire": 0, "logical": 0}
            out = colmod._chunked_allreduce(g, arrays[r], op, timeout, seq,
                                            tel, quant)
            results[r] = (out, tel)
        except BaseException as e:  # surfaced to the test thread
            errs[r] = e

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    for e in errs:
        if e is not None:
            raise e
    return results


_REF = {"sum": lambda s: np.sum(s, axis=0),
        "mean": lambda s: np.mean(s, axis=0),
        "product": lambda s: np.prod(s, axis=0),
        "min": lambda s: np.min(s, axis=0),
        "max": lambda s: np.max(s, axis=0)}


# ---------------------------------------------------------------------------
# chunked transport correctness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("op", ["sum", "mean", "product", "min", "max"])
def test_chunked_matches_reference(fake_cw, world, op):
    rng = np.random.RandomState(hash((world, op)) % 2**31)
    arrays = [rng.randn(61, 7).astype(np.float32) for _ in range(world)]
    ref = _REF[op](np.stack(arrays))
    for r, (out, tel) in enumerate(
            _run_world(world, arrays, op, chunk_bytes=256,
                       name=f"ref-{world}-{op}")):
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        # full precision: every byte on the wire is a logical byte
        assert tel["wire"] == tel["logical"] > 0


@pytest.mark.parametrize("world,depth", [(4, 2), (6, 4)])
def test_deep_world_no_window_deadlock(fake_cw, world, depth):
    """Regression: with world - 1 > pipeline depth, a SHARED in-order
    fetch window fills up with reduced-chunk waits (which only complete
    after their owner finalizes) before all contribution fetches are
    submitted; no owner ever collects its W-1 contributions and every
    rank blocks until the rendezvous timeout. The per-kind windows must
    complete promptly at any world size, including depth 4 (the
    default) at world 6."""
    old_depth = cfg.collective_pipeline_depth
    cfg.update({"collective_pipeline_depth": depth})
    try:
        rng = np.random.RandomState(world * 31 + depth)
        arrays = [rng.randn(257).astype(np.float32) for _ in range(world)]
        t0 = time.monotonic()
        outs = _run_world(world, arrays, "sum", chunk_bytes=64,
                          name=f"deep-{world}-{depth}", timeout=20.0)
        assert time.monotonic() - t0 < 15.0, "chunk windows wedged"
        ref = np.sum(np.stack(arrays), axis=0)
        for out, _ in outs:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    finally:
        cfg.update({"collective_pipeline_depth": old_depth})


def test_chunked_int_mean_promotes_like_numpy(fake_cw):
    arrays = [np.arange(10, dtype=np.int64),
              np.arange(10, dtype=np.int64) * 3]
    outs = _run_world(2, arrays, "mean", chunk_bytes=32, name="imean")
    np.testing.assert_allclose(outs[0][0], np.mean(np.stack(arrays), axis=0))


def test_chunk_layout_uniform_schedule():
    # shards cover [0, n) exactly once; every rank gets >=1 chunk even
    # when its shard is empty, so the rendezvous key schedule matches
    for n, world, ce in [(100, 4, 7), (3, 8, 2), (0, 2, 4), (64, 2, 0)]:
        plan = colmod._chunk_layout(n, world, ce)
        assert len(plan) == world
        spans = [s for pl in plan for s in pl]
        covered = sorted((a, b) for a, b in spans if a < b)
        pos = 0
        for a, b in covered:
            assert a == pos
            pos = b
        assert pos == n
        assert all(len(pl) >= 1 for pl in plan)
        if ce > 0:
            assert all(b - a <= ce for a, b in spans)


# ---------------------------------------------------------------------------
# int8 quantization harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shape", [(1,), (33,), (257, 3)])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_quant_error_within_analytic_bound(fake_cw, world, shape, op):
    rng = np.random.RandomState(hash((world, shape, op)) % 2**31)
    arrays = [(rng.randn(*shape) * (r + 1)).astype(np.float32)
              for r in range(world)]
    outs = _run_world(world, arrays, op, quant="int8", chunk_bytes=512,
                      name=f"q-{world}-{len(shape)}-{shape[0]}-{op}")
    ref = _REF[op](np.stack(arrays))
    out0 = outs[0][0]
    # bit-identical on every rank: peers and owner decode the SAME
    # requantized wire form
    for out, _ in outs[1:]:
        assert np.array_equal(out0, out)
    # analytic per-block bound: each contribution rounds within scale/2,
    # plus one rounding of the reduced value (MEAN divides it all by W)
    err = np.abs(out0 - ref).max()
    scales = [np.abs(a).max() / 127.0 for a in arrays]
    red = np.sum(np.stack(arrays), axis=0)
    bound = 0.5 * sum(scales) + 0.5 * np.abs(red).max() / 127.0 + 1e-7
    if op == "mean":
        bound /= world
    assert err <= bound, (err, bound)


def test_quant_zero_block_exact(fake_cw):
    arrays = [np.zeros(100, np.float32), np.zeros(100, np.float32)]
    outs = _run_world(2, arrays, "sum", quant="int8", name="qzero")
    assert np.array_equal(outs[0][0], np.zeros(100, np.float32))


def test_quant_wire_bytes_shrink(fake_cw):
    # big enough that int8 payloads dominate headers: >=70% wire savings
    arrays = [np.random.RandomState(r).randn(65536).astype(np.float32)
              for r in range(2)]
    outs = _run_world(2, arrays, "sum", quant="int8", chunk_bytes=1 << 15,
                      name="qwire")
    for _, tel in outs:
        assert tel["wire"] <= 0.3 * tel["logical"], tel


def test_quant_encode_decode_roundtrip_properties():
    rng = np.random.RandomState(7)
    x = rng.randn(1000).astype(np.float32) * 42
    q, sc = colmod._quant_encode(x)
    assert q.dtype == np.int8 and q.min() >= -127 and q.max() <= 127
    deq = colmod._quant_decode(q, sc)
    assert np.abs(deq - x).max() <= sc / 2 + 1e-7
    # re-encoding an already-quantized grid is lossless
    q2, sc2 = colmod._quant_encode(deq)
    assert np.array_equal(colmod._quant_decode(q2, sc2), deq)


# ---------------------------------------------------------------------------
# straggler scheduling units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((1,), 1.0), ((33,), 1e-3),
                                         ((257, 3), 50.0), ((4096,), 0.0)])
def test_wire_codec_equals_the_reference(shape, scale):
    """The same block through both packages' int8 codec gives the same
    int8 values, the same scale and the same wire bytes; full precision
    too, and both decode each other's wire form."""
    from ray_tpu.util.collective import collective as ref

    arr = (np.random.RandomState(len(shape) * 7 + shape[0]).randn(*shape)
           * scale).astype(np.float32)
    (q, sc), (rq, rsc) = colmod._quant_encode(arr), ref._quant_encode(arr)
    assert sc == rsc and np.array_equal(q, rq)
    assert np.array_equal(colmod._quant_decode(q, sc),
                          ref._quant_decode(rq, rsc))
    for quant in ("", "int8"):
        mine, theirs = colmod._enc_tensor(arr, quant), ref._enc_tensor(
            arr, quant)
        assert [bytes(b) for b in mine.buffers] == \
            [bytes(b) for b in theirs.buffers]
        got, hd = colmod._dec_tensor(colmod.BufferList(theirs.buffers))
        want, rhd = ref._dec_tensor(ref.BufferList(mine.buffers))
        assert hd == rhd and np.array_equal(got, want)


@pytest.mark.parametrize("n,world,chunk", [(1, 2, 4), (1000, 2, 64),
                                           (1001, 3, 100), (65536, 4, 4096)])
def test_chunk_layout_equals_the_reference(n, world, chunk):
    from ray_tpu.util.collective import collective as ref

    assert colmod._chunk_layout(n, world, chunk) == \
        ref._chunk_layout(n, world, chunk)


def test_fetch_order_fifo_until_threshold(fake_cw):
    g = colmod._Group("fo", 4, 0, "store")
    peers = [1, 2, 3]
    cfg.update({"collective_straggler_threshold": 0.01})
    assert colmod._fetch_order(g, peers) == ([1, 2, 3], [])  # no lag data
    g.peer_lag = {1: 0.002, 2: 0.009, 3: 0.0}
    assert colmod._fetch_order(g, peers) == ([1, 2, 3], [])  # under thr
    g.peer_lag = {1: 0.002, 2: 0.2, 3: 0.0}
    # the straggler's chunks are deferred globally, not just reordered
    assert colmod._fetch_order(g, peers) == ([1, 3], [2])
    g.peer_lag = {1: 0.3, 2: 0.2, 3: 0.0}
    # multiple stragglers defer least-laggy first
    assert colmod._fetch_order(g, peers) == ([3], [2, 1])
    cfg.update({"collective_straggler_threshold": 0.0})
    assert colmod._fetch_order(g, peers) == ([1, 2, 3], [])  # 0 = FIFO


def test_straggler_ewma_learns_from_local_wait_times(fake_cw):
    """Lag is learned from how long THIS rank sat blocked on a peer's
    contribution chunks (receiver clock only) — a peer entering the op
    late shows up as a long max cc wait, with no cross-host timestamp
    comparison."""
    arrays = [np.random.RandomState(r).randn(4096).astype(np.float32)
              for r in range(2)]
    cfg.update({"collective_straggler_threshold": 0.005})
    results, errs = [None] * 2, [None] * 2
    groups = [colmod._Group("ewma", 2, r, "store") for r in range(2)]

    def worker(r):
        if r == 1:
            time.sleep(0.25)  # rank 1 arrives late: a straggler
        try:
            tel = {"wire": 0, "logical": 0}
            results[r] = colmod._chunked_allreduce(
                groups[r], arrays[r], "sum", 30.0, 1, tel)
        except BaseException as e:
            errs[r] = e

    threads = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
    # shallow window + many chunks: once the late rank publishes its
    # burst, every chunk AFTER the window refills completes instantly —
    # only the max cc wait still carries the arrival-lateness signal
    old_depth = cfg.collective_pipeline_depth
    cfg.update({"collective_chunk_bytes": 1024,
                "collective_pipeline_depth": 2})
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        cfg.update({"collective_pipeline_depth": old_depth})
    assert not any(errs), errs
    np.testing.assert_allclose(results[0], np.sum(np.stack(arrays), axis=0),
                               rtol=1e-5)
    # rank 0 sat blocked on rank 1's chunks for ~the sleep -> learned lag
    assert groups[0].peer_lag.get(1, 0.0) > 0.05
    # ...which flips its next fetch order to straggler-last (trivially
    # [1] at world 2, but the EWMA is now over threshold)
    assert max(groups[0].peer_lag.values()) > \
        cfg.collective_straggler_threshold


# ---------------------------------------------------------------------------
# abort, epoch isolation, seq GC
# ---------------------------------------------------------------------------


def test_abort_unwedges_mid_chunk_wait(fake_cw):
    """A rank blocked mid-chunk (peer never publishes) fails over with
    the typed world-changed error as soon as the abort marker lands —
    not after the full rendezvous timeout."""
    g = colmod._Group("ab", 2, 0, "store")
    err = [None]

    def lone_rank():
        try:
            colmod._chunked_allreduce(
                g, np.ones(4096, np.float32), "sum", 60.0, 1,
                {"wire": 0, "logical": 0})
        except BaseException as e:
            err[0] = e

    cfg.update({"collective_chunk_bytes": 1024})
    t = threading.Thread(target=lone_rank)
    t.start()
    time.sleep(0.3)  # let it wedge on rank 1's first contribution chunk
    abort_key = g.keybase.encode() + colmod._ABORT_SUFFIX
    fake_cw[abort_key] = b"1"
    t.join(10)
    assert not t.is_alive(), "abort marker did not unwedge the chunk wait"
    assert isinstance(err[0], CollectiveWorldChangedError), err[0]


def test_epoch_isolates_chunk_subkeys(fake_cw):
    """A re-formed generation's chunk rendezvous cannot join the dead
    generation's chunk sub-seq keys: the whole chunk keyspace hangs off
    the epoch-qualified keybase."""
    stale = f"{colmod._keybase('eg', 0)}:1:cc:0:0:1".encode()
    fake_cw[stale] = b"dead-generation-chunk"
    g1 = colmod._Group("eg", 2, 0, "store", epoch=1)
    fresh = f"{g1.keybase}:1:cc:0:0:1".encode()
    assert fresh != stale
    with pytest.raises(TimeoutError):
        colmod._cw().io.run(
            colmod._akv_wait(colmod._cw(), fresh, timeout=0.2))


def test_rank0_seq_gc_covers_chunk_keys(fake_cw):
    """Chunk sub-keys live under the op's seq prefix, so the existing
    rank-0 GC of seq-1 reclaims them with no extra bookkeeping."""
    arrays = [np.random.RandomState(r).randn(512).astype(np.float32)
              for r in range(2)]
    _run_world(2, arrays, "sum", chunk_bytes=256, name="gc", seq=1)
    assert any(b":1:" in k for k in fake_cw), "seq-1 chunk keys missing"
    _run_world(2, arrays, "sum", chunk_bytes=256, name="gc", seq=2)
    leaked = [k for k in fake_cw if k.startswith(b"gc@0:1:")]
    assert not leaked, leaked


# ---------------------------------------------------------------------------
# live cluster: routing, flags-off pin, steptrace join
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote
class ChunkWorker:
    def _rt_init_collective(self, world_size, rank, backend, group_name,
                            epoch=0, quant=""):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world_size, rank, backend, group_name,
                                  epoch=epoch, quant=quant)
        return rank

    def set_cfg(self, updates):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        GLOBAL_CONFIG.update(updates)
        return True

    def do_allreduce(self, arr, group_name, op="sum"):
        from ray_tpu_torch.util import collective as col

        return col.allreduce(np.array(arr), group_name, op=op)

    def trace_records(self, group_name):
        from ray_tpu_torch._private import steptrace as st

        return [r for r in st.snapshot() if r.get("group") == group_name]


def _pair(workers, arrays, group, op="sum"):
    return ray_tpu_torch.get(
        [w.do_allreduce.remote(a, group, op)
         for w, a in zip(workers, arrays)], timeout=60)


def test_flags_off_pin_byte_identical(port_regular):
    """chunk=0, quant off, threshold=0 must reproduce the monolithic
    exchange bit for bit: same accumulation order, no chunk records,
    wire == logical."""
    from ray_tpu_torch.util import collective as col

    workers = [ChunkWorker.remote() for _ in range(2)]
    ray_tpu_torch.get([w.set_cfg.remote({"collective_chunk_bytes": 0,
                                   "collective_quant": "",
                                   "collective_straggler_threshold": 0.0})
                 for w in workers], timeout=30)
    col.create_collective_group(workers, 2, [0, 1], backend="store",
                                group_name="pin")
    rng = np.random.RandomState(3)
    arrays = [rng.randn(4096).astype(np.float32) for _ in range(2)]
    outs = _pair(workers, arrays, "pin")
    # the monolithic path stacks rank-ordered contributions and reduces
    # with the numpy ufunc — byte-identical, not merely allclose
    expected = np.sum(np.stack(arrays), axis=0)
    for out in outs:
        assert np.array_equal(out, expected)
    recs = ray_tpu_torch.get(workers[0].trace_records.remote("pin"), timeout=30)
    assert [r for r in recs if r["kind"] == "coll"]
    assert not [r for r in recs if r["kind"] == "chunk"]
    for r in recs:
        if r["kind"] == "coll":
            assert r["wire"] == r["logical"]


def test_chunked_merges_to_one_coll_row(port_regular):
    """A chunked op is still ONE collective on the observability plane:
    per-rank records join by (group, seq) into a single row, with the
    chunk records riding alongside on their own kind."""
    from ray_tpu_torch.util import collective as col

    workers = [ChunkWorker.remote() for _ in range(2)]
    ray_tpu_torch.get([w.set_cfg.remote({"collective_chunk_bytes": 512})
                 for w in workers], timeout=30)
    col.create_collective_group(workers, 2, [0, 1], backend="store",
                                group_name="onerow")
    rng = np.random.RandomState(5)
    arrays = [rng.randn(2048).astype(np.float32) for _ in range(2)]
    outs = _pair(workers, arrays, "onerow")
    np.testing.assert_allclose(outs[0], np.sum(np.stack(arrays), axis=0),
                               rtol=1e-5)
    recs = []
    for w in workers:
        recs.extend(ray_tpu_torch.get(w.trace_records.remote("onerow"),
                                timeout=30))
    rows = steptrace.merge_collectives(recs)
    assert len(rows) == 1, rows
    row = rows[0]
    assert set(row["ranks"]) == {0, 1} and row["missing"] == []
    assert row["skew"] >= 0.0
    # both ranks moved real bytes, and the transport measured them
    for r in row["ranks"].values():
        assert r["wire"] > 0 and r["logical"] >= r["wire"]
    chunk_recs = [r for r in recs if r["kind"] == "chunk"]
    assert len(chunk_recs) >= 2 * 4  # >=4 chunks per rank at 512B/2048el
    assert {r["seq"] for r in chunk_recs} == {row["seq"]}


def test_quant_group_non_sum_mean_stays_exact(port_regular):
    """quant="int8" groups only quantize SUM/MEAN floats; MAX (and int
    dtypes) must come back in exact full precision."""
    from ray_tpu_torch.util import collective as col

    workers = [ChunkWorker.remote() for _ in range(2)]
    col.create_collective_group(workers, 2, [0, 1], backend="store",
                                group_name="qg", quant="int8")
    rng = np.random.RandomState(11)
    arrays = [rng.randn(512).astype(np.float32) for _ in range(2)]
    outs = _pair(workers, arrays, "qg", op="max")
    expected = np.max(np.stack(arrays), axis=0)
    for out in outs:
        assert np.array_equal(out, expected)
    # while SUM on the same group IS quantized: tiny but nonzero error
    souts = _pair(workers, arrays, "qg", op="sum")
    sref = np.sum(np.stack(arrays), axis=0)
    np.testing.assert_allclose(souts[0], sref, atol=0.1)
    assert not np.array_equal(souts[0], sref)


def test_create_group_rejects_unknown_quant(port_regular):
    from ray_tpu_torch.util import collective as col

    with pytest.raises(ValueError):
        col.create_collective_group([], 0, [], backend="store",
                                    group_name="bad", quant="fp4")


# ---------------------------------------------------------------------------
# e2e: TorchTrainer(overlap_grads=True) interleaves collectives w/ compute
# ---------------------------------------------------------------------------


def test_torch_trainer_overlap_grads_e2e(port_regular, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.util import state

    def loop(config):
        import time as _time

        import numpy as np

        from ray_tpu_torch import train as train_mod
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        GLOBAL_CONFIG.update({"collective_chunk_bytes": 4096})
        ctx = train_mod.get_context()
        rank = ctx.get_world_rank()
        for step in range(3):
            grad = np.full((8192,), float(rank + step), np.float32)
            with train_mod.GradSync() as gs:
                with train_mod.step_phase("compute"):
                    gs.submit("g", grad)
                    # the rest of the "backward": overlap happens here
                    _time.sleep(0.3)
                reduced = gs.results()["g"]
            train_mod.report({"step": step, "g0": float(reduced[0])})

    trainer = train.TorchTrainer(
        loop,
        torch_config=train.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False),
        overlap_grads=True,
        run_config=train.RunConfig(name="t_overlap",
                                   storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None, result.error

    merged = state.steptrace_summary()
    rows = [c for c in merged["collectives"] if c["group"] == "train_dp"]
    assert rows, merged["collectives"]
    chunk_recs = [c for c in merged.get("chunks", ())
                  if c["group"] == "train_dp"]
    assert chunk_recs, "chunked gradient allreduce left no chunk records"
    compute = [p for p in merged["phases"] if p["phase"] == "compute"]
    assert compute
    # the overlap claim itself: some rank's gradient collective interval
    # overlaps one of ITS OWN compute phase intervals
    overlapped = False
    for row in rows:
        for rank, iv in row["ranks"].items():
            for ph in compute:
                if int(ph["rank"]) != int(rank):
                    continue
                if iv["start"] < ph["end"] and iv["end"] > ph["start"]:
                    overlapped = True
    assert overlapped, (rows, compute)
