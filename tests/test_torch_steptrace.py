"""The port's counterpart of ``tests/test_steptrace.py`` (26 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried, two under
other names. ``test_jax_trainer_train_timeline_e2e`` is
``test_torch_trainer_train_timeline_e2e`` (``TorchTrainer`` over gloo, the
same loop and checks). ``test_trace_jit_records_first_call_and_recompile``
runs against a callable with ``jax.jit``'s ``_cache_size`` contract, the
one ``trace_jit`` keys on: nothing in the port has one, so on a torch
callable it passes through
(``test_trace_jit_passes_through_a_callable_without_a_cache``), and the
port's compile events are its nvcc builds.
``test_merge_and_trace_equal_the_reference`` runs the same records through
both packages' merge and renderer.

The reference's description:

Step observatory (_private/steptrace.py + the instrumented
util.collective / train.session surfaces): the per-process telemetry
ring, the GCS-side (group, seq) arrival-skew merge, and the merged
multi-rank train timeline.

Fast deterministic tests (tier-1 under the ``steptrace`` marker): ring
bounds + disabled-zero-cost, the merge/skew math (missing ranks,
out-of-order arrival, duplicates, seq wraparound), step_phase/report
step delimiting, trace_jit compile attribution, SkewAggregator
idempotent folds + EWMA straggler scores, the chrome-trace renderer, the
one-tick unattributed-line hold in the raylet tailer, and an e2e
2-worker TorchTrainer run whose merged timeline carries both ranks' step
phases and a nonzero-skew collective record (with the skew metrics
visible on the cluster scrape afterwards).
"""

import json
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import steptrace
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

from tests.torch_fixtures import port_regular  # noqa: F401

pytestmark = pytest.mark.steptrace


@pytest.fixture(autouse=True)
def _fresh_ring():
    steptrace.set_enabled(True)
    steptrace.reset()
    steptrace.clear_train_context()
    yield
    steptrace.set_enabled(True)
    steptrace.reset()
    steptrace.clear_train_context()


# ---------------------------------------------------------------------------
# recorder core
# ---------------------------------------------------------------------------

def test_ring_bounds_and_drop_accounting():
    old = cfg.steptrace_ring_size
    try:
        cfg.update({"steptrace_ring_size": 32})
        steptrace.reset()
        for i in range(100):
            steptrace.record_collective("g", i, "allreduce", 0, 2,
                                        float(i), float(i) + 0.5, 64)
        snap = steptrace.process_snapshot()
        # newest 32 survive, oldest-first order, drops accounted
        assert len(snap["records"]) == 32
        assert snap["dropped"] == 68
        seqs = [r["seq"] for r in snap["records"]]
        assert seqs == list(range(68, 100))
    finally:
        cfg.update({"steptrace_ring_size": old})
        steptrace.reset()


def test_disabled_records_nothing():
    steptrace.record_collective("g", 0, "allreduce", 0, 2, 0.0, 1.0, 8)
    assert len(steptrace.snapshot()) == 1
    before = steptrace.record_calls()
    steptrace.set_enabled(False)
    steptrace.record_collective("g", 1, "allreduce", 0, 2, 0.0, 1.0, 8)
    steptrace.record_phase("compute", 0.0, 1.0)
    steptrace.record_compile("fn", 0.0, 1.0, first=True)
    steptrace.step_mark()
    assert steptrace.record_calls() == before
    assert len(steptrace.snapshot()) == 1  # nothing new landed
    with steptrace.phase("data"):
        pass
    assert len(steptrace.snapshot()) == 1


def test_step_mark_delimits_steps():
    steptrace.set_train_context(rank=3, world=4)
    time.sleep(0.01)
    assert steptrace.step_mark() == 0
    assert steptrace.step_mark() == 1
    steps = [r for r in steptrace.snapshot() if r["kind"] == "step"]
    assert [s["step"] for s in steps] == [0, 1]
    assert all(s["rank"] == 3 for s in steps)
    assert steps[0]["end"] - steps[0]["start"] > 0
    # step 1 starts where step 0 ended
    assert steps[1]["start"] == steps[0]["end"]


def test_phase_context_manager_stamps_step_and_rank():
    steptrace.set_train_context(rank=1, world=2)
    with steptrace.phase("data"):
        pass
    steptrace.step_mark()
    with steptrace.phase("compute"):
        pass
    recs = [r for r in steptrace.snapshot() if r["kind"] == "phase"]
    assert [(r["phase"], r["step"], r["rank"]) for r in recs] == [
        ("data", 0, 1), ("compute", 1, 1)]


def test_cfg_kill_switch_gates_record_paths():
    """cfg steptrace_enabled=False must stop the RECORD paths (not just
    the surfaces), folding in at first ring creation even when the env
    default left the module flag on."""
    old = cfg.steptrace_enabled
    steptrace.reset()
    steptrace._explicit = False  # fresh-process posture: no set_enabled
    steptrace._enabled = True
    try:
        cfg.update({"steptrace_enabled": False})
        steptrace.record_collective("g", 0, "allreduce", 0, 1, 0.0, 1.0, 8)
        steptrace.record_phase("compute", 0.0, 1.0)
        assert steptrace.snapshot() == []
        assert not steptrace.is_enabled()
    finally:
        cfg.update({"steptrace_enabled": old})
        steptrace.set_enabled(True)
        steptrace.reset()


def test_failed_collective_still_records():
    """A rank whose op RAISES (rendezvous timeout: the straggler failure
    this plane diagnoses) still records its arrival + wait, so the merge
    shows the row with the wedged peer missing instead of nothing."""
    from ray_tpu_torch.util.collective import collective as c

    g = c._Group("failgrp", 2, 0, "store")

    def boom(seq, tel):
        time.sleep(0.01)
        raise RuntimeError("peer never arrived")

    with pytest.raises(RuntimeError, match="peer never arrived"):
        c._op(g, "allreduce", 128, boom)
    recs = [r for r in steptrace.snapshot()
            if r["kind"] == "coll" and r["group"] == "failgrp"]
    assert len(recs) == 1
    assert recs[0]["seq"] == 0 and recs[0]["end"] > recs[0]["start"]
    (row,) = steptrace.merge_collectives(recs)
    assert row["missing"] == [1]  # the wedged rank is attributable


# ---------------------------------------------------------------------------
# merge + skew math
# ---------------------------------------------------------------------------

def _coll(group, seq, rank, start, end=None, world=2, op="allreduce",
          nbytes=64, idx=0):
    return {"kind": "coll", "idx": idx, "group": group, "seq": seq,
            "op": op, "rank": rank, "world": world, "start": start,
            "end": start + 0.1 if end is None else end, "bytes": nbytes}


def test_merge_skew_and_last_rank():
    rows = steptrace.merge_collectives([
        _coll("g", 0, 0, 10.0),
        _coll("g", 0, 1, 10.25),   # arrives late -> straggler
        _coll("g", 1, 1, 11.0),
        _coll("g", 1, 0, 11.05),
    ])
    assert len(rows) == 2
    assert rows[0]["seq"] == 0
    assert rows[0]["skew"] == pytest.approx(0.25)
    assert rows[0]["last_rank"] == 1 and rows[0]["first_rank"] == 0
    assert rows[0]["missing"] == []
    assert rows[1]["last_rank"] == 0
    assert rows[1]["skew"] == pytest.approx(0.05)


def test_merge_missing_ranks():
    rows = steptrace.merge_collectives([
        _coll("g", 0, 0, 10.0, world=3),
        _coll("g", 0, 2, 10.5, world=3),
    ])
    (row,) = rows
    assert row["missing"] == [1]
    assert row["skew"] == pytest.approx(0.5)  # over PRESENT ranks
    assert row["last_rank"] == 2


def test_merge_out_of_order_and_duplicates():
    # records arrive scrambled across scrapes; a duplicated (group, seq,
    # rank) keeps the newest arrival
    rows = steptrace.merge_collectives([
        _coll("g", 1, 0, 20.0),
        _coll("g", 0, 1, 10.1),
        _coll("g", 1, 1, 20.3),
        _coll("g", 0, 0, 10.0),
        _coll("g", 0, 0, 10.05),  # duplicate, newer start wins
    ])
    assert [r["seq"] for r in rows] == [0, 1]  # ordered by time, not input
    assert rows[0]["ranks"][0]["start"] == pytest.approx(10.05)
    assert rows[0]["skew"] == pytest.approx(0.05)


def test_merge_seq_wraparound():
    near = steptrace.SEQ_MOD - 1
    rows = steptrace.merge_collectives([
        _coll("g", near, 0, 10.0),
        _coll("g", near, 1, 10.1),
        # both ranks wrapped to 0 for the NEXT op: still one join, and
        # timeline order follows timestamps, not seq magnitude
        _coll("g", steptrace.SEQ_MOD, 0, 11.0),
        _coll("g", 0, 1, 11.2),
    ])
    assert len(rows) == 2
    assert rows[0]["seq"] == near and rows[1]["seq"] == 0
    assert rows[1]["skew"] == pytest.approx(0.2)
    assert rows[1]["missing"] == []


def test_merge_clusters_reused_keys_across_runs():
    """A later run re-initializing the same group restarts at seq 0; its
    records must form their OWN rows (time clustering), not mis-join
    with — or overwrite — the previous run's, which would render minutes
    of wall clock as 'skew'."""
    t2 = 10.0 + 2 * steptrace.JOIN_WINDOW_S  # a later run, well apart
    rows = steptrace.merge_collectives([
        _coll("g", 0, 0, 10.0),
        _coll("g", 0, 1, 10.2),
        _coll("g", 0, 0, t2),        # run 2, same (group, seq)
        _coll("g", 0, 1, t2 + 0.1),
    ])
    assert len(rows) == 2
    assert rows[0]["skew"] == pytest.approx(0.2)
    assert rows[1]["skew"] == pytest.approx(0.1)
    assert all(not r["missing"] for r in rows)
    # a partial overlap (one rank's run-1 record lost to ring overwrite)
    # yields two partial rows, never one row with minutes of skew
    rows = steptrace.merge_collectives([
        _coll("g", 0, 0, 10.0),
        _coll("g", 0, 1, t2),
    ])
    assert len(rows) == 2
    assert all(r["skew"] == 0.0 and len(r["ranks"]) == 1 for r in rows)


def test_aggregator_discards_stale_pending_on_key_reuse():
    """An incomplete pending join from a dead run must not be 'completed'
    by a later run's arrivals (minutes-scale fake skew in the metrics)."""
    reg = _registry()
    agg = steptrace.SkewAggregator(registry=reg)
    agg.fold([_proc("a", 1, [_coll("g", 0, 0, 10.0, idx=0)])])  # run 1, rank 1 never arrives
    t2 = 10.0 + 2 * steptrace.JOIN_WINDOW_S
    done = agg.fold([
        _proc("a", 10, [_coll("g", 0, 0, t2, idx=0)]),
        _proc("b", 11, [_coll("g", 0, 1, t2 + 0.05, idx=0)]),
    ])
    assert done == 1  # run 2's join completes cleanly
    hist = reg.snapshot()["collective_skew_seconds"]
    worst = max((s for s in hist["series"]),
                key=lambda s: s.get("sum", 0.0))
    assert worst["sum"] < 1.0  # no minutes-scale sample leaked in


def test_aggregator_pid_reuse_resets_high_water():
    """A new worker recycling a dead worker's (node, pid) starts its ring
    idx at 0 — below the stale high-water mark. Its snapshot top sitting
    under the mark identifies it as fresh; its records must fold, not be
    discarded as already-seen."""
    agg = steptrace.SkewAggregator(registry=_registry())
    agg.fold([_proc("a", 1, [
        _coll("g", s, 0, 10.0 + s, idx=s) for s in range(50)])])
    assert len(agg.records()) == 50
    # same (node, pid), fresh process: idx restarts at 0
    agg.fold([_proc("a", 1, [_coll("g2", 0, 0, 100.0, idx=0)])])
    assert len(agg.records()) == 51
    assert any(r["group"] == "g2" for r in agg.records())


def test_group_seq_alloc_wraps():
    from ray_tpu_torch.util.collective.collective import _Group

    g = _Group("g", 2, 0, "store")
    g.seq = steptrace.SEQ_MOD - 1
    assert g.alloc_seq() == steptrace.SEQ_MOD - 1
    assert g.alloc_seq() == 0


def test_chrome_trace_renders_ranks_phases_and_skew():
    merged = steptrace.merge_records([
        _coll("g", 0, 0, 10.0),
        _coll("g", 0, 1, 10.2),
        {"kind": "phase", "idx": 1, "step": 0, "phase": "compute",
         "rank": 0, "start": 9.0, "end": 9.5},
        {"kind": "step", "idx": 2, "step": 0, "rank": 0,
         "start": 9.0, "end": 10.4},
        {"kind": "compile", "idx": 3, "name": "train_step", "first": True,
         "rank": 1, "start": 8.0, "end": 8.9},
    ])
    trace = steptrace.chrome_trace(merged)
    names = {e["args"]["name"] for e in trace if e["ph"] == "M"}
    assert names == {"rank 0", "rank 1"}
    slices = [e for e in trace if e["ph"] == "X"]
    by_cat = {}
    for e in slices:
        by_cat.setdefault(e["cat"], []).append(e)
    assert {"step", "phase", "collective", "compile"} <= set(by_cat)
    coll = by_cat["collective"]
    assert {e["pid"] for e in coll} == {0, 1}
    assert all(e["args"]["skew_s"] == pytest.approx(0.2) for e in coll)
    late = next(e for e in coll if e["pid"] == 1)
    assert late["args"]["arrived_last"] is True
    json.dumps(trace)  # Perfetto-loadable: plain JSON all the way down


def _merge_cases():
    t2 = 10.0 + 2 * steptrace.JOIN_WINDOW_S
    near = steptrace.SEQ_MOD - 1
    return {
        "skew": [_coll("g", 0, 0, 10.0), _coll("g", 0, 1, 10.25),
                 _coll("g", 1, 1, 11.0), _coll("g", 1, 0, 11.05)],
        "missing": [_coll("g", 0, 0, 10.0, world=3),
                    _coll("g", 0, 2, 10.5, world=3)],
        "dups": [_coll("g", 1, 0, 20.0), _coll("g", 0, 1, 10.1),
                 _coll("g", 1, 1, 20.3), _coll("g", 0, 0, 10.0),
                 _coll("g", 0, 0, 10.05)],
        "wrap": [_coll("g", near, 0, 10.0), _coll("g", near, 1, 10.1),
                 _coll("g", steptrace.SEQ_MOD, 0, 11.0),
                 _coll("g", 0, 1, 11.2)],
        "reuse": [_coll("g", 0, 0, 10.0), _coll("g", 0, 1, 10.2),
                  _coll("g", 0, 0, t2), _coll("g", 0, 1, t2 + 0.1)],
        "mixed": [_coll("g", 0, 0, 10.0), _coll("g", 0, 1, 10.2),
                  {"kind": "phase", "idx": 1, "step": 0, "phase": "compute",
                   "rank": 0, "start": 9.0, "end": 9.5},
                  {"kind": "step", "idx": 2, "step": 0, "rank": 0,
                   "start": 9.0, "end": 10.4},
                  {"kind": "compile", "idx": 3, "name": "train_step",
                   "first": True, "rank": 1, "start": 8.0, "end": 8.9}],
    }


@pytest.mark.parametrize("case", sorted(_merge_cases()))
def test_merge_and_trace_equal_the_reference(case):
    """The same records through both packages' merge and renderer give
    the same rows and the same trace events."""
    from ray_tpu._private import steptrace as ref

    recs = _merge_cases()[case]
    assert steptrace.SEQ_MOD == ref.SEQ_MOD
    assert steptrace.JOIN_WINDOW_S == ref.JOIN_WINDOW_S
    assert steptrace.merge_collectives([dict(r) for r in recs]) == \
        ref.merge_collectives([dict(r) for r in recs])
    mine = steptrace.merge_records([dict(r) for r in recs])
    theirs = ref.merge_records([dict(r) for r in recs])
    assert mine == theirs
    assert steptrace.chrome_trace(mine) == ref.chrome_trace(theirs)


# ---------------------------------------------------------------------------
# SkewAggregator: idempotent folds, pending joins, EWMA scores
# ---------------------------------------------------------------------------

def _registry():
    from ray_tpu_torch._private import metrics_core

    return metrics_core.Registry()


def _proc(node, pid, records):
    return {"node_id": node, "pid": pid, "records": records}


def test_aggregator_folds_once_across_scrapes():
    reg = _registry()
    agg = steptrace.SkewAggregator(registry=reg)
    recs0 = [_coll("g", 0, 0, 10.0, idx=0)]
    recs1 = [_coll("g", 0, 1, 10.3, idx=0)]
    assert agg.fold([_proc("a", 1, recs0)]) == 0  # incomplete: pending
    assert agg.fold([_proc("b", 2, recs1)]) == 1  # join completes
    # identical re-scrape (rings are cumulative): nothing double-counts
    assert agg.fold([_proc("a", 1, recs0), _proc("b", 2, recs1)]) == 0
    hist = reg.snapshot()["collective_skew_seconds"]
    total = sum(s["count"] for s in hist["series"])
    assert total == 2  # one lateness observation per rank, once
    assert len(agg.records()) == 2
    # rank 1 arrived last -> its score leads
    scores = agg.scores()
    assert scores[1] > scores[0] >= 0.0


def test_aggregator_straggler_score_converges():
    agg = steptrace.SkewAggregator(registry=_registry(), alpha=0.5)
    for seq in range(8):
        agg.fold([
            _proc("a", 1, [_coll("g", seq, 0, 10.0 + seq, idx=seq)]),
            _proc("b", 2, [_coll("g", seq, 1, 10.4 + seq, idx=seq)]),
        ])
    scores = agg.scores()
    assert scores[1] > 0.95  # always-last converges toward 1
    assert scores[0] < 0.05


def test_aggregator_log_survives_dead_processes():
    agg = steptrace.SkewAggregator(registry=_registry())
    agg.fold([_proc("a", 1, [
        _coll("g", 0, 0, 10.0, idx=0),
        {"kind": "phase", "idx": 1, "step": 0, "phase": "compute",
         "rank": 0, "start": 9.0, "end": 9.5},
    ])])
    # the producing process is gone from later scrapes; its records stay
    agg.fold([])
    merged = steptrace.merge_records(agg.records())
    assert len(merged["phases"]) == 1
    assert len(merged["collectives"]) == 1


# ---------------------------------------------------------------------------
# compile attribution
# ---------------------------------------------------------------------------

class _ShapeCachedFn:
    """A callable with ``jax.jit``'s ``_cache_size`` contract, the one
    ``trace_jit`` keys on: one cache entry per input shape, filled at call
    time (as a lazily compiling jit does)."""

    __name__ = "shape_cached"

    def __init__(self, fn):
        self.fn = fn
        self.cache = {}

    def _cache_size(self):
        return len(self.cache)

    def __call__(self, x):
        self.cache.setdefault(tuple(x.shape), True)
        return self.fn(x)


def test_trace_jit_records_first_call_and_recompile():
    fn = steptrace.trace_jit(_ShapeCachedFn(lambda x: x * 2), name="double")
    np.testing.assert_array_equal(fn(np.ones((4,))), np.full((4,), 2.0))
    fn(np.ones((4,)))           # cache hit: no event
    fn(np.ones((8,)))           # new shape: recompile
    recs = [r for r in steptrace.snapshot() if r["kind"] == "compile"]
    assert [(r["name"], r["first"]) for r in recs] == [
        ("double", True), ("double", False)]
    assert all(r["end"] >= r["start"] for r in recs)


def test_trace_jit_passes_through_a_callable_without_a_cache():
    """A plain callable (a torch function, an nn.Module) has no
    ``_cache_size``: the wrapper calls it and records nothing. The port's
    compile events are its nvcc builds (``record_kernel_build``)."""
    fn = steptrace.trace_jit(lambda x: x + 1, name="plain")
    assert fn(1) == 2 and fn(2) == 3
    assert not [r for r in steptrace.snapshot() if r["kind"] == "compile"]
    steptrace.install_compile_listener()
    steptrace.record_kernel_build("flash_fwd.cu", 1.0, 2.5)
    recs = [r for r in steptrace.snapshot() if r["kind"] == "compile"]
    assert [(r["name"], r["first"], r["start"], r["end"]) for r in recs] == [
        ("flash_fwd.cu", True, 1.0, 2.5)]


# ---------------------------------------------------------------------------
# raylet tailer: one-tick hold beats the actor-class fallback prefix
# ---------------------------------------------------------------------------

class _FakeProc:
    pid = 7

class _FakeWorker:
    def __init__(self, path, log_name=None):
        from ray_tpu_torch._private import logplane

        self.proc = _FakeProc()
        self.job_id = None
        self.log_path = str(path)
        self.log_offset = 0
        self.log_partial = b""
        self.log_spans = logplane.SpanTable()
        self.log_name = log_name
        self.log_held = []


def test_tailer_holds_unattributed_actor_lines_one_tick(tmp_path):
    from ray_tpu_torch._private.raylet import _tail_worker_log

    path = tmp_path / "actor.out"
    path.write_bytes(b"hello from method\n")
    w = _FakeWorker(path, log_name="MyActor")
    # tick 1: no RUNNING event yet -> line held, NOT published with the
    # class fallback
    entry, stats = _tail_worker_log(w)
    assert entry is None and stats["lines"] == 0
    assert len(w.log_held) == 1
    # the RUNNING event lands between ticks
    w.log_spans.open_span("t1", "MyActor.method", 0)
    entry, stats = _tail_worker_log(w)
    assert entry["segs"] == [["MyActor.method", ["hello from method"]]]


def test_tailer_falls_back_after_one_tick(tmp_path):
    from ray_tpu_torch._private.raylet import _tail_worker_log

    path = tmp_path / "actor.out"
    path.write_bytes(b"startup chatter\n")
    w = _FakeWorker(path, log_name="MyActor")
    entry, _ = _tail_worker_log(w)
    assert entry is None  # held one tick
    entry, stats = _tail_worker_log(w)  # no event ever arrives
    assert entry["segs"] == [["MyActor", ["startup chatter"]]]
    assert stats["lines"] == 1


def test_tailer_holds_unnamed_worker_lines_one_tick(tmp_path):
    # worker-side task events are debounced (task_events_flush_interval_s),
    # so even a plain task worker's lines can reach the tailer before
    # their span: unresolved fresh lines hold one tick for every worker,
    # then publish with whatever attribution arrived (here: none)
    from ray_tpu_torch._private.raylet import _tail_worker_log

    path = tmp_path / "plain.out"
    path.write_bytes(b"task-less chatter\n")
    w = _FakeWorker(path, log_name=None)
    entry, stats = _tail_worker_log(w)
    assert entry is None and stats["lines"] == 0
    entry, stats = _tail_worker_log(w)
    assert entry["segs"] == [[None, ["task-less chatter"]]]


def test_tailer_final_flushes_held_lines(tmp_path):
    from ray_tpu_torch._private.raylet import _tail_worker_log

    path = tmp_path / "actor.out"
    path.write_bytes(b"last words\n")
    w = _FakeWorker(path, log_name="MyActor")
    entry, _ = _tail_worker_log(w)
    assert entry is None
    entry, stats = _tail_worker_log(w, final=True)  # worker exiting
    assert entry["segs"] == [["MyActor", ["last words"]]]


# ---------------------------------------------------------------------------
# collective instrumentation (in-process, store backend, world 1)
# ---------------------------------------------------------------------------

def test_collective_ops_record_group_seq(port_regular):
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(1, 0, backend="store", group_name="st_unit")
    try:
        col.allreduce(np.ones((4,), np.float32), "st_unit")
        col.allgather(np.ones((2,), np.float32), "st_unit")
        col.broadcast(np.ones((2,), np.float32), group_name="st_unit")
        col.reducescatter(np.ones((2, 2), np.float32), "st_unit")
        col.barrier("st_unit")
        recs = [r for r in steptrace.snapshot()
                if r["kind"] == "coll" and r["group"] == "st_unit"]
        assert [r["op"] for r in recs] == [
            "allreduce", "allgather", "broadcast", "reducescatter",
            "barrier"]
        assert [r["seq"] for r in recs] == list(range(5))  # monotonic
        assert all(r["end"] >= r["start"] for r in recs)
        assert recs[0]["bytes"] == 16 and recs[0]["world"] == 1
    finally:
        col.destroy_collective_group("st_unit")


def test_collective_tracing_spans_interleave(port_regular):
    from ray_tpu_torch.util import collective as col, tracing

    col.init_collective_group(1, 0, backend="store", group_name="tr_unit")
    tracing.enable()
    try:
        col.allreduce(np.ones((4,), np.float32), "tr_unit")
        tracing.flush()
        spans = [s for s in tracing.get_spans()
                 if s["name"] == "collective.allreduce"]
        assert spans, "collective span missing from the task-event log"
        attrs = spans[-1]["attributes"]
        assert attrs["group"] == "tr_unit" and attrs["seq"] == "0"
        # and it renders in the shared timeline as a span slice
        tl = ray_tpu_torch.timeline(None)
        assert any(e["cat"] == "span"
                   and e["name"] == "collective.allreduce" for e in tl)
    finally:
        tracing.disable()
        col.destroy_collective_group("tr_unit")


# ---------------------------------------------------------------------------
# e2e: 2-worker TorchTrainer -> merged timeline + skew metrics on /metrics
# ---------------------------------------------------------------------------

def test_torch_trainer_train_timeline_e2e(port_regular, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.util import state

    def loop(config):
        import numpy as np

        from ray_tpu_torch import train as train_mod
        from ray_tpu_torch.util import collective as col

        ctx = train_mod.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        col.init_collective_group(world, rank, backend="store",
                                  group_name="obs_e2e")
        for step in range(3):
            with train_mod.step_phase("data"):
                batch = np.full((8,), float(rank + step))
            with train_mod.step_phase("compute"):
                g = batch * 2.0
            g = col.allreduce(g, "obs_e2e")
            with train_mod.step_phase("optimizer"):
                _ = g / world
            train_mod.report({"step": step, "rank": rank})

    trainer = train.TorchTrainer(
        loop,
        torch_config=train.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False),
        run_config=train.RunConfig(name="t_steptrace",
                                   storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None, result.error

    # the shutdown scrape drained the gang's rings into the GCS log, so
    # the merged view survives the (now dead) workers
    merged = state.steptrace_summary()
    phases = merged["phases"]
    for rank in (0, 1):
        mine = {p["phase"] for p in phases if p["rank"] == rank}
        assert {"data", "compute", "optimizer"} <= mine, (rank, phases)
    steps = merged["steps"]
    assert {s["rank"] for s in steps} == {0, 1}
    assert max(s["step"] for s in steps) >= 2
    colls = [c for c in merged["collectives"] if c["group"] == "obs_e2e"]
    assert colls, merged["collectives"]
    complete = [c for c in colls if not c["missing"]]
    assert complete, colls
    assert all(len(c["ranks"]) == 2 for c in complete)
    # two processes never enter the rendezvous at the same wall-clock ns
    assert any(c["skew"] > 0 for c in complete)
    assert set(merged["straggler_scores"]) <= {"0", "1"}

    # Perfetto-loadable export with both ranks' phase rows
    out = tmp_path / "train_timeline.json"
    trace = state.train_timeline(str(out))
    loaded = json.loads(out.read_text())
    assert loaded == trace
    assert {e["args"]["name"] for e in trace if e["ph"] == "M"} >= {
        "rank 0", "rank 1"}
    for rank in (0, 1):
        assert any(e["ph"] == "X" and e["cat"] == "phase"
                   and e["pid"] == rank for e in trace)
    assert any(e["ph"] == "X" and e["cat"] == "collective"
               and e["args"]["skew_s"] > 0 for e in trace)

    # skew attribution rides the existing cluster scrape
    from ray_tpu_torch.util import metrics as m

    merged_metrics = m.cluster_snapshot().get("merged", {})
    assert "collective_skew_seconds" in merged_metrics
    assert "steptrace_straggler_score" in merged_metrics
    ranks_seen = {s["tags"].get("rank")
                  for s in merged_metrics["collective_skew_seconds"]["series"]}
    assert {"0", "1"} <= ranks_seen
