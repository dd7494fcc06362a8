"""The port's control-plane perf smoke: the cases of
``tests/test_perf_smoke.py`` and ``tests/test_microbenchmark.py`` through
``ray_tpu_torch._private.perf`` (``python -m ray_tpu_torch microbenchmark
--small``) on the port's own cluster. Floors are the reference's: soft,
ratio-based, far under healthy values, so only a structural regression
(a lost fast path, a per-op copy of bulk bytes) trips them; absolute ops/s
on a shared box swing ~2x from run to run and are not compared with the
reference's.
"""

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_start_regular():
    ray_tpu_torch.init(num_cpus=4, resources={"custom": 2.0})
    yield
    ray_tpu_torch.shutdown()


def test_microbenchmark_subset(ray_start_regular):
    from ray_tpu_torch._private.perf import run_microbenchmarks

    results = run_microbenchmarks(select="put", small=True)
    names = {r["benchmark"] for r in results}
    assert "small put (100B)" in names
    assert "put gigabytes" in names
    assert all(r["value"] > 0 for r in results), results



@pytest.fixture(scope="module")
def bench_results(ray_start_regular):
    from ray_tpu_torch._private.perf import run_microbenchmarks

    results = run_microbenchmarks(
        select="", small=True
    )
    return {r["benchmark"]: r["value"] for r in results}


def test_suite_runs_and_reports(bench_results):
    expected = {
        "single client tasks sync",
        "single client tasks async",
        "1:1 actor calls sync",
        "1:1 actor calls async",
        "n:n actor calls async",
        "put+get 1MB numpy",
        "actor call 1MB arg",
        "actor call 64KB arg",
        "put gigabytes",
    }
    missing = expected - set(bench_results)
    assert not missing, f"benchmarks missing from the suite: {missing}"
    assert all(v > 0 for v in bench_results.values()), bench_results


def test_async_submission_beats_serial_roundtrips(bench_results):
    # pipelining exists at all: an async burst must outrun one-at-a-time
    # sync round-trips (healthy ratio is ~10x; floor at 1.5x)
    assert bench_results["single client tasks async"] >= \
        1.5 * bench_results["single client tasks sync"], bench_results
    assert bench_results["1:1 actor calls async"] >= \
        1.5 * bench_results["1:1 actor calls sync"], bench_results


def test_bulk_args_do_not_collapse_call_rate(bench_results):
    # a 64KB inline arg rides the frame out-of-band: the call rate must
    # stay within 50x of the empty-arg async rate (a lost zero-copy path
    # shows up as a far bigger collapse under --small batch sizes)
    assert bench_results["actor call 64KB arg"] >= \
        bench_results["1:1 actor calls async"] / 50.0, bench_results


def test_object_plane_moves_bulk_bytes(bench_results):
    # put+get of 1MB implies >= value * 2MB/s of object-plane bandwidth;
    # require a floor far below the shm store's capability but far above
    # any accidental per-op pickle/copy regression
    bandwidth = bench_results["put+get 1MB numpy"] * 2 * (1 << 20)
    assert bandwidth >= 50 * (1 << 20), (
        f"object plane at {bandwidth / 1e6:.1f} MB/s", bench_results,
    )


@pytest.fixture(scope="module")
def object_plane_rows(ray_start_regular):
    from ray_tpu_torch._private.perf import run_object_plane_bench

    return {r["benchmark"]: r for r in run_object_plane_bench(small=True)}


def test_object_plane_bulk_is_slab_backed(object_plane_rows):
    # structural invariant, not a throughput number: >inline-threshold
    # objects must travel the slab arena (a silent fall-back to one-file
    # writes would keep working, slowly — this is the canary)
    for name in ("obj get 1MB", "obj get 8MB"):
        assert object_plane_rows[name]["slab_backed"], object_plane_rows


def test_object_plane_ratio_floors(object_plane_rows):
    rows = object_plane_rows
    # arena get is an index hit + memoryview: it must beat the put (which
    # pays the memcpy) at 1MB, and inline 100B puts must be far cheaper
    # than 1MB slab puts (floors sit 5-10x under healthy ratios)
    assert rows["obj get 1MB"]["value"] >= rows["obj put 1MB"]["value"], rows
    assert rows["obj put 100B"]["value"] >= 3 * rows["obj put 1MB"]["value"], rows
    # bandwidth floor on the slab path: 1MB roundtrips above the legacy
    # 50MB/s smoke floor with headroom (structural regressions collapse
    # this by >10x; box noise does not)
    rt = 1.0 / (1.0 / rows["obj put 1MB"]["value"]
                + 1.0 / rows["obj get 1MB"]["value"])
    assert rt * 2 * (1 << 20) >= 80 * (1 << 20), rows


# ----------------------------------------------------------------------
# control-plane stage lane (BENCH_CONTROL_PLANE): per-stage latency
# breakdown of the submit->lease->dispatch fast path
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def control_plane_rows(ray_start_regular):
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
    from ray_tpu_torch._private.perf import run_control_plane_bench

    prev = cfg.control_plane_stage_timing
    cfg.update({"control_plane_stage_timing": True})
    try:
        rows = run_control_plane_bench(small=True)
    finally:
        cfg.update({"control_plane_stage_timing": prev})
    return {r["benchmark"]: r for r in rows}


def test_control_plane_lane_reports_driver_stages(control_plane_rows):
    rows = control_plane_rows
    # the lane must produce the two sync headline rows AND samples for
    # every driver-side stage (a silent zero here means the stage timers
    # fell off the hot path and the breakdown is lying)
    assert rows["single client tasks sync"]["value"] > 0, rows
    assert rows["1:1 actor calls sync"]["value"] > 0, rows
    for stage in ("cp stage id mint", "cp stage envelope build",
                  "cp stage result return"):
        assert rows[stage]["value"] > 0, rows


def test_control_plane_constant_stages_stay_constant(control_plane_rows):
    rows = control_plane_rows
    # ratio floors on the amortized-constant stages: id minting is a
    # list.pop of precomputed bytes (healthy ~2us mean) and envelope
    # build a template clone (healthy ~60us). Caps sit ~10x over healthy
    # so only a structural regression (f-string ids, per-call dict copies
    # re-introduced) trips them, not box noise.
    mint = rows["cp stage id mint"].get("mean_us", 0)
    build = rows["cp stage envelope build"].get("mean_us", 0)
    assert 0 < mint < 200, rows["cp stage id mint"]
    assert 0 < build < 2000, rows["cp stage envelope build"]


# ----------------------------------------------------------------------
# cross-node transfer plane (arena-to-arena): push/pull floors between
# two real nodes. ONE test so the 2-node cluster + bench matrix run
# once; function-scoped own cluster — LAST in the module so the
# shared-cluster fixtures above keep their reuse.
# ----------------------------------------------------------------------

@pytest.fixture
def ray_start_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()  # the module's single-node cluster
    cluster = Cluster(initialize_head=False)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_transfer_plane_arena_paths_and_floors(ray_start_cluster):
    from ray_tpu_torch._private.perf import run_transfer_plane_bench

    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)
    rows = {r["benchmark"]: r for r in run_transfer_plane_bench(small=True)}
    # structural invariant (receive-side slab assembly): every cross-node
    # fetch / push_rx flow row must report path="arena" on a slab-backed
    # store — a "heap" row means the chunk-copy path silently came back
    for row in rows.values():
        assert row["slab_backed"], rows
        assert row["arena_paths"], rows
    # SOFT floors far under healthy loopback values (hundreds of MB/s on
    # this plane): only a structural regression — a lost zero-copy send,
    # chunks re-serialized per hop, a serial re-fetch storm — trips them
    assert rows["xfer pull 8MB"]["value"] >= 30, rows
    assert rows["xfer push 8MB"]["value"] >= 30, rows
    # bulk transfers must beat small-object transfers on bandwidth (the
    # per-op fixed cost dominates 128KB; a flat ratio means the bulk
    # path degenerated to per-chunk control-plane costs)
    assert rows["xfer pull 8MB"]["value"] >= \
        2 * rows["xfer pull 128KB"]["value"], rows
