"""The port's Data execution stats and memory-budget backpressure beside
the reference's, on the CPU (the cases of ``tests/test_data_stats.py``).

Each case runs through both packages, one cluster of each for the module.
Timings differ between runs, so what is held equal is what the executor
counts: operators, tasks, rows and the in-flight peak under a budget.
"""

import importlib

import pytest

import ray_tpu
import ray_tpu_torch

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=4)
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_stats_summary(clusters, pkg):
    rd = importlib.import_module(f"{pkg}.data")
    ds = rd.range(200, parallelism=8).map(lambda r: r * 2)
    ds = ds.materialize()
    s = ds.stats()
    assert "Execution stats:" in s
    assert "Read" in s and "Map" in s
    assert "8 tasks" in s
    assert "wall" in s and "Total:" in s
    assert "200 rows" in s


def test_stats_summaries_count_the_same(clusters):
    summaries = []
    for pkg in PKGS:
        rd = importlib.import_module(f"{pkg}.data")
        ds = rd.range(200, parallelism=8).map(lambda r: r * 2).materialize()
        ops = ds._exec_stats.ops
        summaries.append([(op.name, op.num_tasks, op.num_rows) for op in ops])
        assert ds.stats().count(" tasks, ") == len(ops)
    assert summaries[0] == summaries[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_context_budget_limits_inflight(clusters, pkg):
    """With a budget smaller than two estimated blocks, admission stays at
    one task in flight even though the window allows 8."""
    rd = importlib.import_module(f"{pkg}.data")
    ctx = rd.DataContext.get_current()
    old_budget, old_seed = ctx.op_memory_budget, ctx.target_max_block_size
    try:
        ctx.op_memory_budget = 1  # byte — nothing fits beyond 1 task
        ds = rd.range(64, parallelism=8).map(lambda r: r).materialize()
        assert ds.count() == 64  # still completes (admit-at-least-one)
        stats = ds._exec_stats
        for op in stats.ops:
            assert op.peak_inflight_tasks == 1, (
                f"{op.name} exceeded the byte budget: "
                f"peak={op.peak_inflight_tasks}"
            )
        assert any(op.backpressure_s >= 0 for op in stats.ops)
    finally:
        ctx.op_memory_budget = old_budget
        ctx.target_max_block_size = old_seed


@pytest.mark.parametrize("pkg", PKGS)
def test_default_budget_allows_parallelism(clusters, pkg):
    rd = importlib.import_module(f"{pkg}.data")
    ds = rd.range(64, parallelism=8).materialize()
    stats = ds._exec_stats
    assert max(op.peak_inflight_tasks for op in stats.ops) > 1


@pytest.mark.parametrize("pkg", PKGS)
def test_stats_disabled(clusters, pkg):
    rd = importlib.import_module(f"{pkg}.data")
    ctx = rd.DataContext.get_current()
    ctx.enable_stats = False
    try:
        ds = rd.range(10).materialize()
        assert "Execution stats:" not in ds.stats()
    finally:
        ctx.enable_stats = True


def test_block_sizes_count_the_column_buffers(clusters):
    """``size_bytes`` (the budget's estimate) is Arrow's buffer size for
    fixed-width columns in both packages."""
    sizes = []
    for pkg in PKGS:
        rd = importlib.import_module(f"{pkg}.data")
        sizes.append(rd.range(64, parallelism=4).size_bytes())
    assert sizes[0] == sizes[1] == 64 * 8
