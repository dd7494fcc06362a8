"""The port's counterpart of ``tests/test_usage_stats.py`` (3 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

The reference's description:

Usage stats (reference parity: _private/usage/usage_lib.py — inverted
default: local-only, never phones home).
"""

import json
import os

from tests.torch_fixtures import port_regular  # noqa: F401


def test_usage_snapshot_written_on_head_init(port_regular):
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker

    path = os.path.join(global_worker.node.session_dir, "usage_stats.json")
    assert os.path.exists(path)
    payload = json.load(open(path))
    assert payload["source"] == "ray_tpu_torch"
    assert payload["total_num_nodes"] >= 1
    assert payload["total_num_cpus"] >= 1
    assert "python_version" in payload


def test_usage_stats_opt_out(monkeypatch):
    from ray_tpu_torch._private import usage_lib

    monkeypatch.setenv("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "0")
    assert not usage_lib.usage_stats_enabled()
    monkeypatch.delenv("RAY_TPU_TORCH_USAGE_STATS_ENABLED")
    monkeypatch.setenv("RAY_USAGE_STATS_ENABLED", "false")
    assert not usage_lib.usage_stats_enabled()


def test_no_report_without_operator_url(monkeypatch):
    from ray_tpu_torch._private import usage_lib

    monkeypatch.delenv("RAY_TPU_TORCH_USAGE_STATS_REPORT_URL", raising=False)
    assert usage_lib.maybe_report({"x": 1}) is False
