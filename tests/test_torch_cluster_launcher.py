"""The port's cluster launcher (``ray_tpu_torch.autoscaler.commands``): the
cases of ``tests/test_cluster_launcher.py`` through the port, a YAML with
a head and one GPU node type coming up (head + monitor processes, the
worker raylet launched by ``FakeGpuNodeProvider`` for ``min_workers``),
status showing both, down tearing everything down; the port's
``validate_config`` rejecting what the reference's rejects, with the
provider types named for what they launch. Then chip_smoke phase 33's run
at ``small_test`` size on the CPU (``tools/cluster_runs.drive``): ``up``,
``status``, ``submit`` of a job whose ``TorchTrainer`` gang leases a
logical GPU, the autoscaler launching the node it trains on, the idle
node torn down, ``microbenchmark --small`` and ``down``; the job's losses
held against one process on the same weights and batch.
"""

import time

import numpy as np
import pytest
import torch
import yaml

from ray_tpu.autoscaler.commands import ClusterConfigError as RefConfigError
from ray_tpu.autoscaler.commands import validate_config as ref_validate
from ray_tpu_torch.autoscaler import commands
from ray_tpu_torch.autoscaler.commands import (
    ClusterConfigError,
    validate_config,
)


def _base_cfg(name):
    return {
        "cluster_name": name,
        "provider": {"type": "fake_gpu_node"},
        "head_node": {"resources": {"CPU": 2, "GPU": 0}},
        "available_node_types": {
            "gpu_4": {
                "resources": {"GPU": 4, "CPU": 2},
                "min_workers": 1,
                "max_workers": 2,
            },
        },
    }


# (config, the error's match) for both packages: the provider types are
# each package's own
BAD = [
    (lambda kind: {"provider": {"type": "mock"}}, "cluster_name"),
    (lambda kind: {"cluster_name": "x", "provider": {}}, "provider.type"),
    (lambda kind: {"cluster_name": "x", "provider": {"type": "aws"}},
     "unknown provider.type"),
    (lambda kind: {"cluster_name": "x", "provider": {"type": "mock"},
                   "available_node_types": {"t": {}}}, "resources"),
    (lambda kind: {"cluster_name": "x", "provider": {"type": "mock"},
                   "available_node_types": {
                       "t": {"resources": {"CPU": 1}, "min_workers": 3,
                             "max_workers": 1}}}, "min_workers"),
    (lambda kind: {"cluster_name": "x", "provider": {"type": kind}},
     "project"),
]


def test_validate_config_rejects_bad_shapes():
    for make, match in BAD:
        with pytest.raises(ClusterConfigError, match=match):
            validate_config(make("gpu_group"))
        with pytest.raises(RefConfigError, match=match):
            ref_validate(make("tpu_pod"))
    validate_config(_base_cfg("ok"))
    # the reference's provider types are not the port's
    for kind in ("fake_tpu_pod", "tpu_pod"):
        with pytest.raises(ClusterConfigError, match="unknown provider"):
            validate_config(dict(_base_cfg("x"), provider={"type": kind}))


@pytest.fixture
def launcher_env(tmp_path, monkeypatch):
    monkeypatch.setattr(commands, "_STATE_DIR", str(tmp_path / "clusters"))
    path = tmp_path / "cluster.yaml"
    path.write_text(yaml.safe_dump(_base_cfg("launchertest")))
    yield str(path)
    try:
        commands.teardown_cluster(str(path))
    except Exception:
        pass


def test_up_status_down_end_to_end(launcher_env):
    path = launcher_env
    state = commands.create_or_update_cluster(path)
    assert commands._pid_alive(state["head_pid"])
    assert commands._pid_alive(state["monitor_pid"])

    # idempotent re-up: same head adopted, no second monitor
    state2 = commands.create_or_update_cluster(path)
    assert state2["head_pid"] == state["head_pid"]
    assert state2["monitor_pid"] == state["monitor_pid"]

    deadline = time.time() + 90
    seen = []
    while time.time() < deadline:
        out = commands.cluster_status(path)
        seen = [n for n in out["nodes"] if n.get("alive", True)]
        if len(seen) >= 2:
            break
        time.sleep(2)
    assert len(seen) >= 2, f"the worker node never joined: {seen}"
    gpu_nodes = [n for n in seen
                 if (n.get("resources_total") or {}).get("GPU", 0) >= 4]
    assert gpu_nodes, f"no GPU node in {seen}"
    assert any((n.get("labels") or {}).get("gpu-group") == "gpu_4"
               for n in gpu_nodes)
    head = [n for n in seen if n not in gpu_nodes]
    assert head and all(not (n.get("resources_total") or {}).get("GPU")
                        for n in head)

    head_pids = list(state["head_pids"])
    mpid = state["monitor_pid"]
    commands.teardown_cluster(path)
    assert not commands._pid_alive(mpid)
    for pid in head_pids:
        assert not commands._pid_alive(pid)
    out = commands.cluster_status(path)
    assert out["up"] is False


JOB = {"model": "small_test", "dtype": "float32", "device": "cpu",
       "use_gpu": False, "workers": 1, "steps": 3, "batch": 4, "seq": 32}


def _one_process_losses():
    from ray_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config.small_test(attention="flash", loss_chunks=4,
                                     dtype=torch.float32)
    model, opt = gpt2.make_train_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    step = gpt2.build_train_step(model, opt)
    batch = gpt2.synthetic_batch(1, JOB["batch"], JOB["seq"],
                                 cfg.vocab_size, device="cpu")
    losses = []
    for _ in range(JOB["steps"]):
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    return losses


def test_submitted_job_trains_on_the_node_the_autoscaler_launches(tmp_path):
    from ray_tpu_torch.tools import cluster_runs

    out = cluster_runs.drive(str(tmp_path), JOB, {"GPU": 1, "CPU": 2},
                             name="cpu-rehearsal", job_timeout_s=240)
    assert not cluster_runs.problems(out, JOB["steps"], None), out
    steps = out["job"]["steps"]
    assert steps[-1]["mesh"] == [["data", "fsdp"], [1, 1]]
    # on CPU tensors the wrappers run the kernels' plain versions
    assert steps[-1]["plain_calls"] > 0
    np.testing.assert_allclose([s["loss"] for s in steps],
                               _one_process_losses(), rtol=1e-5, atol=1e-6)
    assert "put gigabytes" in out["microbenchmark"]
    assert out["submit_to_node_s"] is not None
    assert out["teardown_s"] is not None


def test_node_table_leaves_this_process_token_alone(monkeypatch):
    """``cluster_runs.node_table`` dials another cluster with that
    cluster's token and never writes it into this process's environment:
    phase 33's run polls it from a thread while this process runs clusters
    of its own, whose new connections read the environment's token."""
    import os
    import threading

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.tools import cluster_runs

    env = cluster_runs.TOKEN_ENV
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1)
    token = os.environ[env]
    try:
        monkeypatch.setenv(env, "another-cluster")
        seen, stop = set(), threading.Event()

        def watch():
            while not stop.is_set():
                seen.add(os.environ.get(env))

        watcher = threading.Thread(target=watch)
        watcher.start()
        try:
            for _ in range(20):
                assert cluster_runs.node_table(global_worker.node.address,
                                               token)
        finally:
            stop.set()
            watcher.join(10)
        assert not watcher.is_alive()
        assert seen == {"another-cluster"}
    finally:
        monkeypatch.setenv(env, token)
        ray_tpu_torch.shutdown()
