"""The port's counterpart of ``tests/test_runtime_env_container.py`` (4
cases), through ``ray_tpu_torch`` with the reference's expected values:
every case is carried under its own name, each starting its own cluster as
the reference's does. Port names: the engine override
``RAY_TPU_TORCH_container_runtime``, the spawn key
``RAY_TPU_TORCH_WORKER_SPAWN_ID``, the worker module
``ray_tpu_torch._private.worker_main``. Neither box has docker or podman:
the engine cases run the reference's fake and forking engine scripts,
written into ``tmp_path`` as its fixtures write them.

One difference on purpose: the reference forwards every ``JAX_`` and
``XLA_`` variable into a container, since they choose its framework's
device; the port forwards the ones that choose a CUDA device,
``CUDA_VISIBLE_DEVICES`` and ``CUDA_DEVICE_ORDER``, and no ``JAX_`` or
``XLA_`` variable (``test_build_container_command_shape`` and
``test_container_forwards_the_cuda_device_selection_not_jax``).

The reference's description:

Container runtime-env plugin (ray parity:
_private/runtime_env/container.py): the raylet wraps worker commands in
a container-engine invocation. Docker/podman aren't in this image, so a
FAKE engine (a script that records its argv, then execs the inner worker
command) proves the wrapping end to end through a real cluster.
"""

import json
import os
import stat
import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.runtime_env import build_container_command


def _start_fresh(**kwargs):
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(**kwargs)


def test_validate_rejects_malformed_container():
    from ray_tpu_torch._private.runtime_env import _ContainerPlugin

    p = _ContainerPlugin()
    p.validate({})  # absent: fine
    with pytest.raises(ValueError, match="image"):
        p.validate({"container": {"run_options": []}})
    with pytest.raises(ValueError, match="image"):
        p.validate({"container": "myimage"})
    with pytest.raises(ValueError, match="run_options"):
        p.validate({"container": {"image": "x", "run_options": "-it"}})
    p.validate({"container": {"image": "x",
                              "run_options": ["--gpus", "all"]}})


def test_build_container_command_shape():
    env = {"RAY_TPU_TORCH_GCS_ADDR": "127.0.0.1:1234",
           "RAY_TPU_TORCH_SESSION_DIR": "/dev/shm/ray_tpu_torch/session_x",
           "CUDA_VISIBLE_DEVICES": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--x", "HOME": "/home/user", "MY_APP_FLAG": "on"}
    cmd = build_container_command(
        {"image": "myimg:v1", "engine": "podman",
         "run_options": ["--cap-drop", "ALL"]},
        env, ["python", "-m", "ray_tpu_torch._private.worker_main"],
        extra_env_keys=("MY_APP_FLAG",), cidfile="/tmp/x.cid",
    )
    assert cmd[0] == "podman" and cmd[1] == "run"
    assert "--network=host" in cmd and "--ipc=host" in cmd
    assert "--pid=host" in cmd
    # shm + session dir shared: data plane unchanged inside the container
    assert "/dev/shm:/dev/shm" in cmd
    assert ("/dev/shm/ray_tpu_torch/session_x:"
            "/dev/shm/ray_tpu_torch/session_x") in cmd
    # cluster env rides in; unrelated host env does not
    assert "RAY_TPU_TORCH_GCS_ADDR=127.0.0.1:1234" in cmd
    assert not any(c.startswith("HOME=") for c in cmd)
    # the device selection rides in; the reference's framework's does not
    assert "CUDA_VISIBLE_DEVICES=1" in cmd
    assert not any(c.startswith(("JAX_", "XLA_")) for c in cmd)
    # runtime_env env_vars forward explicitly (prefix filter can't know them)
    assert "MY_APP_FLAG=on" in cmd
    assert cmd[cmd.index("--cidfile") + 1] == "/tmp/x.cid"
    # run_options precede the image; the worker command is the tail
    assert cmd[cmd.index("--cap-drop"):][:2] == ["--cap-drop", "ALL"]
    assert cmd.index("myimg:v1") > cmd.index("ALL")
    assert cmd[-3:] == ["python", "-m", "ray_tpu_torch._private.worker_main"]


def test_container_forwards_the_cuda_device_selection_not_jax():
    """The same host env through both packages' builders: each forwards
    the variables that choose its own framework's device, and only those
    beside the cluster's own and the caller's."""
    from ray_tpu._private.runtime_env import \
        build_container_command as reference_build

    env = {"CUDA_VISIBLE_DEVICES": "1", "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--x",
           "TORCH_HOME": "/t", "HOME": "/home/user"}

    def forwarded(cmd):
        return {cmd[i + 1].split("=", 1)[0] for i, c in enumerate(cmd)
                if c == "-e"} - {"PYTHONPATH"}

    spec = {"image": "img", "engine": "podman"}
    port = build_container_command(spec, env, ["python"])
    reference = reference_build(spec, env, ["python"])
    assert forwarded(port) == {"CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER"}
    assert forwarded(reference) == {"JAX_PLATFORMS", "XLA_FLAGS"}


@pytest.fixture
def fake_engine(tmp_path):
    record = tmp_path / "engine_calls.jsonl"
    script = tmp_path / "fake_engine.py"
    script.write_text(f"""#!{sys.executable}
import json, os, sys
args = sys.argv[1:]
with open({str(record)!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
# exec the inner worker command (everything after the image token —
# located as the arg before the trailing 'python')
i = args.index("python")
os.execv({sys.executable!r}, [{sys.executable!r}] + args[i + 1:])
""")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), str(record)


@pytest.fixture
def forking_engine(tmp_path):
    """Fake engine that FORKS the worker (subprocess) instead of exec'ing
    it in place — the real podman/docker shape, where the worker's
    os.getpid() differs from the engine client's pid the raylet spawned.
    Registration must therefore resolve via the spawn key, not the pid."""
    record = tmp_path / "fork_engine_calls.jsonl"
    script = tmp_path / "forking_engine.py"
    script.write_text(f"""#!{sys.executable}
import json, os, subprocess, sys
args = sys.argv[1:]
with open({str(record)!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
# env rides -e K=V flags, exactly like a real engine invocation
env = dict(os.environ)
i = 0
while i < len(args):
    if args[i] == "-e" and "=" in args[i + 1]:
        k, v = args[i + 1].split("=", 1)
        env[k] = v
        i += 2
    else:
        i += 1
# run the inner worker command as a CHILD (pid != our pid), like conmon
j = args.index("python")
rc = subprocess.run([sys.executable] + args[j + 1:], env=env).returncode
sys.exit(rc)
""")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), str(record)


def test_worker_registers_through_forking_engine(forking_engine, monkeypatch):
    """ADVICE high: with a forking engine the worker's reported pid never
    matches the raylet's engine-client pid — before the spawn-id fix,
    registration timed out and the raylet looped spawning containers."""
    engine, record = forking_engine
    monkeypatch.setenv("RAY_TPU_TORCH_container_runtime", engine)
    _start_fresh(num_cpus=2)
    try:
        @ray_tpu_torch.remote(
            runtime_env={"container": {"image": "fake:latest"}})
        def whoami():
            return os.getpid(), os.getppid(), \
                os.environ.get("RAY_TPU_TORCH_WORKER_SPAWN_ID")

        pid, ppid, spawn_id = ray_tpu_torch.get(whoami.remote(), timeout=120)
        assert spawn_id, "spawn key did not reach the containerized worker"
        with open(record) as f:
            calls = [json.loads(line) for line in f]
        assert calls, "worker never went through the engine"
        # the pid mismatch was actually exercised: the worker is a CHILD
        # of the engine client, so its pid differs from what the raylet
        # keyed all_workers by
        assert any(f"RAY_TPU_TORCH_WORKER_SPAWN_ID={spawn_id}" in arg
                   for call in calls for arg in call)
        assert pid != ppid
        # and the registered worker serves follow-up tasks normally
        @ray_tpu_torch.remote(
            runtime_env={"container": {"image": "fake:latest"}})
        def again():
            return "ok"

        assert ray_tpu_torch.get(again.remote(), timeout=60) == "ok"
    finally:
        ray_tpu_torch.shutdown()


def test_worker_runs_through_engine_end_to_end(fake_engine, monkeypatch):
    engine, record = fake_engine
    monkeypatch.setenv("RAY_TPU_TORCH_container_runtime", engine)
    _start_fresh(num_cpus=2)
    try:
        @ray_tpu_torch.remote(
            runtime_env={"container": {"image": "fake:latest"}})
        def whoami():
            return os.getpid()

        pid = ray_tpu_torch.get(whoami.remote(), timeout=120)
        assert pid > 0
        with open(record) as f:
            calls = [json.loads(line) for line in f]
        assert calls, "worker never went through the engine"
        argv = calls[-1]
        assert argv[0] == "run" and "--network=host" in argv
        assert "fake:latest" in argv
        # the containerized worker is its own pool: a plain task must NOT
        # reuse it (env-hash keyed pools)
        @ray_tpu_torch.remote
        def plain():
            return "ok"

        assert ray_tpu_torch.get(plain.remote(), timeout=60) == "ok"
        assert len([json.loads(line) for line in open(record)]) == \
            len(calls), "plain task wrongly spawned through the engine"
    finally:
        ray_tpu_torch.shutdown()
