"""Node process orchestration.

Analog of ray: python/ray/_private/node.py:37 Node + services.py: starts and
owns the per-node processes (GCS on the head, a raylet per node), discovers
their ports via port files, and tears them down on shutdown. Sessions live
under /dev/shm when available so the object store's files are true shared
memory. Session layout (one dir per cluster session)::

    session_<ts>_<rand>/
      cluster_token            rpc auth token (0600)
      gcs_store.log            GCS persistence log
      logs/                    per-process stdout/stderr
      store_<node_id12>/       raylet object store (per node)
        index.shm              shared-memory object index (slab arena)
        slabs/seg_*.slab       leased slab segments (sparse tmpfs)
        <oid>.obj              one-file objects (spill restores, fallback)

The store dirs are tmpfs-backed shared memory: ``shutdown`` removes this
node's store dir so slab segments and mappings don't outlive the session
in /dev/shm (stale sessions would otherwise pin host memory until a
reboot).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, Optional

DEFAULT_SESSION_ROOT = "/dev/shm/ray_tpu_torch" if os.path.isdir("/dev/shm") else None


def _make_session_dir(session_root: Optional[str] = None) -> str:
    root = session_root or DEFAULT_SESSION_ROOT or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch"
    )
    session_dir = os.path.join(root, f"session_{time.strftime('%Y%m%d-%H%M%S')}_{uuid.uuid4().hex[:8]}")
    os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
    return session_dir


def load_cluster_token(session_dir: Optional[str] = None) -> Optional[str]:
    """Load a persisted cluster token into the environment if unset.

    Tries, in order: an explicit ``session_dir/cluster_token``, then the CLI
    state file (~/.ray_tpu_torch/cluster.json) token_file entry. Returns the token
    or None. No-op when RAY_TPU_TORCH_CLUSTER_TOKEN is already exported.
    """
    if os.environ.get("RAY_TPU_TORCH_CLUSTER_TOKEN"):
        return os.environ["RAY_TPU_TORCH_CLUSTER_TOKEN"]
    candidates = []
    if session_dir:
        candidates.append(os.path.join(session_dir, "cluster_token"))
    state_file = os.path.expanduser("~/.ray_tpu_torch/cluster.json")
    try:
        with open(state_file) as f:
            state = json.load(f)
        if state.get("token_file"):
            candidates.append(state["token_file"])
        if state.get("session_dir"):
            candidates.append(os.path.join(state["session_dir"], "cluster_token"))
    except (OSError, ValueError):
        pass
    for path in candidates:
        try:
            with open(path) as f:
                token = f.read().strip()
            if token:
                os.environ["RAY_TPU_TORCH_CLUSTER_TOKEN"] = token
                return token
        except OSError:
            continue
    return None


def _wait_port_file(path: str, timeout: float = 30.0) -> list:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                return f.read().strip().split("\n")
        time.sleep(0.05)
    raise TimeoutError(f"process did not write port file {path}")


def package_env(env: Optional[dict] = None) -> dict:
    """Env with PYTHONPATH including ray_tpu_torch's parent dir, so subprocesses can
    import the package regardless of the caller's cwd/installation."""
    env = dict(env if env is not None else os.environ)
    import ray_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    existing = env.get("PYTHONPATH", "")
    if pkg_root not in existing.split(os.pathsep):
        env["PYTHONPATH"] = pkg_root + (os.pathsep + existing if existing else "")
    return env


def control_plane_env(env: Optional[dict] = None) -> dict:
    """Spawn env for GCS/raylet processes. The reference strips a TPU
    plugin trigger here; the port has no such plugin, so the control
    plane's env is the workers' env (the GCS and raylet never import
    torch either way)."""
    return package_env(env)


def _spawn(cmd, log_path: str, env: dict) -> subprocess.Popen:
    """Callers build the env explicitly (control_plane_env for
    GCS/raylet/agents, package_env for anything that may use torch)."""
    out = open(log_path, "ab")
    return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=env)


class NodeProcesses:
    """Starts GCS (head only) + raylet subprocesses for one logical node."""

    def __init__(
        self,
        head: bool = True,
        gcs_host: str = "127.0.0.1",
        gcs_port: Optional[int] = None,
        session_dir: Optional[str] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
    ):
        self.head = head
        if head and not os.environ.get("RAY_TPU_TORCH_CLUSTER_TOKEN"):
            # Cluster-scoped RPC auth: every process spawned from here (and
            # every driver sharing this env) inherits the token; rpcio
            # rejects unauthenticated connects (see rpcio.py preamble).
            import secrets

            os.environ["RAY_TPU_TORCH_CLUSTER_TOKEN"] = secrets.token_hex(16)
        self.session_dir = session_dir or _make_session_dir()
        # Persist the token (0600) so separately launched processes — the
        # CLI after `start --head`, drivers using init(address=...), worker
        # raylets joining via `start --address` on the same host — can load
        # it instead of silently failing auth. Cross-host joins still export
        # RAY_TPU_TORCH_CLUSTER_TOKEN manually (the CLI prints the hint).
        token = os.environ.get("RAY_TPU_TORCH_CLUSTER_TOKEN", "")
        if token:
            self.token_file = os.path.join(self.session_dir, "cluster_token")
            if not os.path.exists(self.token_file):
                fd = os.open(
                    self.token_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600
                )
                with os.fdopen(fd, "w") as f:
                    f.write(token)
        else:
            self.token_file = None
        self.logs = os.path.join(self.session_dir, "logs")
        os.makedirs(self.logs, exist_ok=True)
        self.gcs_host = gcs_host
        self.gcs_proc: Optional[subprocess.Popen] = None
        suffix = uuid.uuid4().hex[:8]
        self.gcs_persist_path = os.path.join(self.session_dir, "gcs_store.log")
        if head:
            port_file = os.path.join(self.session_dir, f"gcs_port_{suffix}")
            self.gcs_proc = _spawn(
                [sys.executable, "-m", "ray_tpu_torch._private.gcs_main",
                 "--host", gcs_host, "--port", "0", "--port-file", port_file,
                 "--persist-path", self.gcs_persist_path,
                 "--cluster-id", os.path.basename(self.session_dir)],
                os.path.join(self.logs, "gcs.out"),
                env=control_plane_env(),
            )
            self.gcs_port = int(_wait_port_file(port_file)[0])
        else:
            assert gcs_port is not None
            self.gcs_port = gcs_port
        raylet_port_file = os.path.join(self.session_dir, f"raylet_port_{suffix}")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.raylet_main",
            "--gcs-host", gcs_host, "--gcs-port", str(self.gcs_port),
            "--session-dir", self.session_dir,
            "--port-file", raylet_port_file,
        ]
        if resources is not None:
            cmd += ["--resources", json.dumps(resources)]
        if labels is not None:
            cmd += ["--labels", json.dumps(labels)]
        self.raylet_proc = _spawn(
            cmd, os.path.join(self.logs, f"raylet_{suffix}.out"),
            env=control_plane_env(),
        )
        lines = _wait_port_file(raylet_port_file)
        self.raylet_port = int(lines[0])
        self.node_id = lines[1] if len(lines) > 1 else None

    @property
    def address(self) -> str:
        return f"{self.gcs_host}:{self.gcs_port}"

    def kill_raylet(self, graceful: bool = False):
        """Chaos hook (analog of ray: _private/test_utils.py NodeKillerActor)."""
        if graceful:
            self.raylet_proc.terminate()
        else:
            self.raylet_proc.kill()
        self.raylet_proc.wait(timeout=10)

    # -- network chaos hooks (see _private/faultsim.py) -----------------
    # Every control-plane process spawned from here inherits
    # RAY_TPU_TORCH_RPC_FAULTS / RAY_TPU_TORCH_RPC_FAULTS_FILE through its env; the
    # FILE variant is re-read live, so faults can be armed and HEALED
    # while raylet/GCS subprocesses keep running. Export the env var
    # BEFORE building the cluster — children snapshot their env at spawn.

    def set_network_faults(self, spec: str):
        """(Re)write the live fault spec file. Requires
        RAY_TPU_TORCH_RPC_FAULTS_FILE to have been exported before this node's
        processes started."""
        path = os.environ.get("RAY_TPU_TORCH_RPC_FAULTS_FILE")
        assert path, (
            "export RAY_TPU_TORCH_RPC_FAULTS_FILE before starting the cluster "
            "to use dynamic fault injection"
        )
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(spec)
        os.replace(tmp, path)  # atomic: readers never see a half-written spec

    def clear_network_faults(self):
        """Heal: remove every armed network fault."""
        self.set_network_faults("")

    def kill_gcs(self):
        """Chaos hook: kill the GCS process (head only). State survives in
        the persist log; ``restart_gcs`` brings it back on the same port."""
        assert self.gcs_proc is not None, "kill_gcs only valid on the head"
        self.gcs_proc.kill()
        self.gcs_proc.wait(timeout=10)

    def restart_gcs(self):
        """Restart the GCS on its original port; it replays the persist log
        and raylets/workers reconnect (ray: GCS FT via Redis restart +
        RayletNotifyGCSRestart)."""
        assert self.head, "restart_gcs only valid on the head"
        self.gcs_proc = _spawn(
            [sys.executable, "-m", "ray_tpu_torch._private.gcs_main",
             "--host", self.gcs_host, "--port", str(self.gcs_port),
             "--persist-path", self.gcs_persist_path,
             "--cluster-id", os.path.basename(self.session_dir)],
            os.path.join(self.logs, "gcs.out"),
            env=control_plane_env(),
        )

    def shutdown(self):
        for proc in (self.raylet_proc, self.gcs_proc):
            if proc is None:
                continue
            try:
                proc.terminate()
            except Exception:
                pass
        for proc in (self.raylet_proc, self.gcs_proc):
            if proc is None:
                continue
            try:
                proc.wait(timeout=5)
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass
        # release this node's share of /dev/shm: the store dir (slab
        # segments, index, .obj files) is dead weight once the raylet is
        # gone — processes still holding mappings keep their pages until
        # the views die, so this is safe for stragglers
        if self.node_id:
            import shutil

            shutil.rmtree(
                os.path.join(self.session_dir, f"store_{self.node_id[:12]}"),
                ignore_errors=True,
            )
