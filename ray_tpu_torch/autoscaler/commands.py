"""Cluster launcher: ``ray_tpu_torch up / down / status`` from a YAML config.

Reference parity: ray python/ray/autoscaler/_private/commands.py
(create_or_update_cluster / teardown_cluster) + the YAML schema in
python/ray/autoscaler/ray-schema.json: instead of SSH/docker node
updaters (updater.py:39), workers are GPU nodes (or whole groups of GPU
hosts) joining through a NodeProvider (FakeGpuNodeProvider locally,
GpuGroupProvider via a Queued-Resources API), and the autoscaler
runs as a monitor process next to the head (ray parity:
autoscaler/_private/monitor.py).

YAML schema (validated by ``validate_config``)::

    cluster_name: demo            # required
    max_workers: 8                # optional global cap
    idle_timeout_minutes: 1       # scale-down idle window
    provider:
      type: fake_gpu_node         # fake_gpu_node | gpu_group | mock
      # gpu_group only:
      #   project: my-proj
      #   zone: us-central2-b
      #   runtime_version: tpu-ubuntu2204-base
    head_node:
      resources: {CPU: 4, GPU: 0}   # the head leaves the cards to workers
    available_node_types:
      gpu_node:
        resources: {GPU: 1, CPU: 4}
        min_workers: 0
        max_workers: 1
      # gpu_group types add accelerator_type, topology and hosts
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, Optional

_STATE_DIR = os.path.expanduser("~/.ray_tpu_torch/clusters")


class ClusterConfigError(ValueError):
    pass


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    validate_config(cfg)
    return cfg


def validate_config(cfg: Dict[str, Any]) -> None:
    """Hand-rolled schema check (ray parity: ray-schema.json via
    jsonschema; same intent, no jsonschema dependency)."""
    if not isinstance(cfg, dict):
        raise ClusterConfigError("cluster config must be a mapping")
    name = cfg.get("cluster_name")
    if not name or not isinstance(name, str):
        raise ClusterConfigError("cluster_name (string) is required")
    provider = cfg.get("provider")
    if not isinstance(provider, dict) or "type" not in provider:
        raise ClusterConfigError("provider.type is required")
    if provider["type"] not in ("fake_gpu_node", "gpu_group", "mock"):
        raise ClusterConfigError(
            f"unknown provider.type {provider['type']!r} "
            f"(expected fake_gpu_node | gpu_group | mock)"
        )
    if provider["type"] == "gpu_group":
        # accelerator_type/topology live PER NODE TYPE (a cluster mixes
        # group shapes); only the project/zone routing is provider-level
        for key in ("project", "zone"):
            if key not in provider:
                raise ClusterConfigError(
                    f"provider.{key} is required for gpu_group"
                )
    types = cfg.get("available_node_types") or {}
    if not isinstance(types, dict):
        raise ClusterConfigError("available_node_types must be a mapping")
    for tname, spec in types.items():
        if not isinstance(spec, dict) or "resources" not in spec:
            raise ClusterConfigError(
                f"available_node_types.{tname}.resources is required"
            )
        mn = int(spec.get("min_workers", 0))
        mx = int(spec.get("max_workers", max(mn, 1)))
        if mn < 0 or mx < mn:
            raise ClusterConfigError(
                f"available_node_types.{tname}: need 0 <= min_workers "
                f"<= max_workers (got {mn}, {mx})"
            )
    for key in ("max_workers",):
        if key in cfg and int(cfg[key]) < 0:
            raise ClusterConfigError(f"{key} must be >= 0")


def _state_path(name: str) -> str:
    os.makedirs(_STATE_DIR, exist_ok=True)
    return os.path.join(_STATE_DIR, f"{name}.json")


def _load_state(name: str) -> Optional[Dict[str, Any]]:
    try:
        with open(_state_path(name)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def _save_state(name: str, state: Dict[str, Any]) -> None:
    with open(_state_path(name), "w") as f:
        json.dump(state, f, indent=1)


def _pid_start_time(pid: Optional[int]) -> Optional[int]:
    """Kernel start time (clock ticks since boot) of a pid — the identity
    check that makes persisted pids safe across reboots/recycling: a
    recycled pid has a different start time, so up/down never adopts or
    kills an unrelated process."""
    if not pid:
        return None
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
        # field 22, counted after the parenthesized comm (which may
        # itself contain spaces/parens)
        return int(stat.rsplit(")", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return None


def _pid_alive(pid: Optional[int], start_time: Optional[int] = None) -> bool:
    if not pid:
        return False
    try:
        # reap first if it's our zombie child: kill(pid, 0) SUCCEEDS on
        # zombies, so a killed-but-unreaped monitor would read as alive
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass  # not our child (different launcher process): signal 0 is it
    except OSError:
        pass
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    if start_time is not None:
        now_start = _pid_start_time(pid)
        if now_start is not None and now_start != start_time:
            return False  # pid recycled by an unrelated process
    return True


def _stop_pid(pid: Optional[int], timeout_s: float,
              start_time: Optional[int] = None) -> None:
    """SIGTERM -> wait (reaping zombies) -> SIGKILL -> reap. With a
    recorded start_time, a recycled pid is never signalled."""
    if not _pid_alive(pid, start_time):
        return
    try:
        os.kill(pid, signal.SIGTERM)
    except OSError:
        return
    deadline = time.time() + timeout_s
    while _pid_alive(pid) and time.time() < deadline:
        time.sleep(0.2)
    if _pid_alive(pid):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
        deadline = time.time() + 5.0
        while _pid_alive(pid) and time.time() < deadline:
            time.sleep(0.1)


def create_or_update_cluster(config_path: str,
                             no_monitor: bool = False) -> Dict[str, Any]:
    """``ray_tpu_torch up``: start the head (idempotent — a live head is
    adopted, not replaced), then (re)start the autoscaler monitor that
    satisfies min_workers floors and scales with demand. Returns the
    cluster state dict."""
    cfg = load_config(config_path)
    name = cfg["cluster_name"]
    state = _load_state(name) or {}

    if state and _pid_alive(state.get("head_pid"),
                            state.get("head_pid_start")):
        print(f"cluster {name!r}: head already running at "
              f"{state['address']} (re-up reconciles the monitor only)")
    else:
        # dead head: an old monitor (and its provider nodes) would keep
        # running against the dead address forever — stop it before the
        # fresh state dict drops its pid
        if state and _pid_alive(state.get("monitor_pid"),
                                state.get("monitor_pid_start")):
            print(f"cluster {name!r}: stopping stale monitor "
                  f"(pid {state['monitor_pid']}) of the dead head")
            _stop_pid(state["monitor_pid"], 30.0,
                      state.get("monitor_pid_start"))
        from ray_tpu_torch._private.node import NodeProcesses

        head_res = (cfg.get("head_node") or {}).get("resources")
        node = NodeProcesses(head=True, resources=head_res)
        state = {
            "cluster_name": name,
            "address": node.address,
            "session_dir": node.session_dir,
            "token_file": node.token_file,
            "head_pid": node.gcs_proc.pid,
            "head_pid_start": _pid_start_time(node.gcs_proc.pid),
            "head_pids": [node.gcs_proc.pid, node.raylet_proc.pid],
            "head_pid_starts": [
                _pid_start_time(node.gcs_proc.pid),
                _pid_start_time(node.raylet_proc.pid),
            ],
            "started_at": time.time(),
        }
        print(f"cluster {name!r}: head started at {node.address}")

    # (re)start the monitor: one per cluster; a live one is adopted
    if not no_monitor:
        if _pid_alive(state.get("monitor_pid"),
                      state.get("monitor_pid_start")):
            print(f"cluster {name!r}: monitor already running "
                  f"(pid {state['monitor_pid']})")
        else:
            log_path = os.path.join(state["session_dir"], "logs",
                                    "monitor.log")
            env = dict(os.environ)
            if state.get("token_file"):
                try:
                    with open(state["token_file"]) as f:
                        env["RAY_TPU_TORCH_CLUSTER_TOKEN"] = f.read().strip()
                except OSError:
                    pass
            with open(log_path, "ab") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.autoscaler.monitor",
                     "--config", os.path.abspath(config_path),
                     "--gcs-address", state["address"],
                     "--session-dir", state["session_dir"]],
                    stdout=log, stderr=log, env=env,
                    start_new_session=True,
                )
            state["monitor_pid"] = proc.pid
            state["monitor_pid_start"] = _pid_start_time(proc.pid)
            print(f"cluster {name!r}: autoscaler monitor started "
                  f"(pid {proc.pid}, log {log_path})")
    state["config_path"] = os.path.abspath(config_path)
    _save_state(name, state)
    print(f"connect drivers with ray_tpu_torch.init(address=\"{state['address']}\")")
    return state


def teardown_cluster(config_path: str, timeout_s: float = 30.0) -> None:
    """``ray_tpu_torch down``: stop the monitor (it terminates provider nodes
    on SIGTERM), then the head processes, then drop the state file."""
    cfg = load_config(config_path)
    name = cfg["cluster_name"]
    state = _load_state(name)
    if state is None:
        print(f"cluster {name!r}: no recorded state — nothing to do")
        return
    mpid = state.get("monitor_pid")
    if _pid_alive(mpid, state.get("monitor_pid_start")):
        _stop_pid(mpid, timeout_s, state.get("monitor_pid_start"))
        print(f"cluster {name!r}: monitor stopped")
    starts = state.get("head_pid_starts") or [None] * len(
        state.get("head_pids", [])
    )
    for pid, st in zip(state.get("head_pids", []), starts):
        _stop_pid(pid, timeout_s, st)
    # Straggler sweep: if the monitor died (or was SIGKILLed past its
    # provider-shutdown finally), its worker raylets survive it — kill
    # anything still attached to this cluster's session dir so `down`
    # never leaks processes the state file is about to forget.
    session = state.get("session_dir", "")
    if session:
        subprocess.run(
            ["pkill", "-f",
             f"ray_tpu_torch._private.*{os.path.basename(session)}"],
            check=False,
        )
    try:
        os.unlink(_state_path(name))
    except FileNotFoundError:
        pass
    print(f"cluster {name!r}: down")


def cluster_status(config_path: str, timeout_s: float = 15.0) -> Dict:
    """``ray_tpu_torch status <yaml>``: live node table from the cluster's GCS
    plus launcher-side process state."""
    cfg = load_config(config_path)
    name = cfg["cluster_name"]
    state = _load_state(name)
    out: Dict[str, Any] = {"cluster_name": name, "up": False, "nodes": []}
    if state is None:
        print(f"cluster {name!r}: not started")
        return out
    out["address"] = state.get("address")
    out["head_alive"] = _pid_alive(state.get("head_pid"),
                                   state.get("head_pid_start"))
    out["monitor_alive"] = _pid_alive(state.get("monitor_pid"),
                                      state.get("monitor_pid_start"))
    out["up"] = out["head_alive"]
    if out["head_alive"]:
        from ray_tpu_torch._private.rpcio import EventLoopThread, connect

        # THIS cluster's token, restored afterwards: caching the first
        # cluster's token into the process env would authenticate a later
        # status query against cluster B with cluster A's token
        token_file = state.get("token_file")
        prev_token = os.environ.get("RAY_TPU_TORCH_CLUSTER_TOKEN")
        if token_file:
            try:
                with open(token_file) as f:
                    os.environ["RAY_TPU_TORCH_CLUSTER_TOKEN"] = f.read().strip()
            except OSError:
                pass
        io = EventLoopThread("status-io")
        try:
            host, port = state["address"].rsplit(":", 1)
            conn = io.run(connect(host, int(port)), timeout=timeout_s)
            nodes = io.run(conn.request("get_nodes", {}),
                           timeout=timeout_s)
            out["nodes"] = nodes.get("nodes", nodes) \
                if isinstance(nodes, dict) else nodes
        except Exception as e:
            # head pid alive but GCS unreachable (hung, port gone): still
            # report what we know instead of dumping a traceback
            out["gcs_error"] = f"{type(e).__name__}: {e}"
        finally:
            io.stop()
            if prev_token is None:
                os.environ.pop("RAY_TPU_TORCH_CLUSTER_TOKEN", None)
            else:
                os.environ["RAY_TPU_TORCH_CLUSTER_TOKEN"] = prev_token
    print(f"cluster {name!r}: head={'UP' if out['head_alive'] else 'DOWN'} "
          f"monitor={'UP' if out['monitor_alive'] else 'DOWN'} "
          f"address={out.get('address')}")
    for n in out["nodes"]:
        nid = (n.get("node_id") or "")[:12]
        res = n.get("resources_total") or n.get("resources") or {}
        labels = n.get("labels") or {}
        group_label = labels.get("gpu-group", "")
        print(f"  node {nid}  alive={n.get('alive', n.get('state'))}  "
              f"resources={res}  {('group=' + group_label) if group_label else ''}")
    return out
