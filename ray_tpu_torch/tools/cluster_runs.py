"""The cluster run of ``chip_smoke.py`` phase 33, shared with the CPU tests
so that both drive one and the same path.

``drive`` runs it the way a user types it, each command a subprocess of
``python -m ray_tpu_torch`` under a ``HOME`` of its own: ``up`` a cluster
from a YAML whose head advertises no GPU and whose one worker node type
(``gpu_node``) the autoscaler launches on demand, ``status``, then
``submit`` of this module's ``job`` entrypoint, which trains GPT-2 with
``TorchTrainer`` over a hybrid mesh from the head node. The gang's
placement group is the demand that makes the monitor launch ``gpu_node``;
the gang trains there. Once the job ends, the idle node is torn down,
``microbenchmark --small`` runs against the head, and ``down`` stops the
rest. ``drive`` returns what it saw, with the seconds of each step; the
caller holds it to its checks.

    python -m ray_tpu_torch.tools.cluster_runs job CONFIG_JSON

is the job's entrypoint. It prints each step's loss and, last, one line
``CLUSTER_JOB {...}``: the worker's reports (loss, step ms, node id,
launch counts) and the node table.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

JOB_MARK = "CLUSTER_JOB "
NODE_TYPE = "gpu_node"
TOKEN_ENV = "RAY_TPU_TORCH_CLUSTER_TOKEN"
IDLE_TIMEOUT_MINUTES = 0.1


def cluster_config(name: str,
                   worker_resources: Dict[str, float]) -> Dict[str, Any]:
    """The cluster's YAML as a dict: a head with 4 CPUs and no GPU, and one
    worker node type, ``gpu_node``, with ``worker_resources``, 0 to 1 of
    it, torn down after ``IDLE_TIMEOUT_MINUTES`` idle."""
    return {
        "cluster_name": name,
        "idle_timeout_minutes": IDLE_TIMEOUT_MINUTES,
        "provider": {"type": "fake_gpu_node"},
        "head_node": {"resources": {"CPU": 4, "GPU": 0}},
        "available_node_types": {NODE_TYPE: {
            "resources": dict(worker_resources),
            "min_workers": 0, "max_workers": 1}},
    }


# ---------------------------------------------------------------------------
# the job: its driver runs on the head, its gang on the launched node
# ---------------------------------------------------------------------------

def _model_config(config):
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.tools import train_runs

    if config["model"] == "gpt2_124m":
        return train_runs.bf16_config()
    return gpt2.GPT2Config.small_test(attention="flash", loss_chunks=4,
                                      dtype=getattr(torch, config["dtype"]))


def job_loop(config):
    """The gang's loop: GPT-2 from seed 0 on one fixed batch from seed 1,
    its mesh ``create_hybrid_mesh`` over the gang (FSDP within a node, data
    parallelism between nodes), the state sharded with FSDP2 over it, then
    ``config["steps"]`` steps, each reported with every step so far: loss,
    step ms, this worker's node id, pid and device, and its kernel launch
    counts and plain-version calls since the loop began."""
    import time as _time

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import parallel, train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import train_runs

    t_loop = _time.time()
    attn.zero_launches()
    ctx = train.get_context()
    nodes = ctx.get_world_size() // ctx.get_local_world_size()
    mesh = parallel.create_hybrid_mesh(
        {"fsdp": ctx.get_local_world_size()}, {"data": nodes})
    device = torch.device("cuda", torch.cuda.current_device()) \
        if config["device"] == "cuda" else torch.device("cpu")
    cfg = _model_config(config)
    model, opt = gpt2.make_train_state(cfg, torch.Generator().manual_seed(0),
                                       device=device)
    model, opt = gpt2.shard_train_state(model, opt, mesh, fsdp=True)
    step = gpt2.build_train_step(model, opt, mesh=mesh)
    batch = gpt2.shard_batch(gpt2.synthetic_batch(
        1, config["batch"], config["seq"], cfg.vocab_size, device=device),
        mesh)
    node_id = rt.get_runtime_context().get_node_id()
    steps = []
    with train_runs.counting_plain_calls() as plain_calls:
        for i in range(config["steps"]):
            t0 = _time.perf_counter()
            model, opt, loss = step(model, opt, batch)
            loss = float(loss)
            steps.append({
                "step": i, "loss": loss,
                "step_ms": (_time.perf_counter() - t0) * 1e3,
                "node_id": node_id, "pid": os.getpid(),
                "device": str(device),
                "device_name": torch.cuda.get_device_name(device)
                if device.type == "cuda" else None,
                "launches": attn.read_launches(),
                "plain_calls": plain_calls[0],
                "mesh": [list(mesh.mesh_dim_names),
                         list(mesh.mesh.shape)],
                "loop_start": t_loop})
            train.report({"steps": list(steps)})


def job(config: Dict[str, Any]) -> int:
    """The job's driver: joins the cluster the supervisor runs in and fits
    ``job_loop`` over ``config["workers"]`` workers. It never touches CUDA
    itself: the gang's GPU lease is the demand the autoscaler serves."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    rt.init(address="auto")
    try:
        if config["use_gpu"]:
            scaling = train.ScalingConfig(num_workers=config["workers"],
                                          use_gpu=True)
            backend = None
        else:  # a logical GPU lease on CPU processes, over gloo
            scaling = train.ScalingConfig(
                num_workers=config["workers"], use_gpu=False,
                resources_per_worker={"CPU": 1, "GPU": 1})
            backend = "gloo"
        trainer = train.TorchTrainer(
            job_loop, train_loop_config=config, scaling_config=scaling,
            torch_config=train.TorchConfig(backend=backend),
            run_config=train.RunConfig(name="cluster_job",
                                       storage_path=config["storage"]))
        t0 = time.time()
        result = trainer.fit()
        fit_s = time.time() - t0
        steps = (result.metrics or {}).get("steps") or []
        for s in steps:
            print(f"step {s['step']} loss {s['loss']!r}", flush=True)
        print(JOB_MARK + json.dumps({
            "steps": steps, "fit_start": t0, "fit_s": fit_s,
            "driver_node": rt.get_runtime_context().get_node_id(),
            "nodes": [{k: n.get(k) for k in ("node_id", "alive",
                                             "resources_total", "labels")}
                      for n in rt.nodes()],
            "error": None if result.error is None else repr(result.error),
        }), flush=True)
        return 0 if result.error is None and steps else 1
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# the driver of the whole run: the commands a user types
# ---------------------------------------------------------------------------

def session_processes(session_dir: str) -> List[int]:
    """Pids of the processes of one session: the GCS, raylets and agents
    name its session dir in their argv, its workers carry it in
    ``RAY_TPU_TORCH_SESSION_DIR``."""
    mark = session_dir.encode()
    env_mark = b"RAY_TPU_TORCH_SESSION_DIR=" + mark
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read()
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
            with open(f"/proc/{pid}/stat") as f:
                zombie = f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except OSError:
            continue
        if not zombie and (mark in argv or env_mark in env):
            found.append(int(pid))
    return found


def node_table(address: str, token: str,
               timeout_s: float = 10.0) -> List[dict]:
    """The GCS's node table, over one connection made with ``token`` (this
    process's own cluster token, if it has a cluster, is left as it is)."""
    from ray_tpu_torch._private.rpcio import EventLoopThread, connect

    io = EventLoopThread("cluster-runs-io")
    try:
        host, port = address.rsplit(":", 1)
        conn = io.run(connect(host, int(port), token=token),
                      timeout=timeout_s)
        nodes = io.run(conn.request("get_nodes", {}), timeout=timeout_s)
        return nodes.get("nodes", nodes) if isinstance(nodes, dict) \
            else nodes
    finally:
        io.stop()


def _launched(nodes: List[dict]) -> List[dict]:
    return [n for n in nodes if n.get("alive", True)
            and (n.get("labels") or {}).get("gpu-group") == NODE_TYPE]


def _wait(predicate, timeout_s: float, interval_s: float = 0.5):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(interval_s)
    return None


def drive(workdir: str, job_config: Dict[str, Any],
          worker_resources: Dict[str, float], name: str = "cluster-run",
          job_timeout_s: float = 600) -> Dict[str, Any]:
    """Runs the whole sequence in ``workdir`` (its ``home`` is the
    commands' ``HOME``) and returns the outputs, the job's record
    (``job``), the node tables seen, and seconds: ``up_s``,
    ``submit_to_node_s`` (submit to the launched node's registration),
    ``gang_start_s`` (``fit()`` to the loop's start), ``job_wall_s``
    (submit to the job's end), ``teardown_s`` (the job's end to the idle
    node's removal) and ``down_s``. Whatever fails, the cluster is taken
    down before it returns or raises."""
    import yaml

    from ray_tpu_torch._private.node import package_env

    home = os.path.join(workdir, "home")
    os.makedirs(home, exist_ok=True)
    env = package_env(dict(os.environ, HOME=home))
    for key in (TOKEN_ENV, "RAY_TPU_TORCH_GCS_ADDR",
                "RAY_TPU_TORCH_SESSION_DIR"):
        env.pop(key, None)
    path = os.path.join(workdir, "cluster.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cluster_config(name, worker_resources), f)
    job_config = dict(job_config,
                      storage=os.path.join(workdir, "results"))

    def cli(*args, timeout=180):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", *args], env=env,
            capture_output=True, text=True, timeout=timeout)

    out: Dict[str, Any] = {"config_path": path}
    t0 = time.perf_counter()
    up = cli("up", path)
    out["up_s"] = time.perf_counter() - t0
    out["up"] = up.stdout + up.stderr
    if up.returncode != 0:
        raise RuntimeError(f"up failed: {out['up']}")
    try:
        with open(os.path.join(home, ".ray_tpu_torch", "clusters",
                               f"{name}.json")) as f:
            state = json.load(f)
        out["state"] = state
        address = state["address"]
        with open(state["token_file"]) as f:
            token = f.read().strip()
        # what `up` leaves a user to export before the other commands
        env[TOKEN_ENV] = token
        status = cli("status", "--address", address)
        out["status"] = status.stdout + status.stderr
        out["nodes_before"] = node_table(address, token)

        t_submit = time.perf_counter()
        sub = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "submit", "--address",
             address, "--timeout", str(job_timeout_s), "--", sys.executable,
             "-m", "ray_tpu_torch.tools.cluster_runs", "job",
             json.dumps(job_config)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        registered = _wait(lambda: _launched(node_table(address, token)),
                           timeout_s=job_timeout_s)
        out["submit_to_node_s"] = (time.perf_counter() - t_submit) \
            if registered else None
        out["launched_nodes"] = registered or []
        try:
            submitted = sub.communicate(timeout=job_timeout_s + 60)[0]
        except subprocess.TimeoutExpired:
            sub.kill()
            submitted = sub.communicate()[0]
        t_end = time.perf_counter()
        out["job_wall_s"] = t_end - t_submit
        out["submit"] = submitted
        out["submit_rc"] = sub.returncode
        record = [ln for ln in submitted.splitlines()
                  if ln.startswith(JOB_MARK)]
        out["job"] = json.loads(record[-1][len(JOB_MARK):]) if record \
            else None
        sid = [ln.split()[-1] for ln in submitted.splitlines()
               if ln.startswith("submitted job ")]
        out["submission_id"] = sid[0] if sid else None
        if sid:
            logs = cli("job", "logs", sid[0], "--address", address)
            out["job_logs"] = logs.stdout
        if out["job"] and out["job"]["steps"]:
            first = out["job"]["steps"][0]
            out["gang_start_s"] = first["loop_start"] - \
                out["job"]["fit_start"]
        gone = _wait(lambda: not _launched(node_table(address, token)),
                     timeout_s=IDLE_TIMEOUT_MINUTES * 60 + 60)
        out["teardown_s"] = (time.perf_counter() - t_end) if gone else None
        out["nodes_after"] = node_table(address, token)
        t0 = time.perf_counter()
        bench = cli("microbenchmark", "--small", "--address", address,
                    timeout=300)
        out["microbenchmark_s"] = time.perf_counter() - t0
        out["microbenchmark"] = bench.stdout
        out["microbenchmark_rc"] = bench.returncode
    finally:
        t0 = time.perf_counter()
        down = cli("down", path)
        out["down_s"] = time.perf_counter() - t0
        out["down"] = down.stdout + down.stderr
        session = (out.get("state") or {}).get("session_dir")
        if session:
            _wait(lambda: not session_processes(session), timeout_s=30)
            out["processes_left"] = session_processes(session)
    return out


def problems(out: Dict[str, Any], steps: int,
             launches_per_step: Optional[int]) -> List[str]:
    """What ``out`` (from ``drive``) fails of the run's checks, the losses
    aside: the head advertises no GPU, the job succeeded and its logs
    carry the losses, the gang trained on the launched node (not the
    head's), ``launches_per_step`` launches of each kernel a step where
    given and no call of their plain versions then, the idle node was
    torn down and ``down`` left no process of the session."""
    found = []
    if "1/1 nodes alive" not in out.get("status", ""):
        found.append(f"status: {out.get('status')!r}")
    head = out.get("nodes_before") or []
    if len(head) != 1 or (head[0].get("resources_total") or {}).get(
            "GPU", 0) > 0:
        found.append(f"the head's node table: {head}")
    job_rec = out.get("job")
    if out.get("submit_rc") != 0 or "SUCCEEDED" not in out.get("submit", ""):
        found.append(f"submit rc {out.get('submit_rc')}: "
                     f"{out.get('submit', '')[-3000:]}")
    if not job_rec or len(job_rec["steps"]) != steps:
        return found + ["no job record with every step"]
    reps = job_rec["steps"]
    for s in reps:
        if f"step {s['step']} loss {s['loss']!r}" not in \
                out.get("job_logs", ""):
            found.append(f"job logs lack step {s['step']}'s loss")
            break
    launched = {n["node_id"] for n in out.get("launched_nodes") or []}
    head_ids = {n["node_id"] for n in head}
    workers = {s["node_id"] for s in reps}
    if not launched or workers != launched or workers & head_ids:
        found.append(f"the gang ran on {workers}; launched {launched}, "
                     f"head {head_ids}")
    if launches_per_step is not None:
        from ray_tpu_torch.ops.attention import KERNELS

        want = dict.fromkeys(KERNELS, launches_per_step * steps)
        if reps[-1]["launches"] != want:
            found.append(f"launches {reps[-1]['launches']}, want {want}")
        if reps[-1]["plain_calls"]:
            found.append(f"{reps[-1]['plain_calls']} plain-version calls")
    if out.get("teardown_s") is None:
        found.append(f"the idle node was not torn down: "
                     f"{out.get('nodes_after')}")
    if out.get("processes_left"):
        found.append(f"processes left after down: {out['processes_left']}")
    return found


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "job":
        sys.exit("usage: python -m ray_tpu_torch.tools.cluster_runs job "
                 "CONFIG_JSON")
    sys.exit(job(json.loads(sys.argv[2])))
