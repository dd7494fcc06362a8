"""Command-line interface: start/stop/status/submit/list/logs/timeline.

ray parity: python/ray/scripts/scripts.py (`ray start --head`,
`ray start --address`, `ray stop`, `ray status`, `ray job submit`,
`ray timeline`). Invoked as ``python -m ray_tpu_torch <command>``.

`start --head` spawns the GCS + a raylet detached and records the cluster
in a state file (~/.ray_tpu_torch/cluster.json) so later commands find it;
`start --address host:port` joins an existing cluster with a local raylet.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

STATE_DIR = os.path.expanduser("~/.ray_tpu_torch")
STATE_FILE = os.path.join(STATE_DIR, "cluster.json")


def _save_state(state: dict):
    os.makedirs(STATE_DIR, exist_ok=True)
    with open(STATE_FILE, "w") as f:
        json.dump(state, f, indent=2)


def _load_state() -> dict:
    try:
        with open(STATE_FILE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None) or os.environ.get("RAY_TPU_TORCH_GCS_ADDR")
    if not addr:
        addr = _load_state().get("address")
    if not addr:
        sys.exit("no cluster address: pass --address, set RAY_TPU_TORCH_GCS_ADDR, "
                 "or run `ray_tpu_torch start --head` on this machine first")
    # Load the persisted cluster token so this process authenticates; a
    # missing token would be silently dropped by rpcio's auth preamble.
    from ray_tpu_torch._private.node import load_cluster_token

    load_cluster_token()
    return addr


def cmd_start(args):
    from ray_tpu_torch._private.node import NodeProcesses

    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    if args.num_gpus is not None:
        resources["GPU"] = float(args.num_gpus)
    if args.head:
        node = NodeProcesses(head=True, resources=resources or None)
        state = {
            "address": node.address,
            "session_dir": node.session_dir,
            "token_file": node.token_file,
            "pids": [node.gcs_proc.pid, node.raylet_proc.pid],
            "started_at": time.time(),
        }
        _save_state(state)
        print(f"started head node: address={node.address}")
        print(f"session dir: {node.session_dir}")
        print("connect drivers with "
              f"ray_tpu_torch.init(address=\"{node.address}\")")
        if node.token_file:
            # never print the token itself: it would persist in terminal
            # scrollback / CI logs and weaken the bearer-token posture
            print("to join from another machine, copy the contents of\n"
                  f"  {node.token_file}\n"
                  "(on this head node) into RAY_TPU_TORCH_CLUSTER_TOKEN there; "
                  "on this machine:\n"
                  f"  export RAY_TPU_TORCH_CLUSTER_TOKEN=$(cat {node.token_file})")
    else:
        address = _resolve_address(args)
        host, port = address.rsplit(":", 1)
        node = NodeProcesses(
            head=False, gcs_host=host, gcs_port=int(port),
            session_dir=args.session_dir, resources=resources or None,
        )
        state = _load_state()
        state.setdefault("worker_pids", []).append(node.raylet_proc.pid)
        _save_state(state)
        print(f"started worker raylet joining {address} "
              f"(node {node.node_id and node.node_id[:8]})")


def cmd_stop(args):
    state = _load_state()
    pids = state.get("pids", []) + state.get("worker_pids", [])
    killed = 0
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
            killed += 1
        except OSError:
            pass
    # Worker processes are children of raylets and exit with them; sweep
    # stragglers of this session.
    session = state.get("session_dir", "")
    if session:
        import subprocess

        subprocess.run(
            ["pkill", "-f", f"ray_tpu_torch._private.*{os.path.basename(session)}"],
            check=False,
        )
    try:
        os.unlink(STATE_FILE)
    except OSError:
        pass
    print(f"stopped {killed} processes")


def cmd_up(args):
    """ray parity: `ray up cluster.yaml` (autoscaler/_private/commands.py
    create_or_update_cluster): workers are GPU nodes launched through a
    NodeProvider, no SSH updaters."""
    from ray_tpu_torch.autoscaler.commands import create_or_update_cluster

    create_or_update_cluster(args.config, no_monitor=args.no_monitor)


def cmd_down(args):
    """ray parity: `ray down cluster.yaml`."""
    from ray_tpu_torch.autoscaler.commands import teardown_cluster

    teardown_cluster(args.config)


def cmd_cluster_status(args):
    from ray_tpu_torch.autoscaler.commands import cluster_status

    cluster_status(args.config)


def cmd_status(args):
    import ray_tpu_torch

    address = _resolve_address(args)
    ray_tpu_torch.init(address=address, namespace="_cli")
    nodes = ray_tpu_torch.nodes()
    total = ray_tpu_torch.cluster_resources()
    avail = ray_tpu_torch.available_resources()
    print(f"cluster at {address}: "
          f"{sum(1 for n in nodes if n['alive'])}/{len(nodes)} nodes alive")
    for n in nodes:
        mark = "+" if n["alive"] else "-"
        print(f"  {mark} {n['node_id'][:12]} {n['host']}:{n['port']} "
              f"{n['resources_total']}")
    print(f"resources: {avail} available of {total}")
    # task-event counts (ray parity: `ray summary tasks` folded into status)
    try:
        from ray_tpu_torch.util import state

        summary = state.summarize_tasks()
        if summary:
            totals = {}
            for entry in summary.values():
                for k, v in entry.items():
                    totals[k] = totals.get(k, 0) + v
            print("tasks: " + ", ".join(
                f"{k}={v}" for k, v in sorted(totals.items()) if k != "total"
            ) + f" (total={totals.get('total', 0)})")
    except Exception:
        pass
    ray_tpu_torch.shutdown()


def cmd_stack(args):
    """ray parity: `ray stack` (py-spy dump of every worker)."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    for node in state.get_stacks(node_id=args.node_id):
        print(f"=== node {node.get('node_id', '?')[:12]} ===")
        if node.get("error"):
            print(f"  ({node['error']})")
            continue
        for wk in node.get("workers", ()):
            task = f" task={wk['current_task']}" if wk.get("current_task") \
                else ""
            print(f"--- worker pid={wk.get('pid')}{task} ---")
            if wk.get("error"):
                print(f"  ({wk['error']})")
                continue
            for tname, stack in wk.get("threads", {}).items():
                print(f"  [{tname}]")
                for line in stack.rstrip().split("\n"):
                    print(f"    {line}")
    ray_tpu_torch.shutdown()


def cmd_profile(args):
    """ray parity: the dashboard's py-spy/memray attach, as a CLI — one
    profiling window fanned out cluster-wide (or per node/actor), merged
    and written as speedscope JSON / collapsed stacks."""
    import ray_tpu_torch
    from ray_tpu_torch.util import profiling

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    try:
        if args.kind == "cpu":
            prof = profiling.profile_cpu(
                duration=args.duration, hz=args.hz, node_id=args.node,
                actor_id=args.actor, include_gcs=args.include_gcs,
            )
            if args.task:
                prof = prof.filter(args.task)
            out = args.output or \
                f"profile-cpu-{int(time.time())}.speedscope.json"
            prof.save(out, format=args.format)
            print(f"{prof.samples} samples from "
                  f"{len(prof.processes)} processes -> {out}")
            for p in prof.errors:
                print(f"  ! {p.get('node_id', '?')[:12]}: {p['error']}")
            for proc in prof.processes:
                extra = f" actor={proc['actor_id'][:12]}" \
                    if proc.get("actor_id") else ""
                print(f"  {proc.get('role', '?'):7s} pid={proc.get('pid')} "
                      f"node={str(proc.get('node_id', ''))[:8]} "
                      f"samples={proc.get('samples')} "
                      f"hz={proc.get('effective_hz')}"
                      f"{' THROTTLED' if proc.get('throttled') else ''}"
                      f"{extra}")
            print("top stacks (leaf <- root):")
            for stack, count in prof.top(args.top):
                frames = stack.split(";")
                print(f"  {count:6d}  {' <- '.join(reversed(frames[-3:]))}")
        else:
            prof = profiling.profile_memory(
                duration=args.duration, node_id=args.node,
                actor_id=args.actor, include_gcs=args.include_gcs,
            )
            if args.output:
                prof.save(args.output)
                print(f"memory profile -> {args.output}")
            print(f"top allocation sites over {args.duration:.0f}s "
                  f"({len(prof.processes)} processes):")
            for s in prof.top(args.top):
                print(f"  {s['size_diff_bytes'] / 1024:+10.1f} KiB "
                      f"({s['count_diff']:+d} blocks)  {s['site']}")
    finally:
        ray_tpu_torch.shutdown()


def cmd_metrics(args):
    """One merged cluster-wide scrape (runtime + user metrics via the
    GCS fan-out). Default output is Prometheus text exposition — pipe it
    anywhere a scrape would go; --summary prints the human table with
    p50/p95/p99 per histogram."""
    import ray_tpu_torch
    from ray_tpu_torch._private import metrics_core
    from ray_tpu_torch.util import metrics as m

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    try:
        snap = m.cluster_snapshot()
        merged = snap.get("merged", {})
        if args.summary:
            summary = metrics_core.summarize(merged)
            name_w = max((len(n) for n in summary), default=10)
            for name, entry in summary.items():
                for s in entry["series"]:
                    tags = ",".join(f"{k}={v}"
                                    for k, v in sorted(s["tags"].items()))
                    label = f"{name}{{{tags}}}" if tags else name
                    if entry["type"] == "histogram":
                        print(f"{label:<{name_w}s}  n={s['count']:<9d} "
                              f"mean={s['mean']:.6f} p50={s['p50']:.6f} "
                              f"p95={s['p95']:.6f} p99={s['p99']:.6f}")
                    else:
                        print(f"{label:<{name_w}s}  {s['value']:.6g}")
        else:
            text = m.prometheus_text(merged)
            if args.output:
                with open(args.output, "w") as f:
                    f.write(text)
                print(f"metrics -> {args.output}")
            else:
                print(text, end="")
        for err in snap.get("errors", ()):
            print(f"! unreachable: {err}", file=sys.stderr)
    finally:
        ray_tpu_torch.shutdown()


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "K", "M", "G", "T"):
        if abs(n) < 1024 or unit == "T":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}T"


def cmd_memory(args):
    """Memory observatory: one cluster-wide object-plane scrape — what
    objects exist (state/size/owner/refs/callsite), per-node arena
    occupancy with dead-byte ranges and fragmentation, the recent
    spill/restore/push/fetch flow log, and leak/pressure verdicts."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    try:
        merged = state.object_summary(group_by=args.group_by)
        if args.output:
            with open(args.output, "w") as f:
                json.dump(merged, f, indent=2, default=str)
            print(f"memory observatory dump -> {args.output}")
        totals = merged.get("totals") or {}
        total_bytes = sum(t["bytes"] for t in totals.values())
        total_count = sum(t["count"] for t in totals.values())
        states = " / ".join(
            f"{s} {t['count']} ({_fmt_bytes(t['bytes'])})"
            for s, t in sorted(totals.items()))
        print(f"cluster objects: {total_count} "
              f"({_fmt_bytes(total_bytes)}): {states or 'none'}")
        for a in merged.get("arenas") or ():
            nid = str(a.get("node_id") or "?")[:12]
            pinned = a.get("pool_pinned") or []
            pin_note = "".join(
                f", {len(pinned)} pinned by pid "
                f"{','.join(map(str, e.get('holder_pids') or ['?']))}"
                for e in pinned[:1])
            spilled = a.get("spilled") or {}
            print(f"node {nid}: {len(a.get('segments') or ())} segs "
                  f"({a.get('leased_segments', 0)} leased), "
                  f"live {_fmt_bytes(a.get('live_bytes'))}, "
                  f"dead {_fmt_bytes(a.get('dead_bytes'))} "
                  f"(frag {100 * (a.get('fragmentation') or 0):.1f}%, "
                  f"punched {_fmt_bytes(a.get('punched_bytes'))}), "
                  f"pool {len(a.get('pool') or ())}{pin_note}, "
                  f"spilled {spilled.get('spilled_objects', 0)}, "
                  f"overshoot "
                  f"{_fmt_bytes(spilled.get('overshoot_bytes_total'))}")
        if args.group_by:
            print(f"objects by {args.group_by}:")
            for g in (merged.get("groups") or ())[:20]:
                print(f"  {_fmt_bytes(g['bytes']):>10s}  "
                      f"{g['count']:>5d}  {g['key']}")
        verdicts = merged.get("verdicts") or []
        leaks = [v for v in verdicts if v["kind"] == "leak"]
        other = [v for v in verdicts if v["kind"] != "leak"]
        for v in other:
            where = str(v.get("node_id") or "?")[:12]
            extra = f" pids={v['holder_pids']}" \
                if v.get("holder_pids") else ""
            extra += f" cause={v['cause']}" if v.get("cause") else ""
            print(f"! {v['kind']} on {where}: "
                  f"{_fmt_bytes(v.get('bytes'))}{extra} — {v['detail']}")
        if args.leaks:
            if not leaks:
                print("no leak verdicts: every resident object is "
                      "referenced by a live process")
            for v in leaks:
                age = f" age={v['age_s']:.0f}s" if v.get("age_s") else ""
                site = f" callsite {v['callsite']}" \
                    if v.get("callsite") else ""
                print(f"! leak ({v['confidence']}): "
                      f"{_fmt_bytes(v['bytes'])} {v['object_id'][:16]}… "
                      f"state={v['state']}{age}{site} — {v['detail']}")
        elif leaks:
            print(f"{len(leaks)} leak verdict(s) "
                  f"({_fmt_bytes(sum(v['bytes'] for v in leaks))}) — "
                  f"rerun with --leaks for the rows")
        for err in merged.get("errors", ()):
            print(f"! unreachable: {err}", file=sys.stderr)
    finally:
        ray_tpu_torch.shutdown()


def cmd_logs(args):
    """ray parity: `ray logs` — the cluster log plane's CLI. With no
    target, prints the cluster log listing (every node agent's files).
    `task <id>` returns exactly that task's output via its attribution
    byte range (offsets stamped by the executor, not a grep); `actor
    <id>` tails the actor worker's log; `worker|gcs|raylet` tail the
    matching session files."""
    import re

    import ray_tpu_torch
    from ray_tpu_torch.util import state

    # log_to_driver=False: this CLI must not re-stream the logs it is
    # about to print explicitly
    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli",
                 log_to_driver=False)
    pat = re.compile(args.grep) if args.grep else None

    def emit(lines, prefix=""):
        for ln in lines:
            if pat and not pat.search(ln):
                continue
            print(f"{prefix}{ln}")

    try:
        target = args.target
        if target is None:
            for nid, files in state.list_logs(node_id=args.node).items():
                print(f"=== node {nid[:12]} ===")
                if isinstance(files, dict):
                    print(f"  ({files.get('error', 'unavailable')})")
                    continue
                for f in files:
                    print(f"  {f['bytes']:>12,d}  {f['file']}")
            return
        # file tails default to the last 100 lines; the TASK target must
        # not truncate silently — its contract is the task's EXACT output
        tail = args.tail if args.tail is not None else 100
        if target == "task":
            if not args.ident:
                sys.exit("usage: ray_tpu_torch logs task <task_id_hex>")
            emit(state.get_log(task_id=args.ident, tail=args.tail))
            return
        if target == "actor":
            if not args.ident:
                sys.exit("usage: ray_tpu_torch logs actor <actor_id_hex>")
            out = state.get_log(actor_id=args.ident, tail=tail,
                                follow=args.follow)
            if args.follow:
                try:
                    for ln in out:
                        emit([ln])
                except KeyboardInterrupt:
                    return
            else:
                emit(out)
            return
        # file targets: worker|gcs|raylet [filename]
        prefixes = {"worker": "worker-", "gcs": "gcs.", "raylet": "raylet_"}
        if target not in prefixes:
            sys.exit(f"unknown logs target {target!r} "
                     f"(task|actor|worker|gcs|raylet)")
        if args.ident:
            files = [(args.node, args.ident)]
        else:
            files = []
            for nid, listing in state.list_logs(node_id=args.node).items():
                if isinstance(listing, dict):
                    continue
                files.extend(
                    (nid, f["file"]) for f in listing
                    if f["file"].startswith(prefixes[target]))
        if not files:
            sys.exit(f"no {target} log files found")
        if args.follow:
            if len(files) > 1:
                sys.exit(f"--follow needs one file; matched "
                         f"{[f for _, f in files]} (pass the filename)")
            nid, fname = files[0]
            try:
                for ln in state.get_log(filename=fname, node_id=nid,
                                        tail=tail, follow=True):
                    emit([ln])
            except KeyboardInterrupt:
                return
            return
        for nid, fname in files:
            prefix = f"[{fname}] " if len(files) > 1 else ""
            try:
                emit(state.get_log(filename=fname, node_id=nid,
                                   tail=tail), prefix=prefix)
            except ValueError as e:
                print(f"{prefix}({e})", file=sys.stderr)
    finally:
        ray_tpu_torch.shutdown()


def cmd_events(args):
    import ray_tpu_torch
    from ray_tpu_torch.util import events as ev

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    rows = ev.list_events(severity=args.severity or None,
                          source=args.source or None,
                          limit=args.limit)
    import datetime

    for e in reversed(rows):  # oldest first for reading
        ts = datetime.datetime.fromtimestamp(e["timestamp"]).strftime(
            "%H:%M:%S"
        )
        print(f"{ts} [{e['severity']:<7s}] {e['source']}/{e['label']}: "
              f"{e['message']}")
    ray_tpu_torch.shutdown()


def cmd_submit(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    address = _resolve_address(args)
    client = JobSubmissionClient(address)
    runtime_env = {}
    if args.working_dir:
        runtime_env["working_dir"] = args.working_dir
    import shlex

    if not args.entrypoint:
        sys.exit("no entrypoint given: ray_tpu_torch submit -- <command> [args...]")
    entrypoint = shlex.join(args.entrypoint)
    sid = client.submit_job(
        entrypoint=entrypoint, runtime_env=runtime_env or None,
        submission_id=args.submission_id,
    )
    print(f"submitted job {sid}")
    if args.no_wait:
        return
    status = client.wait_until_finished(sid, timeout=args.timeout)
    print(client.get_job_logs(sid), end="")
    print(f"job {sid}: {status}")
    if status != "SUCCEEDED":
        sys.exit(1)


def cmd_job_list(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    for job in client.list_jobs():
        print(f"{job['submission_id']}  {job['status']:10s}  "
              f"{job['entrypoint']}")


def cmd_job_logs(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    print(client.get_job_logs(args.submission_id), end="")


def cmd_job_stop(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args))
    ok = client.stop_job(args.submission_id)
    print("stopped" if ok else "not running")


def cmd_timeline(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    path = args.output or f"ray-tpu-torch-timeline-{int(time.time())}.json"
    events = ray_tpu_torch.timeline(path)
    print(f"wrote {len(events)} trace events to {path}")
    ray_tpu_torch.shutdown()


def cmd_train_timeline(args):
    """Step observatory export: one cluster scrape of the per-rank
    steptrace rings, merged by (group, seq), written as Chrome-trace /
    Perfetto JSON, with the per-rank straggler attribution printed as a
    table (score = rolling EWMA of 'arrived last to a collective')."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    try:
        merged = state.steptrace_summary()
        from ray_tpu_torch._private import steptrace

        trace = steptrace.chrome_trace(merged)
        path = args.output or f"ray-tpu-torch-train-timeline-{int(time.time())}.json"
        with open(path, "w") as f:
            json.dump(trace, f)
        colls = merged.get("collectives", ())
        print(f"wrote {len(trace)} trace events to {path} "
              f"({len(colls)} collectives, "
              f"{len(merged.get('steps', ()))} steps, "
              f"{len(merged.get('compiles', ()))} compiles)")
        scores = merged.get("straggler_scores") or {}
        if scores:
            print("per-rank straggler score (EWMA of 'arrived last'; "
                  f"~{1.0 / max(len(scores), 1):.2f} is uniform):")
            for rank, score in sorted(scores.items(),
                                      key=lambda kv: -kv[1]):
                print(f"  rank {rank:>3s}  {score:.3f}")
        worst = [c for c in colls if c.get("skew", 0) > 0]
        worst.sort(key=lambda c: -c["skew"])
        for c in worst[: args.top]:
            print(f"  skew {c['skew'] * 1e3:8.3f}ms  {c['group']}#{c['seq']} "
                  f"{c['op']} last=rank{c['last_rank']}"
                  + (f" missing={c['missing']}" if c["missing"] else ""))
        for err in merged.get("errors", ()):
            print(f"! unreachable: {err}", file=sys.stderr)
    finally:
        ray_tpu_torch.shutdown()


def cmd_list(args):
    """ray parity: `ray list tasks|actors|nodes|objects|placement-groups|
    jobs` (util/state CLI)."""
    filters = []
    for f in args.filter or ():
        if "!=" in f:
            key, value = f.split("!=", 1)
            filters.append((key, "!=", value))
        elif "=" in f:
            key, value = f.split("=", 1)
            filters.append((key, "=", value))
        else:  # reject bad syntax BEFORE paying the cluster connect
            sys.exit(f"bad filter {f!r}: use key=value or key!=value")

    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    fns = {
        "tasks": state.list_tasks,
        "actors": state.list_actors,
        "nodes": state.list_nodes,
        "objects": state.list_objects,
        "placement-groups": state.list_placement_groups,
        "jobs": state.list_jobs,
        "workers": state.list_workers,
    }
    rows = fns[args.resource](filters=filters, limit=args.limit)
    print(json.dumps(rows, indent=2, default=str))
    ray_tpu_torch.shutdown()


def cmd_summary(args):
    """ray parity: `ray summary tasks`."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli")
    for name, entry in sorted(state.summarize_tasks().items()):
        print(f"{name:30s} total={entry['total']:5d} "
              f"finished={entry['FINISHED']:5d} failed={entry['FAILED']:4d} "
              f"running={entry['RUNNING']:4d} pending={entry['PENDING']:4d}")
    ray_tpu_torch.shutdown()


def cmd_serve_deploy(args):
    """ray parity: `serve deploy config.yaml` (REST path collapsed to a
    direct client call)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

    with open(args.config) as f:
        config = json.load(f)
    ray_tpu_torch.init(address=_resolve_address(args), namespace="serve",
                 ignore_reinit_error=True)
    deployed = serve.deploy_config(config)
    print(f"deployed applications: {', '.join(deployed)}")


def cmd_serve_status(args):
    import ray_tpu_torch
    from ray_tpu_torch import serve

    ray_tpu_torch.init(address=_resolve_address(args), namespace="serve",
                 ignore_reinit_error=True)
    status = serve.status()
    if not status:
        print("no Serve applications")
        return
    for app, info in status.items():
        print(f"{app}: {info}")


def cmd_serve_llm(args):
    """LLM serving observatory: per-replica sequence load + prefix-digest
    size from the controller's load reports, and the cluster-scraped KV
    cache gauges (page states, per-replica hit rate, token/shed
    counters)."""
    import ray_tpu_torch
    from ray_tpu_torch.serve._common import SERVE_CONTROLLER_NAME, SERVE_NAMESPACE
    from ray_tpu_torch._private import metrics_core
    from ray_tpu_torch.util import metrics as m

    ray_tpu_torch.init(address=_resolve_address(args), namespace=SERVE_NAMESPACE,
                 ignore_reinit_error=True)
    try:
        try:
            controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                                           namespace=SERVE_NAMESPACE)
        except Exception:
            print("no Serve controller (is serve running?)")
            return
        status = ray_tpu_torch.get(controller.get_serve_status.remote(),
                             timeout=30)
        dump = {"deployments": [], "metrics": {}}
        found = False
        for app, info in (status or {}).items():
            for dep in (info.get("deployments") or {}):
                st = ray_tpu_torch.get(
                    controller.get_replica_state.remote(app, dep),
                    timeout=30)
                llm = st.get("llm") or {}
                if not llm:
                    continue
                found = True
                age = st.get("loads_age_s")
                print(f"{app}/{dep} (report age "
                      f"{age:.1f}s):" if age is not None
                      else f"{app}/{dep}:")
                for name, blk in sorted(llm.items()):
                    digest = blk.get("prefix_digest") or ()
                    print(f"  replica {name}: "
                          f"queued={blk.get('queued_seqs', 0)} "
                          f"running={blk.get('running_seqs', 0)} "
                          f"block_tokens={blk.get('block_tokens', 0)} "
                          f"cached_prefix_blocks={len(digest)}")
                dump["deployments"].append(
                    {"app": app, "deployment": dep, "loads_age_s": age,
                     "replicas": {n: {k: (len(v) if k == "prefix_digest"
                                          else v)
                                      for k, v in blk.items()}
                                  for n, blk in llm.items()}})
        if not found:
            print("no LLM deployments reporting (engine.LLMServer "
                  "replicas publish via the controller load probe)")
        summary = metrics_core.summarize(
            m.cluster_snapshot().get("merged", {}))
        names = ("kv_cache_pages", "kv_cache_hit_rate",
                 "serve_llm_batch_size", "serve_llm_tokens_total",
                 "serve_llm_shed_total")
        for name in names:
            entry = summary.get(name)
            if not entry:
                continue
            dump["metrics"][name] = entry["series"]
            parts = []
            for s in entry["series"]:
                tags = ",".join(f"{k}={v}"
                                for k, v in sorted(
                                    (s.get("tags") or {}).items()))
                val = s.get("value", 0.0)
                sval = f"{val:.3f}" if name == "kv_cache_hit_rate" \
                    else f"{val:g}"
                parts.append(f"{{{tags}}}={sval}" if tags else sval)
            print(f"  {name}: " + "  ".join(parts))
        if args.output:
            with open(args.output, "w") as f:
                json.dump(dump, f, indent=2, default=str)
            print(f"llm serving dump -> {args.output}")
    finally:
        ray_tpu_torch.shutdown()


def _fmt_ms(v) -> str:
    return f"{v * 1e3:.1f}ms" if v is not None else "-"


def cmd_serve_requests(args):
    """Request observatory: one cluster-wide serve trace scrape, merged
    by request id — per-deployment p50/p95/p99 + TTFT, per-replica phase
    profiles, slow-replica skew verdicts, and (with --slow) the slowest
    individual requests with their full phase breakdown."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli",
                 ignore_reinit_error=True)
    try:
        merged = state.serve_summary()
        if args.output:
            with open(args.output, "w") as f:
                json.dump(merged, f, indent=2, default=str)
            print(f"request observatory dump -> {args.output}")
        deps = merged.get("deployments") or []
        reps = merged.get("replicas") or []
        if args.deployment:
            deps = [d for d in deps if d["deployment"] == args.deployment]
            reps = [r for r in reps if r["deployment"] == args.deployment]
        if not deps:
            print("no serve requests traced (is a deployment receiving "
                  "traffic, and is reqtrace_enabled on?)")
        for d in deps:
            ttft = f" ttft p50={_fmt_ms(d['ttft_p50'])} " \
                   f"p99={_fmt_ms(d['ttft_p99'])}" \
                if d.get("ttft_p50") is not None else ""
            print(f"{d['app']}/{d['deployment']}: {d['count']} reqs  "
                  f"p50={_fmt_ms(d['p50'])} p95={_fmt_ms(d['p95'])} "
                  f"p99={_fmt_ms(d['p99'])}{ttft}")
            phases = d.get("phase_mean") or {}
            if phases:
                print("    phase means: " + "  ".join(
                    f"{ph}={_fmt_ms(v)}" for ph, v in phases.items()))
            if d.get("missing_replica_side"):
                print(f"    ! {d['missing_replica_side']} request(s) "
                      f"missing their replica-side spans")
        for r in reps[: args.top]:
            phases = "  ".join(f"{ph}={_fmt_ms(v)}"
                               for ph, v in (r.get("phase_mean") or {})
                               .items())
            print(f"  replica {r['replica']}: {r['count']} reqs  "
                  f"mean={_fmt_ms(r['mean_total'])} "
                  f"p95={_fmt_ms(r['p95'])}  {phases}")
        for v in merged.get("verdicts") or ():
            print(f"! {v['kind']} {v['app']}/{v['deployment']}: "
                  f"{v['detail']}")
        if args.slow:
            rows = merged.get("requests") or []
            if args.deployment:  # filter BEFORE the top-N slice
                rows = [r for r in rows
                        if r["deployment"] == args.deployment]
            rows = sorted(rows, key=lambda r: -r["total"])[: args.slow]
            print(f"slowest {len(rows)} requests:")
            for row in rows:
                phases = " ".join(
                    f"{p['phase']}={_fmt_ms(p['dur'])}"
                    for p in row["phases"])
                ttft = f" ttft={_fmt_ms(row['ttft'])}" \
                    if row.get("ttft") is not None else ""
                miss = f" MISSING={row['missing']}" if row.get("missing") \
                    else ""
                print(f"  {row['rid']} {row['app']}/{row['deployment']} "
                      f"replica={row['replica'] or '?'} "
                      f"total={_fmt_ms(row['total'])}{ttft}  "
                      f"{phases}{miss}")
        if merged.get("dropped"):
            print(f"({merged['dropped']} records dropped by full rings — "
                  f"raise reqtrace_ring_size for longer windows)")
        for err in merged.get("errors", ()):
            print(f"! unreachable: {err}", file=sys.stderr)
    finally:
        ray_tpu_torch.shutdown()


def cmd_serve_timeline(args):
    """Request observatory export: the merged per-request serve trace as
    Chrome-trace / Perfetto JSON, one process row per replica (plus the
    proxy side), each phase a slice stamped with its request id."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    ray_tpu_torch.init(address=_resolve_address(args), namespace="_cli",
                 ignore_reinit_error=True)
    try:
        path = args.output or \
            f"ray-tpu-torch-serve-timeline-{int(time.time())}.json"
        trace = state.request_timeline(path)
        merged_rows = sum(1 for ev in trace if ev.get("ph") == "X")
        print(f"wrote {len(trace)} trace events to {path} "
              f"({merged_rows} phase slices)")
    finally:
        ray_tpu_torch.shutdown()


def cmd_schedsim(args):
    """Deterministic scheduler simulator (schedsim.py): simulated
    1k-10k-node clusters driving the REAL placement-scoring code paths
    under a seeded virtual clock. No cluster needed — this is the
    reproducible A/B surface every scheduling-policy PR reports against."""
    from ray_tpu_torch._private import schedsim

    def one(policy: str) -> dict:
        spec = schedsim.SimSpec(
            nodes=args.nodes, policy=policy, seed=args.seed,
            gangs=args.gangs, gang_size=args.gang_size,
            strategy=args.strategy, chaos=args.chaos or "",
        )
        if args.trace:
            report, trace = schedsim.run_with_trace(spec)
            path = (args.trace if policy == args.policy
                    else f"{args.trace}.{policy}")
            with open(path, "w") as f:
                f.write(trace)
            report["trace_file"] = path
            return report
        return schedsim.run(spec)

    if args.ab:
        base = one("baseline")
        cont = one("contention")
        denom = base["total_contention"]
        out = {
            "baseline": base, "contention": cont,
            "contention_vs_baseline_overlap_ratio": (
                cont["total_contention"] / denom if denom else 0.0),
        }
    else:
        out = one(args.policy)
    print(json.dumps(out, indent=1))
    return 0


def cmd_microbenchmark(args):
    import ray_tpu_torch
    from ray_tpu_torch._private.perf import run_microbenchmarks

    addr = None
    try:
        addr = _resolve_address(args)
    except SystemExit:
        pass  # no running cluster: benchmark a fresh local one
    if addr:
        ray_tpu_torch.init(address=addr)
    else:
        ray_tpu_torch.init(num_cpus=4)
    try:
        run_microbenchmarks(select=args.select, small=args.small)
    finally:
        ray_tpu_torch.shutdown()
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch cluster CLI"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("start", help="start a head or worker node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", help="GCS address to join (worker mode)")
    p.add_argument("--num-cpus", type=float)
    p.add_argument("--num-gpus", type=float,
                   help="GPUs this node advertises (0: none, as on a "
                        "head that leaves its cards to launched nodes)")
    p.add_argument("--resources", help="JSON resource dict")
    p.add_argument("--session-dir")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop the local cluster")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser(
        "up", help="start (or reconcile) a cluster from a YAML config"
    )
    p.add_argument("config", help="cluster YAML (see autoscaler/commands.py)")
    p.add_argument("--no-monitor", action="store_true",
                   help="start the head only; skip the autoscaler monitor")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="tear down a YAML-launched cluster")
    p.add_argument("config")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("cluster-status",
                       help="status of a YAML-launched cluster")
    p.add_argument("config")
    p.set_defaults(fn=cmd_cluster_status)

    p = sub.add_parser("status", help="show cluster nodes + resources")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("submit", help="submit a job (shell entrypoint)")
    p.add_argument("--address")
    p.add_argument("--working-dir")
    p.add_argument("--submission-id")
    p.add_argument("--no-wait", action="store_true")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("entrypoint", nargs=argparse.REMAINDER,
                   help="command to run (prefix with --)")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("job", help="job inspection")
    jsub = p.add_subparsers(dest="job_command", required=True)
    jp = jsub.add_parser("list")
    jp.add_argument("--address")
    jp.set_defaults(fn=cmd_job_list)
    jp = jsub.add_parser("logs")
    jp.add_argument("submission_id")
    jp.add_argument("--address")
    jp.set_defaults(fn=cmd_job_logs)
    jp = jsub.add_parser("stop")
    jp.add_argument("submission_id")
    jp.add_argument("--address")
    jp.set_defaults(fn=cmd_job_stop)

    p = sub.add_parser("stack", help="dump worker thread stacks")
    p.add_argument("--address")
    p.add_argument("--node-id")
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser(
        "profile",
        help="on-demand cluster profiling: CPU flamegraphs / memory diffs",
    )
    p.add_argument("kind", choices=["cpu", "mem"])
    p.add_argument("--duration", type=float, default=5.0,
                   help="sampling window in seconds (default 5)")
    p.add_argument("--hz", type=float,
                   help="CPU sampling rate (default: profiler_default_hz)")
    p.add_argument("--node", help="node id (prefix ok): one node only")
    p.add_argument("--actor", help="actor id hex: that actor's worker only")
    p.add_argument("--task", help="filter merged stacks to this substring "
                                  "(task name / function / id)")
    p.add_argument("--include-gcs", action="store_true",
                   help="profile the GCS process too")
    p.add_argument("-o", "--output",
                   help="output path (default profile-cpu-<ts>."
                        "speedscope.json)")
    p.add_argument("--format", choices=["speedscope", "collapsed", "json"],
                   help="cpu output format (default by extension)")
    p.add_argument("--top", type=int, default=10,
                   help="stacks/sites to print (default 10)")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "metrics",
        help="merged cluster metrics scrape (Prometheus text / summary)",
    )
    p.add_argument("--summary", action="store_true",
                   help="human table with p50/p95/p99 instead of "
                        "Prometheus text")
    p.add_argument("-o", "--output", help="write Prometheus text here")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "memory",
        help="memory observatory: object lifecycle, arena occupancy, "
             "leak attribution",
    )
    p.add_argument("--group-by",
                   choices=["callsite", "node", "owner", "state"],
                   help="aggregate object rows (callsite groups a "
                        "driver-side leak by the line that made it)")
    p.add_argument("--leaks", action="store_true",
                   help="print every unreachable-yet-undeleted object "
                        "row (default: a one-line count)")
    p.add_argument("-o", "--output",
                   help="write the full merged JSON here (chaos triage "
                        "dumps use this)")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser(
        "logs",
        help="cluster log plane: listing, per-task/actor output, tails",
    )
    p.add_argument("target", nargs="?",
                   choices=["task", "actor", "worker", "gcs", "raylet"],
                   help="omit for the cluster log listing")
    p.add_argument("ident", nargs="?",
                   help="task/actor id hex, or an explicit filename for "
                        "worker|gcs|raylet")
    p.add_argument("--node", help="node id (prefix ok)")
    p.add_argument("--tail", type=int,
                   help="lines from the end (default 100 for file "
                        "targets; task output is never truncated "
                        "unless set)")
    p.add_argument("--follow", action="store_true",
                   help="keep polling the file as it grows (one file)")
    p.add_argument("--grep", help="only print lines matching this regex")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("events", help="show structured cluster events")
    p.add_argument("--address")
    p.add_argument("--severity", help="filter: DEBUG/INFO/WARNING/ERROR/FATAL")
    p.add_argument("--source", help="filter: gcs/raylet/user/...")
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser("timeline", help="dump chrome trace of task events")
    p.add_argument("--address")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser(
        "train",
        help="step observatory: per-step trainer/collective telemetry",
    )
    tsub = p.add_subparsers(dest="train_command", required=True)
    tp = tsub.add_parser(
        "timeline",
        help="merged multi-rank step timeline (Perfetto JSON) + per-rank "
             "straggler attribution",
    )
    tp.add_argument("-o", "--output",
                    help="output path (default ray-tpu-torch-train-timeline-"
                         "<ts>.json)")
    tp.add_argument("--top", type=int, default=10,
                    help="worst-skew collectives to print (default 10)")
    tp.add_argument("--address")
    tp.set_defaults(fn=cmd_train_timeline)

    p = sub.add_parser("list", help="list cluster state resources")
    p.add_argument("resource", choices=[
        "tasks", "actors", "nodes", "objects", "placement-groups", "jobs",
        "workers",
    ])
    p.add_argument("--filter", action="append",
                   help="key=value or key!=value (repeatable)")
    p.add_argument("--limit", type=int)
    p.add_argument("--address")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("summary", help="task summary by name")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser(
        "schedsim",
        help="deterministic scheduler simulator: policy A/B at simulated "
             "1k-10k-node scale (no cluster needed)",
    )
    p.add_argument("--nodes", type=int, default=1000,
                   help="simulated raylet count (default 1000)")
    p.add_argument("--policy", choices=["contention", "baseline"],
                   default="contention")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gangs", type=int, default=0,
                   help="gang arrivals (default nodes//40)")
    p.add_argument("--gang-size", type=int, default=8)
    p.add_argument("--strategy", default="STRICT_SPREAD",
                   choices=["PACK", "SPREAD", "STRICT_PACK",
                            "STRICT_SPREAD"])
    p.add_argument("--chaos",
                   help="faultsim rule syntax vs node ids (drop = node "
                        "death, delay = heartbeat stall of param ms)")
    p.add_argument("--trace", help="write the replayable event trace here")
    p.add_argument("--ab", action="store_true",
                   help="run BOTH policies and print the contention/"
                        "baseline overlap ratio")
    p.set_defaults(fn=cmd_schedsim)

    p = sub.add_parser(
        "microbenchmark",
        help="core-API throughput suite (ray parity: ray microbenchmark)",
    )
    p.add_argument("--select", default="", help="substring filter")
    p.add_argument("--small", action="store_true", help="CI-sized batches")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_microbenchmark)

    p = sub.add_parser(
        "serve",
        help="declarative Serve deploy/status + request observatory")
    ssub = p.add_subparsers(dest="serve_command", required=True)
    sp = ssub.add_parser("deploy")
    sp.add_argument("config", help="JSON config file (ServeDeploySchema)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_serve_deploy)
    sp = ssub.add_parser("status")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_serve_status)
    sp = ssub.add_parser(
        "llm",
        help="LLM serving observatory: per-replica sequence load + "
             "prefix-digest size, KV page-state gauges, hit rate, "
             "token/shed counters")
    sp.add_argument("-o", "--output",
                    help="write the full JSON dump here")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_serve_llm)
    sp = ssub.add_parser(
        "requests",
        help="request observatory: per-deployment latency breakdown, "
             "per-replica phase profiles, skew verdicts")
    sp.add_argument("--deployment", help="only this deployment")
    sp.add_argument("--slow", type=int, nargs="?", const=10, default=0,
                    metavar="N",
                    help="print the N slowest requests with full phase "
                         "breakdown (default 10)")
    sp.add_argument("--top", type=int, default=10,
                    help="per-replica rows to print (default 10)")
    sp.add_argument("-o", "--output",
                    help="write the full merged JSON here (chaos triage "
                         "dumps use this)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_serve_requests)
    sp = ssub.add_parser(
        "timeline",
        help="merged per-request serve timeline (Perfetto JSON), one "
             "track per replica")
    sp.add_argument("-o", "--output",
                    help="output path (default ray-tpu-torch-serve-timeline-"
                         "<ts>.json)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_serve_timeline)

    args = parser.parse_args(argv)
    if getattr(args, "entrypoint", None) and args.entrypoint[0] == "--":
        args.entrypoint = args.entrypoint[1:]
    args.fn(args)


if __name__ == "__main__":
    main()
