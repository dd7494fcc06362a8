"""Public on-demand cluster profiling API.

ray parity: the dashboard's profiling endpoints (py-spy flamegraphs,
memray attach in dashboard/modules/reporter/profile_manager.py), surfaced
as driver-callable functions over the GCS fan-out
(``gcs.rpc_profile_cluster`` -> per-raylet ``profile_node`` -> per-worker
in-process samplers; see _private/profiler.py).

    import ray_tpu_torch
    from ray_tpu_torch.util import profiling

    prof = profiling.profile_cpu(duration=5)       # whole cluster
    prof.save("prof.speedscope.json")              # open in speedscope.app
    print(prof.filter(actor_id).collapsed())       # one actor's slice

    mem = profiling.profile_memory(duration=5)     # tracemalloc diffs
    for site in mem.top(10):
        print(site["size_diff_bytes"], site["site"])
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "CpuProfile",
    "MemProfile",
    "profile_cpu",
    "profile_memory",
    "profiler_overhead_bench",
]


def _cluster_request(payload: dict, timeout: float):
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    cw = global_worker.core_worker
    return cw.io.run(
        cw.gcs.request("profile_cluster", payload, timeout=timeout),
        timeout=timeout + 10.0,
    )


def _norm_id(value) -> Optional[str]:
    """Accept bytes / hex str / actor handles for id-shaped filters."""
    if value is None:
        return None
    if isinstance(value, bytes):
        return value.hex()
    aid = getattr(value, "_actor_id", None)
    if aid is not None:
        return aid.hex() if isinstance(aid, bytes) else str(aid)
    return str(value)


class CpuProfile:
    """Merged cluster CPU profile: collapsed stacks + per-process slices."""

    def __init__(self, raw: Dict[str, Any]):
        self.raw = raw

    @property
    def stacks(self) -> Dict[str, int]:
        return self.raw.get("stacks") or {}

    @property
    def samples(self) -> int:
        return self.raw.get("samples", 0)

    @property
    def processes(self) -> List[Dict[str, Any]]:
        return self.raw.get("processes") or []

    @property
    def errors(self) -> List[Dict[str, Any]]:
        return self.raw.get("errors") or []

    def filter(self, substr: str) -> "CpuProfile":
        """Slice to stacks containing ``substr`` (an actor id hex, a task
        name, a function name) — the per-task attribution cut."""
        substr = _norm_id(substr)
        out = dict(self.raw)
        out["stacks"] = {s: c for s, c in self.stacks.items()
                         if substr in s}
        out["samples"] = sum(out["stacks"].values())
        out["processes"] = [
            dict(p, stacks={s: c for s, c in (p.get("stacks") or {}).items()
                            if substr in s})
            for p in self.processes
        ]
        return CpuProfile(out)

    def top(self, n: int = 20) -> List[tuple]:
        return sorted(self.stacks.items(), key=lambda kv: -kv[1])[:n]

    def collapsed(self) -> str:
        from ray_tpu_torch._private.profiler import to_collapsed

        return to_collapsed(self.stacks)

    def speedscope(self, name: str = "ray_tpu_torch cpu profile") -> dict:
        from ray_tpu_torch._private.profiler import to_speedscope

        return to_speedscope(self.processes, name=name)

    def save(self, path: str, format: Optional[str] = None) -> str:
        """Write the profile. Format inferred from the extension when not
        given: ``.txt``/``.collapsed`` -> collapsed stacks, anything else
        -> speedscope JSON (open at https://www.speedscope.app)."""
        if format is None:
            format = "collapsed" if path.endswith((".txt", ".collapsed")) \
                else "speedscope"
        with open(path, "w") as f:
            if format == "collapsed":
                f.write(self.collapsed())
            elif format == "json":
                json.dump(self.raw, f, default=str)
            else:
                json.dump(self.speedscope(), f)
        return path

    def __repr__(self):
        return (f"CpuProfile(samples={self.samples}, "
                f"processes={len(self.processes)}, "
                f"unique_stacks={len(self.stacks)})")


class MemProfile:
    """Merged memory profile: top allocation sites with window deltas."""

    def __init__(self, raw: Dict[str, Any]):
        self.raw = raw

    @property
    def sites(self) -> List[Dict[str, Any]]:
        return self.raw.get("sites") or []

    @property
    def processes(self) -> List[Dict[str, Any]]:
        return self.raw.get("processes") or []

    def top(self, n: int = 10) -> List[Dict[str, Any]]:
        return self.sites[:n]

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.raw, f, default=str)
        return path

    def __repr__(self):
        return (f"MemProfile(sites={len(self.sites)}, "
                f"processes={len(self.processes)})")


def profile_cpu(duration: float = 5.0, hz: Optional[float] = None,
                node_id: Optional[str] = None,
                actor_id=None, include_gcs: bool = False,
                include_raylet: bool = True) -> CpuProfile:
    """Sample CPU stacks across the cluster for ``duration`` seconds.

    Every targeted process (workers + raylets, optionally the GCS) runs
    an in-process sampler at ``hz`` (default
    ``profiler_default_hz``, self-throttling to stay under
    ``profiler_max_overhead_fraction``); stacks sampled while a task or
    actor method runs carry ``task:<id>``/``actor:<id>`` frames for
    per-task attribution. ``node_id`` (prefix ok) or ``actor_id``
    restrict the fan-out."""
    raw = _cluster_request({
        "kind": "cpu", "duration": duration, "hz": hz,
        "node_id": node_id, "actor_id": _norm_id(actor_id),
        "include_gcs": include_gcs, "include_raylet": include_raylet,
    }, timeout=duration + 60.0)
    return CpuProfile(raw)


def profile_memory(duration: float = 5.0, top_n: Optional[int] = None,
                   node_id: Optional[str] = None, actor_id=None,
                   diff: bool = True,
                   include_gcs: bool = False) -> MemProfile:
    """tracemalloc window across the cluster: per-process top-N
    allocation sites, as deltas over the window (``diff=True``) or
    absolute totals."""
    raw = _cluster_request({
        "kind": "mem", "duration": duration, "top_n": top_n,
        "node_id": node_id, "actor_id": _norm_id(actor_id), "diff": diff,
        "include_gcs": include_gcs,
    }, timeout=duration + 60.0)
    return MemProfile(raw)


def profiler_overhead_bench(hz: float = 100.0, batch: int = 200,
                            window_s: float = 6.0,
                            repeat: int = 4) -> Dict[str, Any]:
    """Measure sampling overhead at ``hz`` two ways:

    - ``sampling_cpu_fraction``: the samplers' SELF-MEASURED cpu share
      (time inside ``_sample`` / wall time), max across processes — the
      quantity ``profiler_max_overhead_fraction`` throttles against and
      the robust <5%-at-100Hz number.
    - ``overhead_fraction``: end-to-end task-throughput delta, with the
      baseline PAIRED around the profiled window ((before+after)/2):
      small boxes ramp throughput 1.5-2x as pools/leases warm, so an
      unpaired before-only baseline measures the ramp, not the sampler.
    """
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _nop():
        return b"ok"

    def measure() -> float:
        best = 0.0
        for _ in range(repeat):
            t0 = time.perf_counter()
            ray_tpu_torch.get([_nop.remote() for _ in range(batch)])
            best = max(best, batch / (time.perf_counter() - t0))
        return best

    for _ in range(3):
        measure()  # warm pool/leases past the ramp
    before = measure()
    box: Dict[str, Any] = {}

    def run_profile():
        try:
            box["profile"] = profile_cpu(duration=window_s, hz=hz)
        except Exception as e:  # noqa: BLE001 — bench must still report
            box["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=run_profile, daemon=True)
    t.start()
    time.sleep(0.5)  # let every process's sampler start
    sampled = measure()
    t.join(timeout=window_s + 60)
    after = measure()
    baseline = (before + after) / 2.0
    overhead = max(0.0, 1.0 - sampled / baseline) if baseline else 0.0
    prof = box.get("profile")
    self_cpu = max(
        (p.get("overhead_fraction", 0.0) for p in prof.processes),
        default=0.0,
    ) if prof is not None else 0.0
    return {
        "hz": hz,
        "baseline_tasks_per_s": round(baseline, 1),
        "baseline_before": round(before, 1),
        "baseline_after": round(after, 1),
        "sampled_tasks_per_s": round(sampled, 1),
        "overhead_fraction": round(overhead, 4),
        "sampling_cpu_fraction": round(self_cpu, 4),
        "profile_samples": prof.samples if prof is not None else 0,
        "profile_processes": len(prof.processes) if prof is not None else 0,
        "profile_error": box.get("error"),
    }
