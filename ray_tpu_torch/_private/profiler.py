"""On-demand sampling profilers: CPU flamegraphs + memory diffs.

Dependency-free analog of the reference's dashboard profiling
(ray: dashboard/modules/reporter/profile_manager.py, which shells out to
py-spy/memray against a live pid). Here every process carries its own
profiler and exposes it over the existing RPC plane instead:

- ``CpuSampler``: a background thread walking ``sys._current_frames()``
  at a configurable rate, accumulating collapsed stacks. It self-measures
  its own per-sample cost and auto-throttles when sampling would exceed a
  target overhead fraction, so attaching to a loaded worker stays safe.
- ``MemProfiler``: tracemalloc start/snapshot/diff — top-N allocation
  sites with size/count deltas against the start-of-window baseline.
- ``ProfilerService``: one per process (gcs/raylet/worker/driver), the
  object RPC handlers delegate to (start/stop/status/run verbs).

Per-task attribution: executors tag their user-code threads via
``tag_current_thread`` with the currently-executing task/actor id; the
sampler prepends synthetic ``actor:<id>``/``task:<name>`` frames to that
thread's stacks, so a merged cluster flamegraph slices per task/actor.

Export: collapsed-stack text (flamegraph.pl / speedscope paste) and
speedscope JSON (one sampled profile per process, shared frame table).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# per-thread task attribution (written by executors, read by the sampler)
# ---------------------------------------------------------------------------
# thread ident -> ("actor"|"task", id_hex, name). Plain dict ops are atomic
# under the GIL; the sampler tolerates torn reads (a sample attributed one
# task late is noise, not corruption).
_THREAD_TAGS: Dict[int, Tuple[str, str, str]] = {}


class tag_current_thread:
    """Context manager: attribute samples of the calling thread to a task
    or actor while user code runs. ~2 dict ops of overhead per task."""

    __slots__ = ("_tag", "_ident", "_prev")

    def __init__(self, name: str, task_id: Optional[str] = None,
                 actor_id: Optional[str] = None):
        if actor_id:
            self._tag = ("actor", actor_id, name)
        else:
            self._tag = ("task", task_id or "", name)

    @classmethod
    def for_spec(cls, spec) -> "tag_current_thread":
        if spec.actor_id is not None:
            return cls(spec.method_name or spec.name,
                       actor_id=spec.actor_id.hex())
        return cls(spec.name, task_id=spec.task_id.hex()[:16])

    def __enter__(self):
        self._ident = threading.get_ident()
        self._prev = _THREAD_TAGS.get(self._ident)
        _THREAD_TAGS[self._ident] = self._tag
        return self

    def __exit__(self, *exc):
        if self._prev is None:
            _THREAD_TAGS.pop(self._ident, None)
        else:
            _THREAD_TAGS[self._ident] = self._prev


def current_thread_tag() -> Optional[Tuple[str, str, str]]:
    return _THREAD_TAGS.get(threading.get_ident())


# ---------------------------------------------------------------------------
# CPU sampling profiler
# ---------------------------------------------------------------------------
_MAX_STACK_DEPTH = 64
_MAX_UNIQUE_STACKS = 20_000
_OVERFLOW_KEY = "<stack-table-overflow>"


def _frame_label(frame) -> str:
    code = frame.f_code
    fname = code.co_filename
    # last two path components keep labels readable AND distinct across
    # same-named files (worker.py exists in several packages)
    parts = fname.replace("\\", "/").rsplit("/", 2)
    short = "/".join(parts[-2:]) if len(parts) > 1 else fname
    return f"{code.co_name} ({short}:{frame.f_lineno})"


class CpuSampler:
    """Sampling wall-clock profiler for THIS process, all threads.

    ``stacks`` maps a ``;``-joined root-first frame list to its sample
    count (the collapsed-stack convention). Synthetic root frames:
    ``thread:<name>`` always, then ``actor:<id>``/``task:<name>`` when the
    sampled thread is tagged by an executor.
    """

    def __init__(self, hz: float = 100.0,
                 max_overhead_fraction: float = 0.05,
                 max_duration_s: float = 600.0):
        self.hz = max(0.1, float(hz))
        self.max_overhead = max(1e-9, float(max_overhead_fraction))
        self.max_duration_s = max_duration_s
        self.interval = 1.0 / self.hz
        # keyed by TUPLE of frame labels while sampling (hashing a tuple
        # of interned strings is far cheaper than building a joined
        # string per sample); collect() renders the ';' form
        self.stacks: Dict[tuple, int] = {}
        self.samples = 0
        self.throttled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at = 0.0
        self._ended_at = 0.0
        self._sample_cost_s = 0.0  # cumulative time spent inside _sample
        self._lock = threading.Lock()
        # (id(code) -> (code, {lineno: label})): formatting a frame label
        # costs ~1us; hot stacks repeat, so cache by code identity (the
        # code object is PINNED in the value, so the id cannot be reused)
        self._label_cache: Dict[int, tuple] = {}
        self._thread_names: Dict[int, str] = {}
        self._names_refreshed = 0.0

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stop.is_set()

    def start(self):
        if self.running:
            raise RuntimeError("cpu sampler already running")
        self._stop.clear()
        self._started_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="cpu-sampler", daemon=True
        )
        self._thread.start()

    def _run(self):
        own = threading.get_ident()
        deadline = self._started_at + self.max_duration_s
        # rolling per-sample cost for the throttle decision (EWMA so one
        # slow GC-paused sample doesn't throttle the whole session)
        avg_cost = 0.0
        while not self._stop.is_set():
            t0 = time.monotonic()
            if t0 > deadline:
                break  # leak-proof: a lost stop() can't sample forever
            try:
                self._sample(own)
            except Exception:
                pass  # a torn frame walk must never kill the sampler
            cost = time.monotonic() - t0
            self._sample_cost_s += cost
            avg_cost = cost if avg_cost == 0.0 else \
                0.8 * avg_cost + 0.2 * cost
            # self-throttle: keep (time sampling / wall time) under the
            # overhead budget by growing the interval when samples are
            # expensive (many threads, deep stacks)
            if avg_cost > self.max_overhead * self.interval:
                self.interval = min(avg_cost / self.max_overhead, 1.0)
                self.throttled = True
            self._stop.wait(max(self.interval - cost, 0.001))
        self._ended_at = time.monotonic()

    def _cached_label(self, frame) -> str:
        code = frame.f_code
        lineno = frame.f_lineno
        entry = self._label_cache.get(id(code))
        if entry is None or entry[0] is not code:
            if len(self._label_cache) > 8192:
                self._label_cache.clear()
            entry = self._label_cache[id(code)] = (code, {})
        label = entry[1].get(lineno)
        if label is None:
            label = entry[1][lineno] = _frame_label(frame)
        return label

    def _thread_name(self, ident: int, now: float) -> str:
        # threading.enumerate() per sample is a measurable cost; names
        # change ~never, so refresh the cache lazily
        name = self._thread_names.get(ident)
        if name is None or now - self._names_refreshed > 2.0:
            self._thread_names = {
                t.ident: f"thread:{t.name}" for t in threading.enumerate()
            }
            self._names_refreshed = now
            name = self._thread_names.get(ident, f"thread:{ident}")
        return name

    def _sample(self, own_ident: int):
        now = time.monotonic()
        frames = sys._current_frames()
        cached = self._cached_label
        with self._lock:
            self.samples += 1
            for ident, frame in frames.items():
                if ident == own_ident:
                    continue
                stack: List[str] = [self._thread_name(ident, now)]
                tag = _THREAD_TAGS.get(ident)
                if tag is not None:
                    kind, id_hex, name = tag
                    stack.append(f"{kind}:{id_hex}")
                    stack.append(f"{'method' if kind == 'actor' else 'fn'}"
                                 f":{name}")
                prefix_len = len(stack)
                depth = 0
                f = frame
                while f is not None and depth < _MAX_STACK_DEPTH:
                    stack.append(cached(f))
                    f = f.f_back
                    depth += 1
                # root first past the synthetic prefix (collapsed form)
                stack[prefix_len:] = stack[:prefix_len - 1:-1]
                key = tuple(stack)
                n = self.stacks.get(key)
                if n is None and len(self.stacks) >= _MAX_UNIQUE_STACKS:
                    key = (_OVERFLOW_KEY,)
                    n = self.stacks.get(key)
                self.stacks[key] = (n or 0) + 1

    def collect(self, reset: bool = False) -> Dict[str, Any]:
        """Snapshot without stopping (collapsed string form)."""
        with self._lock:
            stacks = {";".join(k): n for k, n in self.stacks.items()}
            samples = self.samples
            if reset:
                self.stacks = {}
                self.samples = 0
        end = self._ended_at or time.monotonic()
        elapsed = max(end - self._started_at, 1e-9)
        return {
            "kind": "cpu",
            "pid": os.getpid(),
            "duration_s": round(elapsed, 4),
            "samples": samples,
            "effective_hz": round(samples / elapsed, 2),
            "requested_hz": self.hz,
            "overhead_fraction": round(self._sample_cost_s / elapsed, 6),
            "throttled": self.throttled,
            "stacks": stacks,
        }

    def stop(self) -> Dict[str, Any]:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        return self.collect()


# ---------------------------------------------------------------------------
# memory profiler (tracemalloc)
# ---------------------------------------------------------------------------
class MemProfiler:
    """tracemalloc session: start -> (snapshot|diff) -> stop.

    ``collect(diff=True)`` reports the top-N allocation sites by net
    growth since ``start()`` — the "what leaked during this window" view;
    ``diff=False`` reports absolute top sites."""

    def __init__(self, n_frames: int = 8):
        self.n_frames = max(1, int(n_frames))
        self._baseline = None
        self._we_started = False
        self._started_at = 0.0

    @property
    def running(self) -> bool:
        return self._baseline is not None

    def start(self):
        import tracemalloc

        if self.running:
            raise RuntimeError("memory profiler already running")
        if not tracemalloc.is_tracing():
            tracemalloc.start(self.n_frames)
            self._we_started = True
        self._started_at = time.monotonic()
        self._baseline = tracemalloc.take_snapshot()

    @staticmethod
    def _site(tb) -> str:
        # leaf-last "file:lineno <- caller:lineno" chain, shortened paths
        frames = []
        for fr in list(tb)[:4]:
            fname = fr.filename.replace("\\", "/").rsplit("/", 2)
            frames.append(f"{'/'.join(fname[-2:])}:{fr.lineno}")
        return " <- ".join(frames)

    def collect(self, top_n: int = 30, diff: bool = True) -> Dict[str, Any]:
        import tracemalloc

        if not self.running:
            raise RuntimeError("memory profiler not running")
        snap = tracemalloc.take_snapshot()
        filters = [tracemalloc.Filter(False, tracemalloc.__file__),
                   tracemalloc.Filter(False, "<frozen importlib._bootstrap>")]
        snap = snap.filter_traces(filters)
        sites = []
        if diff:
            base = self._baseline.filter_traces(filters)
            stats = snap.compare_to(base, "traceback")
            stats.sort(key=lambda s: abs(s.size_diff), reverse=True)
            for s in stats[:top_n]:
                sites.append({
                    "site": self._site(s.traceback),
                    "size_bytes": s.size, "count": s.count,
                    "size_diff_bytes": s.size_diff,
                    "count_diff": s.count_diff,
                })
        else:
            for s in snap.statistics("traceback")[:top_n]:
                sites.append({
                    "site": self._site(s.traceback),
                    "size_bytes": s.size, "count": s.count,
                })
        current, peak = tracemalloc.get_traced_memory()
        return {
            "kind": "mem",
            "pid": os.getpid(),
            "duration_s": round(time.monotonic() - self._started_at, 4),
            "diff": diff,
            "traced_current_bytes": current,
            "traced_peak_bytes": peak,
            "sites": sites,
        }

    def stop(self, top_n: int = 30, diff: bool = True) -> Dict[str, Any]:
        import tracemalloc

        out = self.collect(top_n=top_n, diff=diff)
        self._baseline = None
        if self._we_started and tracemalloc.is_tracing():
            tracemalloc.stop()
        self._we_started = False
        return out


# ---------------------------------------------------------------------------
# per-process service (RPC handlers delegate here)
# ---------------------------------------------------------------------------
class ProfilerService:
    """One per process; owns at most one live profiler of each kind."""

    def __init__(self, role: str):
        self.role = role
        self._cpu: Optional[CpuSampler] = None
        self._mem: Optional[MemProfiler] = None
        self._lock = threading.Lock()

    def _cfg(self):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG

    def start(self, p: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self._cfg()
        kind = p.get("kind", "cpu")
        with self._lock:
            if kind == "cpu":
                if self._cpu is not None and self._cpu.running:
                    return {"error": "cpu profiler already running"}
                hz = min(float(p.get("hz") or cfg.profiler_default_hz),
                         cfg.profiler_max_hz)
                self._cpu = CpuSampler(
                    hz=hz,
                    max_overhead_fraction=float(
                        p.get("max_overhead")
                        or cfg.profiler_max_overhead_fraction),
                    max_duration_s=cfg.profiler_max_duration_s,
                )
                self._cpu.start()
            elif kind == "mem":
                if self._mem is not None and self._mem.running:
                    return {"error": "memory profiler already running"}
                self._mem = MemProfiler(
                    n_frames=int(p.get("n_frames")
                                 or cfg.profiler_mem_frames))
                self._mem.start()
            else:
                return {"error": f"unknown profiler kind {kind!r}"}
        return {"ok": True, "kind": kind}

    def stop(self, p: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self._cfg()
        kind = p.get("kind", "cpu")
        with self._lock:
            if kind == "cpu":
                if self._cpu is None:
                    return {"error": "cpu profiler not running"}
                prof, self._cpu = self._cpu, None
                out = prof.stop()
            elif kind == "mem":
                if self._mem is None:
                    return {"error": "memory profiler not running"}
                prof, self._mem = self._mem, None
                out = prof.stop(
                    top_n=int(p.get("top_n") or cfg.profiler_mem_top_n),
                    diff=bool(p.get("diff", True)),
                )
            else:
                return {"error": f"unknown profiler kind {kind!r}"}
        out["role"] = self.role
        return out

    def status(self) -> Dict[str, Any]:
        return {
            "role": self.role,
            "pid": os.getpid(),
            "cpu_running": self._cpu is not None and self._cpu.running,
            "mem_running": self._mem is not None and self._mem.running,
        }

    async def run(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """start -> sleep(duration) -> stop, as one awaited operation (the
        shape the fan-out layers use: no cross-request session state to
        lose when a connection drops mid-window)."""
        import asyncio

        cfg = self._cfg()
        duration = min(float(p.get("duration") or 5.0),
                       cfg.profiler_max_duration_s)
        started = self.start(p)
        if started.get("error"):
            return started
        try:
            await asyncio.sleep(duration)
        finally:
            out = self.stop(p)
        return out


# ---------------------------------------------------------------------------
# merge + export
# ---------------------------------------------------------------------------
def merge_profiles(processes: List[Dict[str, Any]],
                   kind: str = "cpu") -> Dict[str, Any]:
    """Fold per-process results into one cluster view: summed collapsed
    stacks for cpu, summed per-site deltas for mem. Per-process results
    ride along (they carry node/pid/actor identity for slicing)."""
    procs = [p for p in processes if p and not p.get("error")]
    errors = [p for p in processes if p and p.get("error")]
    out: Dict[str, Any] = {"kind": kind, "processes": procs,
                           "errors": errors}
    if kind == "cpu":
        merged: Dict[str, int] = {}
        total = 0
        for p in procs:
            total += p.get("samples", 0)
            for stack, n in (p.get("stacks") or {}).items():
                merged[stack] = merged.get(stack, 0) + n
        out["stacks"] = merged
        out["samples"] = total
    else:
        by_site: Dict[str, Dict[str, Any]] = {}
        for p in procs:
            for s in p.get("sites") or ():
                e = by_site.setdefault(s["site"], {
                    "site": s["site"], "size_bytes": 0, "count": 0,
                    "size_diff_bytes": 0, "count_diff": 0,
                })
                e["size_bytes"] += s.get("size_bytes", 0)
                e["count"] += s.get("count", 0)
                e["size_diff_bytes"] += s.get("size_diff_bytes", 0)
                e["count_diff"] += s.get("count_diff", 0)
        out["sites"] = sorted(by_site.values(),
                              key=lambda e: abs(e["size_diff_bytes"])
                              or e["size_bytes"], reverse=True)
    return out


def to_collapsed(stacks: Dict[str, int]) -> str:
    """flamegraph.pl / speedscope-paste format: one 'stack count' line."""
    lines = [f"{stack} {count}"
             for stack, count in sorted(stacks.items(),
                                        key=lambda kv: -kv[1])]
    return "\n".join(lines) + ("\n" if lines else "")


def to_speedscope(processes: List[Dict[str, Any]],
                  name: str = "ray_tpu_torch cpu profile") -> Dict[str, Any]:
    """Speedscope file (https://www.speedscope.app/file-format-schema.json):
    one 'sampled' profile per process over a shared frame table, so a
    cluster-wide capture opens as switchable per-process flamegraphs."""
    frame_index: Dict[str, int] = {}
    frames: List[Dict[str, str]] = []

    def fidx(label: str) -> int:
        i = frame_index.get(label)
        if i is None:
            i = frame_index[label] = len(frames)
            frames.append({"name": label})
        return i

    profiles = []
    for p in processes:
        stacks = p.get("stacks") or {}
        samples, weights = [], []
        for stack, count in stacks.items():
            samples.append([fidx(lbl) for lbl in stack.split(";")])
            weights.append(count)
        label = ":".join(str(x) for x in (
            p.get("role", "proc"), p.get("node_id", "")[:8] or None,
            p.get("pid")) if x)
        profiles.append({
            "type": "sampled",
            "name": label,
            "unit": "none",
            "startValue": 0,
            "endValue": sum(weights) or 1,
            "samples": samples,
            "weights": weights,
        })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": profiles or [{
            "type": "sampled", "name": "empty", "unit": "none",
            "startValue": 0, "endValue": 1, "samples": [], "weights": [],
        }],
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "ray_tpu_torch",
    }
