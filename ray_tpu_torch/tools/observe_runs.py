"""A GPT-2 actor driven by a compiled DAG and observed through every
surface the runtime offers: the drive of ``chip_smoke.py``'s
``observe_dag_actor`` phase, shared with its CPU rehearsal in
``tests/test_torch_observe_gpt2.py`` so that both run one and the same
path.

``drive`` takes a cluster this process started (``ray_tpu_torch.init``)
and then:

1. creates one ``ObservedGPT2`` actor at ``num_gpus``: a ``GPT2LLM`` from
   seed 0 that decodes greedily, records a ``util.metrics`` Counter of the
   tokens it produced and a Histogram of each request's ms, and prints one
   line a request;
2. compiles ``actor.generate.bind(InputNode())`` with
   ``experimental_compile`` and times a one-token call three ways: through
   the compiled DAG, through the interpreted DAG's ``execute`` and as a
   direct actor call;
3. zeroes the actor's launch counts, then decodes the prompts through the
   compiled DAG, one after another, while ``util.profiling.profile_cpu``
   and ``profile_memory`` sample the whole cluster, and reads the counts;
4. decodes one prompt without a sampler and again inside a CPU profile;
5. makes one direct ``actor.generate.remote`` call under a driver span
   with ``tracing.enable()``;
6. reads the actor's log lines back by its id, and the traced call's by
   its task id (``util.state.get_log``), the dashboard's ``/metrics``
   scrape, its actor listing and its cluster resources.

It returns what it saw; ``problems`` holds it to its checks.
"""

from __future__ import annotations

import json
import re
import statistics
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

# each card actor of the slice leases half the card, as phases 34, 35 and
# 37 do, of a cluster that advertises one GPU
NUM_GPUS = 0.5
GPU_TOTAL = 1.0
# greedy tokens a prompt, as phase 6 decodes
MAX_TOKENS = 16
TOKENS_METRIC = "observed_gpt2_tokens_total"
REQUEST_MS_METRIC = "observed_gpt2_request_ms"
REQUEST_MS_BOUNDARIES = [1, 10, 100, 1000, 10000]
LOG_TAG = "observed-gpt2"
# the profile window is opened this long before the decode starts, so that
# every process's sampler runs when the first request arrives
PROFILE_LEAD_S = 0.5
PROFILE_S = 3.0
PROFILE_HZ = 200.0
ROUND_TRIPS = 5
DRIVER_SPAN = "observe-driver"
WAIT_S = 45.0
HTTP_TIMEOUT_S = 60.0
# the profiler labels a frame with its file's last two path components
MODEL_FRAME = "(models/"
ATTENTION_FRAME = "ops/attention.py"


class ObservedGPT2:
    """The observed actor: greedy GPT-2 decode, a metric of its tokens and
    its requests' ms, and a printed line per request."""

    def __init__(self, model_kwargs: Dict[str, Any],
                 device: Optional[str] = None):
        t0 = time.perf_counter()
        from ray_tpu_torch.serve.llm.model import GPT2LLM
        from ray_tpu_torch.util import metrics

        self.llm = GPT2LLM(device=device, seed=0, **model_kwargs)
        self.tokens = metrics.Counter(
            TOKENS_METRIC, "tokens the observed GPT-2 actor produced")
        self.request_ms = metrics.Histogram(
            REQUEST_MS_METRIC, "ms per request of the observed GPT-2 actor",
            boundaries=REQUEST_MS_BOUNDARIES)
        self.produced = 0
        self.printed: List[str] = []
        self.init_s = time.perf_counter() - t0

    def generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """``max_tokens`` greedy tokens after ``tokens``; the tokens and the
        request's ms on the actor's clock (``forward_next`` reads each
        token back to the host, so the ms include the card's work)."""
        t0 = time.perf_counter()
        tokens, out = list(request["tokens"]), []
        for _ in range(int(request["max_tokens"])):
            out.append(self.llm.forward_next(tokens))
            tokens.append(out[-1])
        ms = (time.perf_counter() - t0) * 1e3
        self.tokens.inc(len(out))
        self.request_ms.observe(ms)
        self.produced += len(out)
        line = (f"{LOG_TAG} request {len(self.printed) + 1}: "
                f"{len(request['tokens'])} prompt tokens, {len(out)} new")
        print(line, flush=True)
        self.printed.append(line)
        return {"tokens": out, "ms": ms}

    def probe(self, reset: bool = False) -> Dict[str, Any]:
        """The actor's own launch counts (counters are per process),
        forwards, tokens, printed lines, pid and device; ``reset=True``
        zeroes the launch counts and the forwards first."""
        import os

        import torch

        from ray_tpu_torch.ops import attention as attn

        if reset:
            attn.zero_launches()
            self.llm.forwards = 0
        dev = self.llm.device
        return {"pid": os.getpid(), "launches": attn.read_launches(),
                "forwards": self.llm.forwards, "produced": self.produced,
                "printed": list(self.printed), "init_s": self.init_s,
                "device": str(dev),
                "device_name": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else None}


def request(tokens: Sequence[int], max_tokens: int) -> Dict[str, Any]:
    return {"tokens": list(tokens), "max_tokens": max_tokens}


def _median_s(call, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


class _Window(threading.Thread):
    """One cluster profile (``profile_cpu`` or ``profile_memory``) on a
    thread, so that the driver decodes while it samples."""

    def __init__(self, fn, **kwargs):
        super().__init__(name="profile-window", daemon=True)
        self.fn, self.kwargs = fn, kwargs
        self.result = self.error = None

    def run(self):
        try:
            self.result = self.fn(**self.kwargs)
        except Exception as e:  # noqa: BLE001 — reported to the caller
            self.error = f"{type(e).__name__}: {e}"

    def join_result(self):
        self.join(timeout=self.kwargs["duration"] + 120)
        if self.error is not None or self.result is None:
            raise RuntimeError(f"the profile window failed: {self.error}")
        return self.result


def _open_windows(*windows):
    for w in windows:
        w.start()
    time.sleep(PROFILE_LEAD_S)


def _wait_for(fn, timeout: float = WAIT_S, interval: float = 0.3):
    """``fn()``'s first truthy value within ``timeout``, else its last."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            out = fn()
        except Exception:  # noqa: BLE001 — a probe that is not ready yet
            out = None
        if out or time.monotonic() >= deadline:
            return out
        time.sleep(interval)


def _http_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=HTTP_TIMEOUT_S) as r:
        return json.loads(r.read())


def _http_text(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=HTTP_TIMEOUT_S) as r:
        return r.read().decode()


def exposition_value(text: str, name: str,
                     labels: Optional[Dict[str, str]] = None
                     ) -> Optional[float]:
    """The value of the sample ``name{labels}`` in Prometheus text (every
    label given must match; a sample may carry more), else None."""
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? (\S+)$",
                     line)
        if not m or m.group(1) != name:
            continue
        have = dict(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"',
                               m.group(3) or ""))
        if all(have.get(k) == v for k, v in (labels or {}).items()):
            return float(m.group(4))
    return None


def _holds(resources: Dict[str, Any], num_gpus: float):
    """``resources`` (the dashboard's cluster resources) if the GPU held
    (total less available) is ``num_gpus``, else None."""
    held = resources["total"].get("GPU", 0.0) - \
        resources["available"].get("GPU", 0.0)
    return resources if abs(held - num_gpus) <= 1e-9 else None


def _profile_fields(cpu, mem, actor_hex: str, pid: int) -> Dict[str, Any]:
    mine = cpu.filter(actor_hex)
    return {
        "cpu_samples": cpu.samples,
        "cpu_processes": len(cpu.processes),
        "cpu_pids": sorted(p.get("pid") for p in cpu.processes
                           if p.get("pid") is not None),
        "cpu_errors": cpu.errors,
        "actor_samples": mine.samples,
        "actor_share": mine.samples / cpu.samples if cpu.samples else 0.0,
        "actor_model_stacks": sum(
            1 for s in mine.stacks if MODEL_FRAME in s),
        "attention_stacks": sum(
            1 for s in cpu.stacks if ATTENTION_FRAME in s),
        "actor_top_stack": mine.top(1)[0][0] if mine.stacks else None,
        "mem_processes": len(mem.processes),
        "mem_actor_sites": len(next(
            (p.get("sites") or [] for p in mem.processes
             if p.get("pid") == pid), [])),
        "mem_top_sites": [
            {k: s.get(k) for k in ("site", "size_diff_bytes", "count_diff")}
            for s in mem.top(3)],
    }


def drive(prompts: Sequence[List[int]], model_kwargs: Dict[str, Any],
          device: Optional[str] = None,
          num_gpus: float = NUM_GPUS) -> Dict[str, Any]:
    """Steps 1-6 of the module's docstring; ``prompts`` are decoded in
    order through the compiled DAG, ``MAX_TOKENS`` greedy tokens each, and
    the first is the one-prompt decode of step 4."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode, experimental_compile
    from ray_tpu_torch.dashboard.head import start_dashboard, stop_dashboard
    from ray_tpu_torch.util import profiling, state, tracing

    out: Dict[str, Any] = {"num_gpus": num_gpus}
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=num_gpus)(ObservedGPT2).remote(
        model_kwargs, device)
    first = rt.get(actor.probe.remote(), timeout=300)
    out["start_s"] = time.perf_counter() - t0
    out["init_s"] = first["init_s"]
    actor_hex = actor._actor_id.hex()
    out["actor_id"] = actor_hex
    node = actor.generate.bind(InputNode())
    compiled = experimental_compile(node)
    port = start_dashboard()
    try:
        one = request(prompts[0], 1)
        t0 = time.perf_counter()
        rt.get(compiled.execute(one), timeout=300)
        out["first_dag_call_s"] = time.perf_counter() - t0
        out["round_trip_s"] = {
            "compiled_dag": _median_s(
                lambda: rt.get(compiled.execute(one), timeout=60),
                ROUND_TRIPS),
            "dag_execute": _median_s(
                lambda: rt.get(node.execute(one), timeout=60), ROUND_TRIPS),
            "direct": _median_s(
                lambda: rt.get(actor.generate.remote(one), timeout=60),
                ROUND_TRIPS),
        }

        # 3. the checked decode, both profilers sampling the cluster
        rt.get(actor.probe.remote(reset=True), timeout=60)
        cpu = _Window(profiling.profile_cpu, duration=PROFILE_S,
                      hz=PROFILE_HZ)
        mem = _Window(profiling.profile_memory, duration=PROFILE_S)
        _open_windows(cpu, mem)
        t0 = time.perf_counter()
        answers = [rt.get(compiled.execute(request(p, MAX_TOKENS)),
                          timeout=300) for p in prompts]
        out["decode_s"] = time.perf_counter() - t0
        cpu, mem = cpu.join_result(), mem.join_result()
        out["answers"] = [a["tokens"] for a in answers]
        out["answer_ms"] = [a["ms"] for a in answers]
        probe = rt.get(actor.probe.remote(), timeout=60)
        out["probe"] = probe
        out["profile"] = _profile_fields(cpu, mem, actor_hex, probe["pid"])

        # 4. one prompt's decode rate without a sampler and inside one
        alone = rt.get(compiled.execute(request(prompts[0], MAX_TOKENS)),
                       timeout=300)
        window = _Window(profiling.profile_cpu,
                         duration=max(1.0, 2 * alone["ms"] / 1e3),
                         hz=PROFILE_HZ)
        _open_windows(window)
        sampled = rt.get(compiled.execute(request(prompts[0], MAX_TOKENS)),
                         timeout=300)
        window.join_result()
        out["tokens_per_s"] = {
            "no_sampler": MAX_TOKENS / (alone["ms"] / 1e3),
            "cpu_sampler": MAX_TOKENS / (sampled["ms"] / 1e3)}
        out["rate_tokens"] = [alone["tokens"], sampled["tokens"]]

        # 5. a direct call under a driver span
        tracing.enable()
        try:
            with tracing.span(DRIVER_SPAN) as root:
                traced_ref = actor.generate.remote(one)
                rt.get(traced_ref, timeout=60)
                trace_id = root["trace_id"]
            tracing.flush()
            spans = _wait_for(lambda: (lambda ss: ss if any(
                s["name"].startswith("task::") for s in ss) else None)(
                tracing.get_spans(trace_id))) or []
        finally:
            tracing.disable()
        out["spans"] = [{k: s.get(k) for k in (
            "name", "task_id", "parent_span_id", "trace_id", "pid")}
            for s in spans]
        out["trace_id"] = trace_id
        names = {s["name"] for s in spans}
        out["timeline_spans"] = sorted(
            e["name"] for e in rt.timeline()
            if e.get("cat") == "span" and e["name"] in names)

        # 6. logs, the scrape, the listing
        probe = rt.get(actor.probe.remote(), timeout=60)
        out["final"] = probe

        def attributed():
            lines = [line for line in state.get_log(actor_id=actor_hex,
                                                    tail=1000)
                     if LOG_TAG in line]
            return lines if lines == probe["printed"] else None

        out["actor_log"] = _wait_for(attributed) or [
            line for line in state.get_log(actor_id=actor_hex, tail=1000)
            if LOG_TAG in line]
        traced_tid = traced_ref.id().task_id().hex()
        out["traced_task_log"] = _wait_for(
            lambda: state.get_log(task_id=traced_tid)) or []
        text = _http_text(port, "/metrics")
        out["scrape"] = {
            "tokens": exposition_value(text, TOKENS_METRIC),
            "requests": exposition_value(text, REQUEST_MS_METRIC + "_count"),
            "gpu_total": exposition_value(
                text, "ray_tpu_resources_total", {"resource": "GPU"}),
        }
        rows = _http_json(port, "/api/v0/actors")
        out["listing"] = next(
            ({k: r.get(k) for k in ("actor_id", "state", "class_name",
                                    "node_id")}
             for r in rows if r.get("actor_id") == actor_hex), None)
        # a lease an earlier actor of the cluster held may still be on its
        # way back
        out["resources"] = _wait_for(lambda: _holds(_http_json(
            port, "/api/v0/cluster_resources"), num_gpus)) or _http_json(
                port, "/api/v0/cluster_resources")
    finally:
        stop_dashboard()
        compiled.teardown()
        rt.kill(actor)
    return out


def problems(out: Dict[str, Any], expected: Sequence[List[int]],
             n_layer: int, device_name: Optional[str] = None) -> List[str]:
    """What ``drive``'s result breaks: ``expected`` are the prompts'
    greedy tokens from a model of the same weights run elsewhere;
    ``device_name`` is the card's (``torch.cuda.get_device_name``) that the
    actor's model must be on, or None for the CPU. On the card each forward
    launches ``flash_fwd`` once a layer."""
    on_card = device_name is not None
    found = []
    expected = [list(e) for e in expected]
    for i, (got, want) in enumerate(zip(out["answers"], expected)):
        if got != want:
            found.append(f"the compiled DAG's answer {i} is {got}, not {want}")
    if len(out["answers"]) != len(expected):
        found.append(f"{len(out['answers'])} answers for {len(expected)} "
                     f"prompts")
    if any(t != expected[0] for t in out["rate_tokens"]):
        found.append("a rate decode's tokens differ from prompt 0's")
    probe = out["probe"]
    forwards = sum(len(e) for e in expected)
    if probe["forwards"] != forwards:
        found.append(f"{probe['forwards']} forwards for {forwards} tokens")
    launches = probe["launches"]
    want_fwd = n_layer * forwards if on_card else 0
    if launches["flash_fwd"] != want_fwd or launches["flash_bwd_dq"] or \
            launches["flash_bwd_dkv"]:
        found.append(f"launches {launches} for {forwards} forwards of "
                     f"{n_layer} layers (flash_fwd {want_fwd} wanted)")
    if probe["device"].startswith("cuda") != on_card or \
            probe["device_name"] != device_name:
        found.append(f"the actor's model is on {probe['device']} "
                     f"({probe['device_name']}), not {device_name or 'cpu'}")

    prof = out["profile"]
    if probe["pid"] not in prof["cpu_pids"]:
        found.append(f"the CPU profile holds no process of the actor (pid "
                     f"{probe['pid']}; pids {prof['cpu_pids']})")
    if not prof["actor_model_stacks"]:
        found.append(f"no stack carries actor:{out['actor_id']} and a frame "
                     f"of the models (top: {prof['actor_top_stack']})")
    if not prof["mem_actor_sites"]:
        found.append("the memory profile lists no site of the actor's "
                     "process")

    final = out["final"]
    scrape = out["scrape"]
    if scrape["tokens"] != final["produced"]:
        found.append(f"/metrics shows {scrape['tokens']} tokens, the actor "
                     f"produced {final['produced']}")
    if scrape["requests"] != len(final["printed"]):
        found.append(f"/metrics counts {scrape['requests']} requests, the "
                     f"actor answered {len(final['printed'])}")
    if scrape["gpu_total"] != GPU_TOTAL:
        found.append(f"ray_tpu_resources_total shows GPU "
                     f"{scrape['gpu_total']}, not {GPU_TOTAL}")

    if not final["printed"] or out["actor_log"] != final["printed"]:
        found.append(f"the actor's log by its id reads {out['actor_log']}, "
                     f"not the {len(final['printed'])} lines it printed")
    traced_line = final["printed"][-1] if final["printed"] else None
    if [line for line in out["traced_task_log"] if LOG_TAG in line] != \
            [traced_line]:
        found.append(f"the traced call's log by its task id reads "
                     f"{out['traced_task_log']}, not [{traced_line!r}]")

    by_name = {s["name"]: s for s in out["spans"]}
    root = by_name.get(DRIVER_SPAN)
    child = [s for s in out["spans"] if s["name"].startswith("task::")]
    if root is None or len(child) != 1:
        found.append(f"the trace holds spans {sorted(by_name)}, not the "
                     f"driver's and one of the actor's")
    else:
        if child[0]["parent_span_id"] != root["task_id"]:
            found.append(f"the actor's span has parent "
                         f"{child[0]['parent_span_id']}, not the driver's "
                         f"{root['task_id']}")
        if child[0]["pid"] != final["pid"]:
            found.append(f"the actor's span came from pid {child[0]['pid']}")
        if sorted(out["timeline_spans"]) != sorted([DRIVER_SPAN,
                                                    child[0]["name"]]):
            found.append(f"the timeline renders spans "
                         f"{out['timeline_spans']}")

    row = out["listing"]
    if row is None or row["state"] != "ALIVE" or \
            row["class_name"] != ObservedGPT2.__name__:
        found.append(f"the dashboard lists the actor as {row}")
    res = out["resources"]
    if res["total"].get("GPU") != GPU_TOTAL or \
            _holds(res, out["num_gpus"]) is None:
        found.append(f"the dashboard's resources show GPU {res}, not the "
                     f"actor's share {out['num_gpus']} of {GPU_TOTAL} held")
    return found
