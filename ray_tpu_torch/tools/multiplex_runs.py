"""A multiplexed GPT-2 deployment shipped by ``runtime_env`` and redeployed
under load: the drive of ``chip_smoke.py``'s ``serve_multiplex_redeploy``
phase, shared with its CPU rehearsal in
``tests/test_torch_serve_multiplex.py`` so that both run one and the same
path.

``drive`` takes a cluster this process started (``ray_tpu_torch.init``)
with Serve's proxy up, and then:

1. writes the deployment's module (``SOURCE``) into two directories under
   ``root``, tagged ``v1`` and ``v2``. The module's class loads a
   ``GPT2LLM`` whose seed is the model id through
   ``@serve.multiplexed(max_num_models_per_replica=MAX_MODELS)``. This
   process never imports the module: the deployment names its class
   (``ShippedClass``), and the replica imports it from the working_dir
   that ``ray_actor_options["runtime_env"]`` ships;
2. deploys ``v1`` and sends the prompts over HTTP one after another, each
   to its model id, then reads the replica's probe: its loads in order,
   the models still resident, its forwards and its kernel launches;
3. starts a client thread that sends requests over HTTP without pause,
   then deploys ``v2`` under the same app name and route (a rolling
   update: the controller keeps ``v1`` serving until ``v2`` is up), and
   stops the client once ``v1``'s replica process is gone and
   ``TAIL_REQUESTS`` more answers came back.

It returns what it saw; ``problems`` holds it to its checks.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

APP = "mx"
ROUTE = "/mx"
MODULE = "multiplexed_gpt2"
CLASS = "MultiplexedGPT2"
MAX_MODELS = 2
# each version's replica leases half the card: a rolling update keeps the
# old replica serving until the new one is up, so both hold a lease at once
NUM_GPUS = 0.5
# the model id of each prompt in turn: with least-recently-used eviction at
# two models a replica this loads 0, 1, 2 and 1 again; 2 evicts 1 and the
# reload of 1 evicts 0
IDS = ("0", "1", "0", "2", "1")
LOADS = ["0", "1", "2", "1"]
RESIDENT = ["1", "2"]
# the rollout's requests: a resident model and one token each
ROLLOUT_ID = "1"
ROLLOUT_TOKENS = 1
# answers the client still takes once the old replica's process is gone
TAIL_REQUESTS = 10
HTTP_TIMEOUT_S = 120.0
OLD_REPLICA_GONE_S = 120.0

SOURCE = '''"""A GPT-2 deployment that serves several models a replica: the one
a request names is loaded by ``@serve.multiplexed`` with the model id as
its weights' seed. Written by ``ray_tpu_torch/tools/multiplex_runs.py``
into the working_dir a ``runtime_env`` ships; only the replica imports
it."""

import gc
import os
import weakref

import torch

from ray_tpu_torch import serve
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.serve.llm.model import GPT2LLM

TAG = {tag!r}


class {cls}:
    def __init__(self, model_kwargs, device=None):
        self.model_kwargs = dict(model_kwargs)
        self.device = device
        self.loads = []
        self.resident = weakref.WeakValueDictionary()
        self.forwards = 0

    @serve.multiplexed(max_num_models_per_replica={max_models})
    async def get_model(self, model_id: str):
        self.loads.append(model_id)
        model = GPT2LLM(device=self.device, seed=int(model_id),
                        **self.model_kwargs)
        self.resident[model_id] = model
        return model

    async def __call__(self, request):
        body = request.json()
        model = await self.get_model(str(body["model_id"]))
        tokens = list(body["tokens"])
        out = []
        before = model.forwards
        for _ in range(int(body["max_tokens"])):
            out.append(model.forward_next(tokens))
            tokens.append(out[-1])
        self.forwards += model.forwards - before
        return {{"tag": TAG, "model_id": body["model_id"], "tokens": out,
                "pid": os.getpid()}}

    def probe(self, reset=False):
        if reset:
            attn.zero_launches()
            self.forwards = 0
        gc.collect()
        dev = torch.device(self.device) if self.device else \\
            torch.device("cuda", torch.cuda.current_device())
        return {{"tag": TAG, "pid": os.getpid(), "cwd": os.getcwd(),
                "loads": list(self.loads),
                "resident": sorted(self.resident.keys()),
                "forwards": self.forwards,
                "launches": attn.read_launches(),
                "device": str(dev),
                "device_name": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else None}}
'''


def write_app(directory: str, tag: str) -> str:
    """Write the deployment's module, answering with ``tag``, into
    ``directory``; returns the directory."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"{MODULE}.py"), "w") as f:
        f.write(SOURCE.format(tag=tag, cls=CLASS, max_models=MAX_MODELS))
    return directory


def import_shipped(module: str, name: str):
    """The class ``name`` of ``module``, imported in this process."""
    return getattr(importlib.import_module(module), name)


class ShippedClass:
    """Stands for the class ``name`` of ``module`` in a deployment: it
    pickles as the pair of names, so that the process that unpickles it (a
    replica, whose working_dir holds the module) imports the class and the
    process that deploys it never does."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name
        self.__name__ = name

    def __reduce__(self):
        return import_shipped, (self.module, self.name)


def shipped_deployment(directory: str, model_kwargs: Dict[str, Any],
                       device: Optional[str] = None):
    """The application of the module written in ``directory``: its replica
    leases ``NUM_GPUS`` and gets the directory as its working_dir."""
    from ray_tpu_torch import serve

    return serve.deployment(ShippedClass(MODULE, CLASS), name=CLASS).options(
        ray_actor_options={"num_gpus": NUM_GPUS,
                           "runtime_env": {"working_dir": directory}},
    ).bind(model_kwargs=model_kwargs, device=device)


def post(port: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """POST ``payload`` to the proxy's ``ROUTE``: the status, the answer
    (JSON, else text) and host-clock stamps. A transport error raises."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{ROUTE}", method="POST",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        body = json.loads(raw)
    except ValueError:
        body = raw.decode(errors="replace")
    return {"status": status, "body": body, "sent": t0,
            "done": time.perf_counter()}


def reference_tokens(model_kwargs: Dict[str, Any], device, prompts,
                     ids: Sequence[str], max_tokens: int) -> List[List[int]]:
    """Each prompt's greedy tokens from a ``GPT2LLM`` of its model id's
    seed, built in this process."""
    from ray_tpu_torch.serve.llm.model import GPT2LLM

    models, out = {}, []
    for prompt, model_id in zip(prompts, ids):
        if model_id not in models:
            models[model_id] = GPT2LLM(device=device, seed=int(model_id),
                                       **model_kwargs)
        tokens, got = list(prompt), []
        for _ in range(max_tokens):
            got.append(models[model_id].forward_next(tokens))
            tokens.append(got[-1])
        out.append(got)
    del models
    gc.collect()
    return out


def _process_gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    try:  # a zombie has exited
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


class _Client(threading.Thread):
    """Sends ``payload`` over HTTP without pause until ``stop`` is set."""

    def __init__(self, port: int, payload: Dict[str, Any]):
        super().__init__(name="rollout-client", daemon=True)
        self.port, self.payload = port, payload
        self.answers: List[Dict[str, Any]] = []
        self.error: Optional[str] = None
        self.stop = threading.Event()

    def run(self):
        try:
            while not self.stop.is_set():
                self.answers.append(post(self.port, self.payload))
        except Exception as e:  # noqa: BLE001 — reported to the caller
            self.error = f"{type(e).__name__}: {e}"


def drive(root: str, port: int, prompts: Sequence[List[int]],
          model_kwargs: Dict[str, Any], max_tokens: int = 16,
          device: Optional[str] = None) -> Dict[str, Any]:
    """Steps 1-3 of the module's docstring; ``prompts`` go to ``IDS`` in
    order, ``max_tokens`` greedy tokens each."""
    from ray_tpu_torch import serve

    v1_dir = write_app(os.path.join(root, "v1"), "v1")
    v2_dir = write_app(os.path.join(root, "v2"), "v2")
    out: Dict[str, Any] = {"working_dirs": [v1_dir, v2_dir]}
    t0 = time.perf_counter()
    handle = serve.run(shipped_deployment(v1_dir, model_kwargs, device),
                       name=APP, route_prefix=ROUTE)
    out["v1_start_s"] = time.perf_counter() - t0
    probe = handle.options(method_name="probe")
    probe.remote(reset=True).result(timeout_s=60)
    answers = []
    t0 = time.perf_counter()
    for prompt, model_id in zip(prompts, IDS):
        answers.append(post(port, {"model_id": model_id, "tokens": prompt,
                                   "max_tokens": max_tokens}))
    out["answers_s"] = time.perf_counter() - t0
    out["answers"] = answers
    out["v1"] = probe.remote().result(timeout_s=60)

    client = _Client(port, {"model_id": ROLLOUT_ID, "tokens": prompts[0],
                            "max_tokens": ROLLOUT_TOKENS})
    client.start()
    # the rollout starts with the old version answering
    deadline = time.monotonic() + HTTP_TIMEOUT_S
    while not client.answers and client.is_alive() and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    t_run = time.perf_counter()
    try:
        handle = serve.run(shipped_deployment(v2_dir, model_kwargs, device),
                           name=APP, route_prefix=ROUTE)
        out["serve_run_s"] = time.perf_counter() - t_run
        deadline = time.monotonic() + OLD_REPLICA_GONE_S
        while not _process_gone(out["v1"]["pid"]) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        out["v1_gone_s"] = time.perf_counter() - t_run
        out["v1_gone"] = _process_gone(out["v1"]["pid"])
        seen = len(client.answers)
        while len(client.answers) < seen + TAIL_REQUESTS and \
                client.is_alive():
            time.sleep(0.01)
    finally:
        client.stop.set()
        client.join(timeout=HTTP_TIMEOUT_S)
    out["client_error"] = client.error
    rollout = [a for a in client.answers if a["sent"] >= t_run]
    out["rollout"] = [{"status": a["status"],
                       "tag": a["body"].get("tag")
                       if isinstance(a["body"], dict) else None,
                       "tokens": a["body"].get("tokens")
                       if isinstance(a["body"], dict) else a["body"],
                       "sent_s": a["sent"] - t_run,
                       "done_s": a["done"] - t_run}
                      for a in client.answers]
    out["rollout_requests"] = len(rollout)
    first_v2 = [a["done"] for a in client.answers
                if isinstance(a["body"], dict)
                and a["body"].get("tag") == "v2"]
    out["serve_run_to_first_v2_s"] = (min(first_v2) - t_run
                                      if first_v2 else None)
    out["v2"] = handle.options(method_name="probe").remote().result(
        timeout_s=60)
    out["module_in_this_process"] = (
        MODULE in sys.modules or importlib.util.find_spec(MODULE) is not None)
    return out


def problems(out: Dict[str, Any], expected: Sequence[List[int]],
             rollout_expected: List[int], n_layer: int,
             on_card: bool) -> List[str]:
    """What ``drive``'s result breaks: ``expected`` are the prompts' tokens
    from ``reference_tokens`` and ``rollout_expected`` the rollout
    request's; on the card each forward launches ``flash_fwd`` once a
    layer."""
    found = []
    answers = out["answers"]
    if [a["status"] for a in answers] != [200] * len(IDS):
        found.append(f"statuses {[a['status'] for a in answers]}")
    got = [a["body"].get("tokens") if isinstance(a["body"], dict) else None
           for a in answers]
    for i, (g, want) in enumerate(zip(got, expected)):
        if g != list(want):
            found.append(f"answer {i} (model {IDS[i]}) streamed {g}, not "
                         f"the in-process model's {list(want)}")
    tags = {a["body"].get("tag") for a in answers
            if isinstance(a["body"], dict)}
    if tags != {"v1"}:
        found.append(f"the v1 answers were tagged {sorted(map(str, tags))}")
    v1, v2 = out["v1"], out["v2"]
    if v1["loads"] != LOADS:
        found.append(f"the replica loaded {v1['loads']}, not {LOADS}")
    if v1["resident"] != RESIDENT:
        found.append(f"models {v1['resident']} resident, not {RESIDENT}")
    tokens = sum(len(w) for w in expected)
    if v1["forwards"] != tokens:
        found.append(f"{v1['forwards']} forwards for {tokens} tokens")
    launches = v1["launches"]
    want_fwd = n_layer * v1["forwards"] if on_card else 0
    if launches["flash_fwd"] != want_fwd or launches["flash_bwd_dq"] or \
            launches["flash_bwd_dkv"]:
        found.append(f"launches {launches} for {v1['forwards']} forwards of "
                     f"{n_layer} layers (flash_fwd {want_fwd} wanted)")
    if on_card and (not v1["device"].startswith("cuda")
                    or v1["device_name"] is None):
        found.append(f"the replica's models are on {v1['device']}")
    if out["module_in_this_process"]:
        found.append(f"this process can import {MODULE}: the class did not "
                     f"reach the replica through its working_dir only")
    if v1["cwd"] == v2["cwd"] or os.getcwd() in (v1["cwd"], v2["cwd"]):
        found.append(f"the replicas ran in {v1['cwd']} and {v2['cwd']}, not "
                     f"each in its own working_dir")
    rollout = out["rollout"]
    statuses = sorted({r["status"] for r in rollout})
    if out["client_error"] or statuses != [200]:
        found.append(f"rollout statuses {statuses}, client error "
                     f"{out['client_error']}")
    seq = [r["tag"] for r in rollout]
    switches = sum(a != b for a, b in zip(seq, seq[1:]))
    if not seq or seq[0] != "v1" or seq[-1] != "v2" or switches != 1:
        found.append(f"the rollout's tags went {tag_runs(seq)}, not v1 "
                     f"then v2 once")
    if any(r["tokens"] != rollout_expected for r in rollout):
        found.append("a rollout answer's tokens differ from the in-process "
                     "model's")
    if not out["v1_gone"]:
        found.append(f"v1's replica (pid {v1['pid']}) outlived the rollout")
    if v2["tag"] != "v2" or v2["pid"] == v1["pid"]:
        found.append(f"after the rollout the probe answers {v2['tag']} from "
                     f"pid {v2['pid']} (v1's {v1['pid']})")
    return found


def tag_runs(seq: Sequence[Any]) -> List[List[Any]]:
    """[[value, count], ...] of the runs in ``seq``."""
    runs: List[List[Any]] = []
    for x in seq:
        if runs and runs[-1][0] == x:
            runs[-1][1] += 1
        else:
            runs.append([x, 1])
    return runs
