"""The workflow and queue runs of ``chip_smoke.py`` phase 35, shared with the
CPU tests so that both drive one and the same path.

``drive`` starts a cluster in this process and runs two user paths on it.

1. A durable train-then-serve workflow,
   ``serve_step.bind(train_step.bind(config, storage),
   wait_for_event(FileListener, event_path))``, both steps leasing
   ``config["num_gpus"]`` GPUs. Its first run is a driver subprocess
   (``python -m ray_tpu_torch.tools.workflow_runs driver CONFIG_JSON``).
   Once the train step's checkpoint is in storage and the event step is
   still waiting, ``drive`` SIGKILLs that driver, reads the run's status,
   creates the event's file and resumes the run from its own process: the
   train step loads from its checkpoint and the serve step runs.
2. A queue feeding the card: ``util.multiprocessing.Pool(2)`` builds the
   prompts from their seed on CPU workers, the driver puts them into a
   ``util.queue.Queue(maxsize=2)`` and a consumer actor that leases the GPU
   answers each through ``GPT2LLM`` onto a second queue. The consumer is
   created before the workflow, so that its start runs under it: its lease
   and a step's (``config["num_gpus"]`` each) share the cluster's GPUs.

``train_step`` trains GPT-2 from seed 0 (or from ``config["init"]``, a
state dict) on one fixed batch from seed 1, saves the weights with
``torch.save`` under the storage and returns their path, the losses and its
kernel launch counts. ``serve_step`` loads those weights and answers the
prompts with 16 greedy tokens each. ``drive`` returns what it saw, with the
seconds of each step; ``problems`` holds it to the checks both callers
share, and the caller holds the numbers to its reference.
"""

from __future__ import annotations

import functools
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List

from ray_tpu_torch import workflow

WORKFLOW_ID = "train_then_serve"
CALLS = "calls.txt"
PROMPT_SEED = 2
# how long the drive waits for the first run's train checkpoint, and the
# consumer for each prompt
CHECKPOINT_WAIT_S = 600.0
PROMPT_WAIT_S = 120.0


def _device(config):
    import torch

    return torch.device(config["device"])


def _where(config) -> Dict[str, Any]:
    import torch

    device = _device(config)
    return {"pid": os.getpid(), "device": str(device),
            "device_name": torch.cuda.get_device_name(device)
            if device.type == "cuda" else None}


def prompt(i: int, lens, vocab: int) -> List[int]:
    """The ``i``-th prompt: numpy seed 2 draws one prompt of each length of
    ``lens`` in turn (phase 6's prompts at GPT-2's width)."""
    import numpy as np

    rng = np.random.default_rng(PROMPT_SEED)
    for n in lens[:i + 1]:
        out = rng.integers(0, vocab, size=n).tolist()
    return out


def load_llm(config, weights=None):
    """``GPT2LLM`` at ``config["serve_model"]``: seed 0's weights, or the
    state dict at ``weights``."""
    import torch

    from ray_tpu_torch.serve.llm.model import GPT2LLM

    kwargs = dict(config["serve_model"],
                  dtype=getattr(torch, config["serve_model"]["dtype"]))
    llm = GPT2LLM(device=_device(config), **kwargs)
    if weights is not None:
        llm.model.load_state_dict(torch.load(weights,
                                             map_location=llm.device))
    return llm


def greedy(llm, tokens: List[int], n: int) -> List[int]:
    """``n`` greedy tokens, one full forward each (the engine's path)."""
    seq, out = list(tokens), []
    for _ in range(n):
        out.append(llm.forward_next(seq))
        seq.append(out[-1])
    return out


# ---------------------------------------------------------------------------
# the workflow's steps
# ---------------------------------------------------------------------------

def _log_call(storage: str, name: str):
    with open(os.path.join(storage, CALLS), "a") as f:
        f.write(f"{name} {os.getpid()}\n")


def train_step(config, storage: str) -> Dict[str, Any]:
    """``config["steps"]`` AdamW steps of GPT-2 from seed 0 (or the state
    dict at ``config["init"]``) on one batch from seed 1; saves the weights
    under ``storage``."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as attn

    t0 = time.perf_counter()
    _log_call(storage, "train_step")
    device = _device(config)
    m = dict(config["train_model"])
    cfg = getattr(gpt2.GPT2Config, m.pop("preset"))(
        dtype=getattr(torch, m.pop("dtype")), **m)
    model, opt = gpt2.make_train_state(cfg, torch.Generator().manual_seed(0),
                                       device=device)
    if config.get("init"):
        model.load_state_dict(torch.load(config["init"],
                                         map_location=device))
    step = gpt2.build_train_step(model, opt)
    batch = gpt2.synthetic_batch(1, config["batch"], config["seq"],
                                 cfg.vocab_size, device=device)
    attn.zero_launches()
    losses = []
    for _ in range(config["steps"]):
        model, opt, loss = step(model, opt, batch)
        losses.append(loss)
    losses = [float(x) for x in losses]
    launches = attn.read_launches()
    path = os.path.join(storage, "weights.pt")
    torch.save(model.state_dict(), path + ".tmp")
    os.replace(path + ".tmp", path)
    del model, opt, step, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(_where(config), weights=path, losses=losses,
                launches=launches, seconds=time.perf_counter() - t0)


def serve_step(trained: Dict[str, Any], event: str, config
               ) -> Dict[str, Any]:
    """The trained weights on the device, ``config["new_tokens"]`` greedy
    tokens for each prompt, once ``event`` (the event step's file) is
    there."""
    from ray_tpu_torch.ops import attention as attn

    t0 = time.perf_counter()
    _log_call(os.path.dirname(trained["weights"]), "serve_step")
    llm = load_llm(config, trained["weights"])
    lens, vocab = config["prompt_lens"], config["serve_model"]["vocab_size"]
    attn.zero_launches()
    tokens = [greedy(llm, prompt(i, lens, vocab), config["new_tokens"])
              for i in range(len(lens))]
    return dict(_where(config), tokens=tokens, launches=attn.read_launches(),
                forwards=llm.forwards, seconds=time.perf_counter() - t0)


class FileListener(workflow.EventListener):
    """The event is a file's coming into being: returns its path."""

    def __init__(self, path: str):
        self.path = path

    def poll_for_event(self) -> str:
        while not os.path.exists(self.path):
            time.sleep(0.05)
        return self.path


def build_dag(config, storage: str):
    import ray_tpu_torch as rt

    train = rt.remote(num_gpus=config["num_gpus"])(train_step)
    serve = rt.remote(num_gpus=config["num_gpus"])(serve_step)
    return serve.bind(train.bind(config, storage),
                      workflow.wait_for_event(FileListener,
                                              event_path(storage)),
                      config)


def event_path(storage: str) -> str:
    return os.path.join(storage, "go")


def driver(config) -> int:
    """The first run: joins the cluster at ``config["address"]`` and runs
    the workflow; ``drive`` kills it while the event step waits."""
    import ray_tpu_torch as rt

    rt.init(address=config["address"])
    out = workflow.run(build_dag(config, config["storage"]),
                       workflow_id=WORKFLOW_ID,
                       storage=config["storage"])
    print(json.dumps({"tokens": out["tokens"]}), flush=True)
    return 0


def _train_step_id(config) -> str:
    """The train step's id in the run, as the executor derives it."""
    dag = build_dag(config, config["storage"])
    ids: Dict[int, str] = {}
    workflow._step_id(dag, ids)
    return ids[id(dag._bound_args[0])]


# ---------------------------------------------------------------------------
# the queue's consumer
# ---------------------------------------------------------------------------

class Consumer:
    """Takes prompts from one queue and puts ``(index, tokens, wall time)``
    on another, answering each through ``GPT2LLM``."""

    def __init__(self, config):
        self.config = config
        self.llm = load_llm(config)
        self.ready_at = time.time()

    def ready(self) -> Dict[str, Any]:
        return dict(_where(self.config), ready_at=self.ready_at)

    def run(self, inbox, outbox, n: int) -> Dict[str, Any]:
        from ray_tpu_torch.ops import attention as attn

        attn.zero_launches()
        self.llm.forwards = 0
        for i in range(n):
            tokens = greedy(self.llm, inbox.get(timeout=PROMPT_WAIT_S),
                            self.config["new_tokens"])
            outbox.put((i, tokens, time.time()))
        return dict(_where(self.config), launches=attn.read_launches(),
                    forwards=self.llm.forwards)


def _start_consumer(config):
    """The consumer actor and the time it was asked for."""
    import ray_tpu_torch as rt

    created_at = time.time()
    return rt.remote(num_gpus=config["num_gpus"])(Consumer).remote(
        config), created_at


def _queue_run(config, started) -> Dict[str, Any]:
    """The queue run, on the consumer that ``_start_consumer`` made
    (``started``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.multiprocessing import Pool
    from ray_tpu_torch.util.queue import Full, Queue

    lens = config["prompt_lens"]
    n = len(lens)
    out: Dict[str, Any] = {}
    t0 = time.perf_counter()
    with Pool(processes=2) as pool:
        prompts = pool.map(functools.partial(
            prompt, lens=lens, vocab=config["serve_model"]["vocab_size"]),
            range(n))
    out["pool_s"] = time.perf_counter() - t0
    out["prompts"] = prompts
    inbox, outbox = Queue(maxsize=2), Queue()
    t0 = time.perf_counter()
    consumer, created_at = started
    out["consumer"] = rt.get(consumer.ready.remote(), timeout=300)
    out["consumer_wait_s"] = time.perf_counter() - t0
    out["consumer_start_s"] = out["consumer"].pop("ready_at") - created_at
    put_at = {}
    for i in (0, 1):
        put_at[i] = time.time()
        inbox.put(prompts[i])
    out["full_after_two"] = inbox.full()
    try:
        inbox.put(prompts[2], block=False)
        out["third_put_refused"] = False
    except Full:
        out["third_put_refused"] = True
    run = consumer.run.remote(inbox, outbox, n)
    out["blocked_put_s"] = []
    for i in range(2, n):
        put_at[i] = time.time()
        inbox.put(prompts[i], timeout=300)
        out["blocked_put_s"].append(time.time() - put_at[i])
    answers = {}
    for _ in range(n):
        i, tokens, done_at = outbox.get(timeout=300)
        answers[i] = tokens
        out.setdefault("round_trip_s", {})[i] = done_at - put_at[i]
    out["round_trip_s"] = [out["round_trip_s"][i] for i in range(n)]
    out["tokens"] = [answers[i] for i in range(n)]
    out["consumer"].update(rt.get(run, timeout=300))
    out["wall_s"] = time.perf_counter() - t0
    rt.kill(consumer)
    inbox.shutdown()
    outbox.shutdown()
    return out


# ---------------------------------------------------------------------------
# the whole drive
# ---------------------------------------------------------------------------

def _wait(predicate, timeout_s: float, what: str):
    deadline = time.time() + timeout_s
    while not predicate():
        if time.time() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.05)


def drive(workdir: str, config: Dict[str, Any],
          init_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Both runs on a cluster of ``init_kwargs`` started here, the
    workflow's storage under ``workdir``. Returns what it saw."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.node import package_env
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.tools.cluster_runs import session_processes

    storage = os.path.join(workdir, "storage")
    os.makedirs(storage, exist_ok=True)
    rt.init(**init_kwargs)
    session_dir = global_worker.node.session_dir
    config = dict(config, storage=storage,
                  address=global_worker.node.address)
    out: Dict[str, Any] = {"storage": storage}
    proc = None
    try:
        started = _start_consumer(config)
        run = workflow._WorkflowRun(WORKFLOW_ID, storage)
        train_id = _train_step_id(config)
        checkpoint = run.step_path(train_id)
        log = open(os.path.join(workdir, "driver.log"), "w")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.tools.workflow_runs",
             "driver", json.dumps(config)], stdout=log,
            stderr=subprocess.STDOUT, cwd=workdir,
            env=package_env(dict(os.environ)))
        _wait(lambda: os.path.exists(checkpoint) or proc.poll() is not None,
              CHECKPOINT_WAIT_S, "the train step's checkpoint")
        out["first_run_s"] = time.perf_counter() - t0
        out["driver_alive_at_kill"] = proc.poll() is None
        out["event_fired_at_kill"] = os.path.exists(event_path(storage))
        proc.send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        out["driver_returncode"] = proc.wait(timeout=60)
        log.close()
        out["status_after_kill"] = workflow.get_status(WORKFLOW_ID,
                                                       storage=storage)
        open(event_path(storage), "w").close()
        t_resume = time.perf_counter()
        out["kill_to_resume_s"] = t_resume - t_kill
        result = workflow.resume(WORKFLOW_ID, build_dag(config, storage),
                                 storage=storage)
        out["resume_s"] = time.perf_counter() - t_resume
        out["serve"] = result
        out["train"] = run.load_step(train_id)["value"]
        out["status"] = workflow.get_status(WORKFLOW_ID, storage=storage)
        out["output"] = workflow.get_output(WORKFLOW_ID, storage=storage)
        out["listed"] = workflow.list_all(storage=storage)
        with open(os.path.join(storage, CALLS)) as f:
            out["calls"] = [line.split()[0] for line in f]
        out["queue"] = _queue_run(config, started)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        rt.shutdown()
    deadline = time.time() + 30
    while time.time() < deadline and session_processes(session_dir):
        time.sleep(0.5)
    out["processes_left"] = session_processes(session_dir)
    return out


def drive_checked(workdir: str, config: Dict[str, Any],
                  init_kwargs: Dict[str, Any], n_layer: int):
    """``drive`` and then ``problems`` in the same process (which the
    checks take as the driver's): (out, problems). For a caller that runs
    the drive in a process of its own."""
    out = drive(workdir, config, init_kwargs)
    return out, problems(out, config, n_layer)


def problems(out: Dict[str, Any], config: Dict[str, Any],
             n_layer: int) -> List[str]:
    """The checks both callers share: the killed run resumed without
    re-running its train step, the status and listing read SUCCESSFUL,
    the output is the served tokens, the queue kept its bound and order,
    no process is left, and on the card the launch counts."""
    found = []
    if not out.get("driver_alive_at_kill") or out.get("event_fired_at_kill"):
        found.append("the driver was not waiting on the event when killed")
    if out.get("driver_returncode") != -signal.SIGKILL:
        found.append(f"driver exit {out.get('driver_returncode')}")
    if out.get("status_after_kill") == workflow.SUCCESSFUL:
        found.append("the killed run reads SUCCESSFUL")
    if out.get("calls") != ["train_step", "serve_step"]:
        found.append(f"step calls {out.get('calls')}")
    if out.get("status") != workflow.SUCCESSFUL or \
            (WORKFLOW_ID, workflow.SUCCESSFUL) not in out.get("listed", []):
        found.append(f"status {out.get('status')}, listed "
                     f"{out.get('listed')}")
    serve, train = out.get("serve") or {}, out.get("train") or {}
    if (out.get("output") or {}).get("tokens") != serve.get("tokens"):
        found.append("get_output differs from the resumed run's output")
    n, k = len(config["prompt_lens"]), config["new_tokens"]
    if len(serve.get("tokens") or []) != n or any(
            len(t) != k for t in serve["tokens"]):
        found.append(f"served tokens {serve.get('tokens')}")
    pids = {os.getpid()}
    if serve.get("pid") in pids or train.get("pid") in pids:
        found.append("a step ran in the driver's process")
    q = out.get("queue") or {}
    if not (q.get("full_after_two") and q.get("third_put_refused")):
        found.append("the bounded queue took a third prompt")
    if q.get("consumer", {}).get("pid") in pids:
        found.append("the consumer ran in the driver's process")
    if out.get("processes_left"):
        found.append(f"session processes left: {out['processes_left']}")
    if config["device"] == "cuda":
        from ray_tpu_torch.ops.attention import KERNELS

        want = dict.fromkeys(KERNELS, config["steps"] * n_layer)
        if train.get("launches") != want:
            found.append(f"train step launches {train.get('launches')}, "
                         f"want {want}")
        for name, run in (("serve step", serve),
                          ("consumer", q.get("consumer", {}))):
            got = run.get("launches") or {}
            if not got.get("flash_fwd") or got["flash_fwd"] < \
                    n_layer * run.get("forwards", 0):
                found.append(f"{name}: flash_fwd {got} for "
                             f"{run.get('forwards')} forwards")
            if got.get("flash_bwd_dq") or got.get("flash_bwd_dkv"):
                found.append(f"{name}: backward launches {got}")
    return found


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "driver":
        sys.exit("usage: python -m ray_tpu_torch.tools.workflow_runs "
                 "driver CONFIG_JSON")
    # through the module's own name: the steps then travel by reference
    from ray_tpu_torch.tools import workflow_runs

    sys.exit(workflow_runs.driver(json.loads(sys.argv[2])))
