"""Model-parallel runs at a world of one, shared by ``chip_smoke.py``
(phase 27, over NCCL on the card at full width) and the CPU tests (over
gloo at ``small_test`` size).

``world_of_one`` forms a process group of one rank on a free localhost
port; ``gpt2_steps`` trains GPT-2 through one of the parallel steps
(``build_train_step_sp`` with ``attention="ring"``, ``build_train_step_pp``
or ``shard_train_state_tp``) on a mesh of size-1 axes, ``moe_ep_steps`` the
MoE LM through ``shard_train_state_ep``, and ``llama_tp_generate`` serves
Llama through ``shard_params_tp``/``apply_tp_plan`` and ``generate`` (whose
caches ``shard_kv_caches_tp`` splits). Weights come from the same seeds as
``train_runs``, ``moe_runs`` and the serving phases, so each run compares
with its plain counterpart step for step. Each step is timed on the host
clock to a sync; ``counts`` = (zero, read) brackets each step alone and its
reading is kept per step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import socket
import time
from typing import Dict

import torch

from ray_tpu_torch.models import gpt2, llama, moe_lm
from ray_tpu_torch.parallel import apply_tp_plan, create_mesh

MESHES = {"sp": {"data": 1, "sp": 1}, "pp": {"data": 1, "pipeline": 1},
          "tp": {"data": 1, "model": 1}, "ep": {"data": 1, "ep": 1},
          "llama_tp": {"model": 1}}


@contextlib.contextmanager
def world_of_one(backend: str):
    """A process group of this process alone ("nccl" on the card, "gloo"
    on the CPU), destroyed on exit."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gpt2_steps(kind: str, cfg: gpt2.GPT2Config, batch: Dict[str, torch.Tensor],
               steps: int, device, learning_rate: float = 3e-4,
               microbatches: int = 4, counts=None) -> Dict[str, list]:
    """``steps`` AdamW steps of GPT-2 through the parallel step ``kind``
    ("sp", "pp" or "tp") at a world of one, from the weights of seed 0
    drawn on the CPU (``train_runs``'s): each step's loss, ms and, with
    ``counts``, launches."""
    device = torch.device(device)
    mesh = create_mesh(MESHES[kind], device.type)
    gen = torch.Generator().manual_seed(0)
    if kind == "sp":
        model, opt = gpt2.make_train_state(
            dataclasses.replace(cfg, attention="ring"), gen, learning_rate,
            device=device)
        step = gpt2.build_train_step_sp(model, opt, mesh)
    elif kind == "pp":
        model, opt = gpt2.make_pipeline_train_state(
            cfg, gen, 1, learning_rate, device=device)
        model, opt = gpt2.shard_pipeline_state(model, opt, mesh)
        step = gpt2.build_train_step_pp(model, opt, mesh,
                                        n_microbatches=microbatches)
    elif kind == "tp":
        model, opt = gpt2.make_train_state(cfg, gen, learning_rate,
                                           device=device)
        model, opt = gpt2.shard_train_state_tp(model, opt, mesh)
        step = gpt2.build_train_step(model, opt, mesh=mesh)
        batch = gpt2.shard_batch(batch, mesh)
    else:
        raise ValueError(f"unknown parallel step {kind!r}")
    run = {"losses": [], "step_ms": [], "launches": []}
    for _ in range(steps):
        if counts is not None:
            counts[0]()
        _sync(device)
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        _sync(device)
        run["step_ms"].append((time.perf_counter() - t0) * 1e3)
        run["losses"].append(float(loss))
        if counts is not None:
            run["launches"].append(counts[1]())
    del model, opt, step
    return run


def moe_ep_steps(cfg: moe_lm.MoELMConfig, batch: Dict[str, torch.Tensor],
                 steps: int, device, learning_rate: float = 3e-4,
                 counts=None) -> Dict[str, list]:
    """``steps`` AdamW steps of the MoE LM through ``shard_train_state_ep``
    at a world of one, from the weights of seed 0 (``moe_runs``'s): each
    step's loss, lm, aux, ms and, with ``counts``, launches."""
    device = torch.device(device)
    mesh = create_mesh(MESHES["ep"], device.type)
    model, opt = moe_lm.make_train_state(
        cfg, torch.Generator().manual_seed(0), learning_rate, device=device)
    model, opt, place = moe_lm.shard_train_state_ep(model, opt, mesh)
    step = moe_lm.build_train_step(model, opt)
    batch = place(batch)
    run = {"losses": [], "lm": [], "aux": [], "step_ms": [], "launches": []}
    for _ in range(steps):
        if counts is not None:
            counts[0]()
        _sync(device)
        t0 = time.perf_counter()
        model, opt, loss, lm, aux = step(model, opt, batch)
        _sync(device)
        run["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for key, value in (("losses", loss), ("lm", lm), ("aux", aux)):
            run[key].append(float(value))
        if counts is not None:
            run["launches"].append(counts[1]())
    del model, opt, step
    return run


def llama_tp_generate(model: llama.Llama, prompts: torch.Tensor,
                      new_tokens: int, counts=None) -> Dict[str, object]:
    """``model`` placed by ``shard_params_tp`` and ``apply_tp_plan`` over a
    model axis of one, then ``generate``'s greedy tokens (its caches split
    by ``shard_kv_caches_tp``): the tokens, the host seconds to a sync
    and, with ``counts``, the launches of the call, then those of its
    prefill and of its decode steps, each read around its own part as
    ``llama_runs.time_steps`` runs them again on the tokens."""
    from ray_tpu_torch.tools import llama_runs

    device = prompts.device
    mesh = create_mesh(MESHES["llama_tp"], device.type)
    apply_tp_plan(model, llama.shard_params_tp(model, mesh), mesh)
    if counts is not None:
        counts[0]()
    _sync(device)
    t0 = time.perf_counter()
    tokens = llama.generate(model, prompts, new_tokens)
    _sync(device)
    out = {"tokens": tokens, "generate_s": time.perf_counter() - t0}
    if counts is not None:
        out["launches"] = counts[1]()
        steps = llama_runs.time_steps(model, tokens, prompts.shape[1],
                                      counts)
        out.update(prefill_launches=steps["prefill_launches"],
                   decode_launches=steps["decode_launches"])
    return out
