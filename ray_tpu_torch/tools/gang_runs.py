"""GPT-2 trained by a gang whose gradients cross the store collective
through ``train.GradSync`` (``chip_smoke.py`` phase 36 (b)).

``gradsync_loop`` is the train loop each rank runs: phase 8's model
(``train_runs.bf16_config`` on the card, or ``small_test`` for a CPU drive),
weights from seed 0 and batch from seed 1; rank r takes rows ``r * rows``
to ``(r + 1) * rows`` of the whole batch. Each parameter's gradient goes to
``GradSync.submit`` from a ``register_post_accumulate_grad_hook``, so that
with ``overlap_grads`` the chunked allreduce of the gradients finished
first runs under the rest of the backward; after the backward the step
waits for the mean-reduced gradients (numpy, as the store backend returns
them), copies them back into ``.grad`` and takes its AdamW step. Each rank
writes its records to ``out_dir/rank<r>.json``: a report reaches the driver
from rank 0 only.

With ``capture`` the first step's gradients are kept for the int8 check of
``int8_bound_problems``: "reduced" has rank 0 save the reduced gradients
(``out_dir/f32_step1.pt``); "int8" has every rank write the largest
magnitude of each of its own gradients and rank 0 the largest error of its
int8-reduced gradient against the f32 one saved at ``ref_path``, per
parameter. ``chunk_bytes`` sets ``collective_chunk_bytes`` in the worker
(the default, 1 MiB, chunks GPT-2-124M's larger gradients; a small model
on the CPU needs a smaller one to chunk at all).

``gradsync_fit`` runs the loop under ``TorchTrainer`` with the store
collective's ``train_dp`` group (``TorchConfig(backend="gloo")``: the store
collective needs no card per rank, so the ranks may share one) and returns
the ranks' records with the gang's steptrace rows.

``step1_grads`` takes the first step's gradients in one process, of the
whole batch and of each rank's rows alone, and ``grad_gaps`` holds a
reduced gradient against another, per parameter: the mean of the ranks'
gradients is the whole batch's gradient, where a sum is twice it and an
unreduced gradient is one rank's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List


def _config(name: str):
    """Phase 8's GPT-2-124M configuration, or an f32 ``small_test`` one."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.tools import train_runs

    if name == "small_test":
        return gpt2.GPT2Config.small_test(
            attention="flash", loss_chunks=4, dtype=torch.float32)
    return train_runs.bf16_config()


def gradsync_loop(config: dict):
    import warnings

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as attn

    if config.get("chunk_bytes") is not None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        GLOBAL_CONFIG.update({"collective_chunk_bytes": config["chunk_bytes"]})
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    on_card = config["device"] != "cpu"
    device = torch.device("cuda", torch.cuda.current_device()) if on_card \
        else torch.device("cpu")
    attn.zero_launches()
    cfg = _config(config["model"])
    model, opt = gpt2.make_train_state(
        cfg, torch.Generator().manual_seed(0), device=device)
    rows = config["rows"]
    whole = gpt2.synthetic_batch(1, rows * ctx.get_world_size(),
                                 config["seq"], cfg.vocab_size, device=device)
    batch = {k: v[rank * rows:(rank + 1) * rows] for k, v in whole.items()}
    params = dict(model.named_parameters())
    names = {p: n for n, p in params.items()}
    live: Dict[str, object] = {"sync": None, "first_submit": None,
                               "maxabs": None}

    def hook(p):
        if live["first_submit"] is None:
            live["first_submit"] = time.time()
        if live["maxabs"] is not None:
            live["maxabs"][names[p]] = p.grad.detach().abs().amax()
        live["sync"].submit(names[p], p.grad)

    handles = [p.register_post_accumulate_grad_hook(hook)
               for p in params.values()]
    capture = config.get("capture", "")
    out_dir = config["out_dir"]
    records: List[dict] = []
    for i in range(config["steps"]):
        first = i == 0 and bool(capture)
        live.update(first_submit=None,
                    maxabs={} if first and capture == "int8" else None)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        with train.GradSync() as sync:
            live["sync"] = sync
            with train.step_phase("compute"):
                loss = gpt2.loss_fn(model, batch)
                loss.backward()
                if on_card:
                    torch.cuda.synchronize()
            t_backward = time.time()
            reduced = sync.results()
        t_reduced = time.time()
        with warnings.catch_warnings():  # read-only store views, copied
            warnings.simplefilter("ignore", UserWarning)
            for name, p in params.items():
                p.grad.copy_(torch.from_numpy(np.asarray(reduced[name]))
                             .view_as(p.grad))
        if first:
            _capture(capture, rank, out_dir, reduced, live["maxabs"],
                     config.get("ref_path"))
        with train.step_phase("optimizer"):
            opt.step()
        loss = float(loss)
        records.append({
            "step": i, "rank": rank, "loss": loss,
            "step_ms": (time.perf_counter() - t0) * 1e3,
            "allreduce_s": t_reduced - live["first_submit"],
            "exposed_s": t_reduced - t_backward,
            "reduced_type": type(reduced[next(iter(params))]).__name__,
            "pid": os.getpid(),
            "device": str(device),
            "device_name": torch.cuda.get_device_name(device)
            if on_card else "cpu",
            "launches": attn.read_launches()})
        train.report({"step": i, "loss": loss})
    for h in handles:
        h.remove()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(records, f)


def _capture(kind, rank, out_dir, reduced, maxabs, ref_path):
    import numpy as np
    import torch

    if kind == "reduced":
        if rank == 0:
            torch.save({n: torch.from_numpy(np.array(r))
                        for n, r in reduced.items()},
                       os.path.join(out_dir, "f32_step1.pt"))
        return
    with open(os.path.join(out_dir, f"int8_local_max_rank{rank}.json"),
              "w") as f:
        json.dump({n: float(m) for n, m in maxabs.items()}, f)
    if rank == 0:
        ref = torch.load(ref_path)
        check = {}
        for n, r in reduced.items():
            want = ref[n].numpy()
            check[n] = {"err": float(np.abs(np.asarray(r) - want).max()),
                        "f32_max": float(np.abs(want).max()),
                        "size": int(want.size)}
        with open(os.path.join(out_dir, "int8_check.json"), "w") as f:
            json.dump(check, f)


def int8_bound_problems(out_dir: str, world: int):
    """The reference's analytic bound (``tests/test_collective_backend.py::
    test_quant_error_within_analytic_bound``) on the first step's real
    gradients, per parameter: each rank's contribution rounds within half
    its scale (its largest magnitude / 127), the reduced value once more
    (the sum's largest magnitude / 127), and MEAN divides it all by the
    world. Returns (fields, problems)."""
    with open(os.path.join(out_dir, "int8_check.json")) as f:
        check = json.load(f)
    local = []
    for r in range(world):
        with open(os.path.join(out_dir, f"int8_local_max_rank{r}.json")) as f:
            local.append(json.load(f))
    worst, worst_name, problems = 0.0, None, []
    for name, c in check.items():
        bound = (0.5 * sum(m[name] for m in local) / 127.0
                 + 0.5 * world * c["f32_max"] / 127.0 + 1e-7) / world
        ratio = c["err"] / bound
        if ratio > worst:
            worst, worst_name = ratio, name
        if c["err"] > bound:
            problems.append(f"{name}: int8 error {c['err']} over the bound "
                            f"{bound}")
    return {"params_checked": len(check),
            "worst_err_over_bound": worst,
            "worst_param": worst_name}, problems


def gradsync_fit(loop_config: dict, quant: str, resources_per_worker: dict,
                 use_gpu: bool, name: str):
    """One ``TorchTrainer.fit`` of ``gradsync_loop`` with
    ``loop_config["ranks"]`` workers, ``overlap_grads`` and the store
    collective's ``train_dp`` group at ``quant``: (each rank's records, the
    gang's merged steptrace rows of group ``train_dp`` made during this fit,
    its chunk records, its compute phases, the fit's wall seconds)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.util import state

    out_dir = loop_config["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.time()
    trainer = train.TorchTrainer(
        gradsync_loop, train_loop_config=loop_config,
        torch_config=train.TorchConfig(backend="gloo",
                                       collective_quant=quant),
        overlap_grads=True,
        scaling_config=train.ScalingConfig(
            num_workers=loop_config["ranks"], use_gpu=use_gpu,
            resources_per_worker=resources_per_worker),
        run_config=train.RunConfig(
            name=name, storage_path=os.path.join(out_dir, "results")))
    result = trainer.fit()
    wall_s = time.time() - t_start
    if result.error is not None:
        raise RuntimeError(f"gradsync fit {name}: {result.error}")
    records = []
    for r in range(loop_config["ranks"]):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            records.append(json.load(f))
    merged = state.steptrace_summary()
    late = lambda rec: rec["start"] >= t_start
    rows = [c for c in merged["collectives"] if c["group"] == "train_dp"
            and all(late(v) for v in c["ranks"].values())]
    chunks = [c for c in merged.get("chunks", ())
              if c["group"] == "train_dp" and late(c)]
    compute = [p for p in merged["phases"]
               if p["phase"] == "compute" and late(p)]
    return {"records": records, "rows": rows, "chunks": chunks,
            "compute": compute, "wall_s": wall_s}


def step1_grads(model: str, device: str, seq: int, rows: int, ranks: int):
    """The first step's f32 gradients of ``gradsync_loop``'s weights in one
    process: {"whole": of the whole batch the ranks split, "ranks": [of
    rank r's rows alone, for each r]}, each {name: CPU tensor}."""
    import torch

    from ray_tpu_torch.models import gpt2

    cfg = _config(model)
    net = gpt2.init_params(cfg, torch.Generator().manual_seed(0),
                           device=device).train()
    whole = gpt2.synthetic_batch(1, rows * ranks, seq, cfg.vocab_size,
                                 device=device)
    batches = [whole] + [{k: v[r * rows:(r + 1) * rows]
                          for k, v in whole.items()} for r in range(ranks)]
    grads = []
    for batch in batches:
        net.zero_grad(set_to_none=True)
        gpt2.loss_fn(net, batch).backward()
        grads.append({n: p.grad.detach().float().cpu()
                      for n, p in net.named_parameters()})
    return {"whole": grads[0], "ranks": grads[1:]}


def grad_gaps(reduced: dict, whole: dict) -> Dict[str, float]:
    """Per parameter, ``|reduced - whole| / |whole|`` (2-norms): how far a
    reduced gradient lies from another (the whole batch's)."""
    import numpy as np
    import torch

    gaps = {}
    for name, want in whole.items():
        got = torch.as_tensor(np.asarray(reduced[name]), dtype=torch.float32)
        gaps[name] = float((got.view_as(want) - want).norm() / want.norm())
    return gaps


def overlapped(rows: List[dict], compute: List[dict]) -> bool:
    """Whether some rank's gradient collective interval overlaps one of
    that rank's own compute phases (the reference's overlap claim)."""
    for row in rows:
        for rank, iv in row["ranks"].items():
            for ph in compute:
                if int(ph["rank"]) == int(rank) and \
                        iv["start"] < ph["end"] and iv["end"] > ph["start"]:
                    return True
    return False


def wire_bytes(rows: List[dict]) -> Dict[str, int]:
    """Wire and logical bytes the rows' ranks moved, summed."""
    wire = sum(v.get("wire", v.get("bytes", 0)) for row in rows
               for v in row["ranks"].values())
    logical = sum(v.get("logical", v.get("bytes", 0)) for row in rows
                  for v in row["ranks"].values())
    return {"wire": wire, "logical": logical}
