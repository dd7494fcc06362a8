"""ViT trials under Tune for ``chip_smoke.py`` and the CPU tests: the loop a
trial's ``TorchTrainer`` worker runs, the ``Tuner`` that sweeps its learning
rate under ASHA, and a record of ASHA's decisions with their replay.

The same code runs ViT-B/16 at full width on the card (``chip_smoke.py``
phase 21) and ``small_test`` on the CPU (``tests/test_torch_tune_vit.py``).
The loop takes only plain data (the trial's lr, the model's name and dtype,
seeds, sizes, a device type), so a trial carries no tensor in its config.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from ray_tpu_torch.models import vision
from ray_tpu_torch.ops.attention import KERNELS
from ray_tpu_torch.tools.train_runs import counting_plain_calls
from ray_tpu_torch.tune.schedulers import ASHAScheduler
from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler

MODELS = {"vit_b16": vision.ViTConfig.vit_b16,
          "small_test": vision.ViTConfig.small_test}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# chip_smoke.py phase 13's run: ViT-B/16 bf16 over f32 weights of seed 0,
# one batch of 64 images from numpy seed 40
LOOP = {"model": "vit_b16", "dtype": "bfloat16", "weight_seed": 0,
        "batch_seed": 40, "batch": 64, "device": "cuda"}
# intra-op threads of a trial on the CPU: the CPU's sums split by thread
# count, so a loss's last bit moves with the count a worker starts with,
# and ASHA's first rung compares first losses that every trial shares
CPU_THREADS = 1


def vit_trial_loop(config: Dict) -> None:
    """One trial, run in its ``TorchTrainer`` worker: ``make_train_state``'s
    AdamW at ``config["lr"]`` on the weights of ``config["weight_seed"]``
    (or the state dict saved at ``config["init"]``), ``config["steps"]``
    steps on one ``synthetic_image_batch``, each reported with ``loss``, its
    ms on the host clock to a sync, the worker's launch counts of the three
    kernels (zeroed before the first step), its calls of their plain
    versions, its kernel builds (``steptrace`` compile records), its peak
    card memory and wall-clock marks (the worker process's start, the
    loop's start, its CUDA context ready, the model and optimizer built,
    the batch ready, each report). The trial's scheduler may stop it after
    any report. On the CPU it computes with ``CPU_THREADS`` intra-op
    threads, whatever its process started with."""
    from ray_tpu_torch import train
    from ray_tpu_torch._private import steptrace
    from ray_tpu_torch.ops import attention as attn

    t_loop = time.time()
    device = torch.device(config["device"])
    if device.type == "cpu":
        torch.set_num_threads(CPU_THREADS)
    if device.type == "cuda":
        device = torch.device("cuda", train.get_context().get_local_rank())
        torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
    t_context = time.time()
    cfg = MODELS[config["model"]](dtype=DTYPES[config["dtype"]])
    net, optimizer = vision.make_train_state(
        cfg, torch.Generator().manual_seed(config["weight_seed"]),
        config["lr"], device=device)
    if config.get("init"):
        net.load_state_dict(torch.load(config["init"], map_location=device))
    step = vision.build_train_step(net, optimizer)
    _sync(device)
    t_built = time.time()
    batch = vision.synthetic_image_batch(config["batch_seed"],
                                         config["batch"], cfg.image_size,
                                         cfg.num_classes, device=device)
    attn.zero_launches()
    t_ready = time.time()
    with counting_plain_calls() as plain_calls:
        for i in range(config["steps"]):
            _sync(device)
            t0 = time.perf_counter()
            net, optimizer, loss = step(net, optimizer, batch)
            loss = float(loss)
            step_ms = (time.perf_counter() - t0) * 1e3
            train.report({
                "loss": loss, "step": i, "step_ms": step_ms,
                "lr": config["lr"], "pid": os.getpid(),
                "cpu_threads": torch.get_num_threads(),
                "device_name": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                "launches": attn.read_launches(),
                "plain_calls": plain_calls[0],
                "kernel_builds": [r for r in steptrace.snapshot()
                                  if r["kind"] == "compile"],
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else None),
                "worker_start": _process_start(), "loop_start": t_loop,
                "context": t_context, "built": t_built, "ready": t_ready,
                "reported_at": time.time(),
            })


def _process_start() -> float:
    """This process's start on the wall clock, from Linux's ``/proc``."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RecordingASHA(ASHAScheduler):
    """``ASHAScheduler`` that keeps, in order of arrival, every result it
    was handed and what it decided: ``events`` holds ``("result", trial id,
    t, metric, decision, rung, cutoff)`` and ``("complete", trial id, t,
    metric)``; ``rung`` is the rung the result recorded at (None if none)
    and ``cutoff`` the metric it had to beat there (None while the rung
    held fewer than ``reduction_factor`` results). ``configs`` maps each
    trial id, in the order the trials were added, to its config, and
    ``results`` to the results it reported, whole."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.events: List[tuple] = []
        self.configs: Dict[str, Dict] = {}
        self.results: Dict[str, List[Dict]] = {}

    @property
    def trial_ids(self) -> List[str]:
        return list(self.configs)

    def on_trial_add(self, controller, trial):
        self.configs[trial.trial_id] = trial.config
        super().on_trial_add(controller, trial)

    def _rung(self, trial_id: str, t) -> tuple:
        bracket = self._trial_bracket.get(trial_id)
        if bracket is None or t is None or t >= self._max_t:
            return None, None
        for rung in reversed(bracket.rungs):
            if t < rung["level"] or trial_id in rung["recorded"]:
                continue
            cutoff = bracket.cutoff(rung["recorded"])
            if cutoff is not None and self._mode == "min":
                cutoff = -cutoff
            return rung["level"], cutoff
        return None, None

    def on_trial_result(self, controller, trial, result):
        self.results.setdefault(trial.trial_id, []).append(result)
        t = result.get(self._time_attr)
        rung, cutoff = self._rung(trial.trial_id, t)
        decision = super().on_trial_result(controller, trial, result)
        self.events.append(("result", trial.trial_id, t,
                            result.get(self._metric), decision, rung,
                            cutoff))
        return decision

    def on_trial_complete(self, controller, trial, result):
        self.events.append(("complete", trial.trial_id,
                            (result or {}).get(self._time_attr),
                            (result or {}).get(self._metric)))
        super().on_trial_complete(controller, trial, result)


class _Trial:
    def __init__(self, trial_id: str):
        self.trial_id = trial_id


def replay(events: Iterable[tuple], trial_ids: Sequence[str], *,
           metric: str, mode: str, **asha) -> List[str]:
    """The decisions a fresh ``ASHAScheduler(**asha)`` makes on ``events``
    (``RecordingASHA.events``) handed to it in their order, after the
    trials ``trial_ids`` were added in theirs."""
    scheduler = ASHAScheduler(metric=metric, mode=mode, **asha)
    time_attr = asha.get("time_attr", "training_iteration")
    for trial_id in trial_ids:
        scheduler.on_trial_add(None, _Trial(trial_id))
    decisions = []
    for kind, trial_id, t, value, *_ in events:
        result = {time_attr: t, metric: value}
        if kind == "result":
            decisions.append(scheduler.on_trial_result(
                None, _Trial(trial_id), result))
        else:
            scheduler.on_trial_complete(None, _Trial(trial_id), result)
    return decisions


def stopped_early(scheduler: RecordingASHA) -> Dict[str, float]:
    """Trial id -> the iteration at which ASHA stopped it below ``max_t``."""
    return {e[1]: e[2] for e in scheduler.events
            if e[0] == "result" and e[4] == TrialScheduler.STOP
            and e[2] < scheduler._max_t}


def asha_tuner(lrs: Sequence[float], loop: Optional[Dict] = None, *,
               max_t: int, grace_period: int, reduction_factor: int,
               max_concurrent_trials: int,
               resources_per_worker: Optional[Dict[str, float]] = None,
               use_gpu: bool = True, storage_path: Optional[str] = None):
    """(Tuner, RecordingASHA): ``Tuner(TorchTrainer(vit_trial_loop))`` over
    a grid of ``lrs`` in their order, one worker a trial leasing
    ``resources_per_worker``, ASHA on ``loss`` (min) by
    ``training_iteration`` up to ``max_t`` (each trial's loop runs at most
    ``max_t`` steps), at most ``max_concurrent_trials`` at once."""
    from ray_tpu_torch import train, tune

    scheduler = RecordingASHA(time_attr="training_iteration", max_t=max_t,
                              grace_period=grace_period,
                              reduction_factor=reduction_factor)
    trainer = train.TorchTrainer(
        vit_trial_loop, train_loop_config=dict(loop or LOOP, steps=max_t),
        scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=use_gpu,
            resources_per_worker=resources_per_worker),
        run_config=train.RunConfig(name="tune_asha_vit",
                                   storage_path=storage_path))
    tuner = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search(list(lrs))}},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", scheduler=scheduler,
            max_concurrent_trials=max_concurrent_trials))
    return tuner, scheduler
