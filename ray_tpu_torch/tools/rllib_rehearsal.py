"""Rehearse ``chip_smoke.py``'s RLlib phases 28-32 on a machine without a
card: the same tuned examples, learners and checks, with the learners on
the CPU.

    python -m ray_tpu_torch.tools.rllib_rehearsal [offline qmix r2d2 dreamerv3 dt]

Run from the repo root (it imports ``chip_smoke``). What only the card can
answer is stubbed: ``torch.cuda``'s device queries, each RLlib module's
``learner_device`` (the CPU), the learner-placement checks, the update
profiles and DT's kernel rows; the CUDA-vs-CPU update runs on the CPU
twice. The phases print their JSON lines as on the card; a phase whose
check fails raises, as there. On the CPU no flash kernel launches, so
``dt``'s launch checks fail by design; run it last.
"""

from __future__ import annotations

import sys
import time

import torch


def _stub_the_card(chip_smoke) -> None:
    from ray_tpu_torch.rllib import algorithm, dreamerv3, dt, qmix, r2d2

    torch.cuda.current_device = lambda: 0
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.get_device_name = lambda *a: "cpu"
    for module in (algorithm, dreamerv3, dt, qmix, r2d2):
        module.learner_device = lambda *a: torch.device("cpu")
    both = chip_smoke._cuda_vs_cpu
    chip_smoke._cuda_vs_cpu = lambda run, *a, **k: both(
        lambda device: run("cpu"), *a, **k)
    chip_smoke._driver_learner_fields = lambda *a: ({}, [])
    chip_smoke._update_profile = lambda learner, batch: {}
    chip_smoke._dt_kernel_rows = lambda *a: ([], lambda: None)


def main(argv=None) -> int:
    import chip_smoke

    phases = (argv if argv is not None else sys.argv[1:]) or [
        "offline", "qmix", "r2d2", "dreamerv3", "dt"]
    _stub_the_card(chip_smoke)
    if "dt" in phases and "offline" not in phases:
        raise SystemExit("dt reads the dataset the offline phase makes: "
                         "rehearse them together")
    for name in phases:
        t0 = time.perf_counter()
        getattr(chip_smoke, f"phase_rllib_{name}")("cpu")
        print(f"rehearsed {name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
