"""Timing on the card, shared by ``chip_smoke.py`` and the A/B tools.

``time_ms`` is the caller's view: CUDA events around a run of calls, so a
call whose host work (argument checks, allocation, the launch itself) takes
longer than its kernels is timed by the host. ``device_ms`` is the card's
view: the kernels' own durations from ``torch.profiler``'s CUDA activity,
without the gaps the host leaves between them.

Take every ``time_ms`` reading of a process before its first profiler
session: after one, each launch costs the host more, so a call made of many
small launches (SDPA's forward + backward through autograd) reads much
slower by events, while a single-kernel call does not move (PERF.md).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch


def time_ms(fn: Callable[[], object], iters: int, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` between two CUDA events around ``iters``
    calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_calls(fn: Callable[[], object], iters: int = 1
                  ) -> Tuple[List[str], List[str], Optional[float]]:
    """Run ``fn`` ``iters`` times under ``torch.profiler`` (CPU and CUDA
    activity). Returns the names of the host ops, the names of the CUDA
    kernels, and the ms per call the card spent in those kernels (None when
    the profiler saw no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = sorted({e.name for e in events
                  if e.device_type != torch.autograd.DeviceType.CUDA})
    ms = (sum(e.time_range.elapsed_us() for e in cuda) / iters / 1e3
          if cuda else None)
    return ops, sorted({e.name for e in cuda}), ms


def device_ms(fn: Callable[[], object], iters: int = 20) -> Optional[float]:
    """Mean ms per call that the card spends in ``fn``'s kernels (None when
    the profiler sees none)."""
    return profile_calls(fn, iters)[2]
