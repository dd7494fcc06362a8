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

from typing import Callable, Dict, List, Optional, Tuple

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


def _profiled(fn: Callable[[], object], iters: int):
    """(all profiler events, the CUDA kernels' events) of ``iters`` calls of
    ``fn`` after one call outside the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    # a user annotation (``Optimizer.step#AdamW.step``) also shows as a
    # range on the card's timeline, over kernels that are listed already
    return events, [e for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)]


def profile_calls(fn: Callable[[], object], iters: int = 1
                  ) -> Tuple[List[str], List[str], Optional[float]]:
    """Run ``fn`` ``iters`` times under ``torch.profiler`` (CPU and CUDA
    activity). Returns the names of the host ops, the names of the CUDA
    kernels, and the ms per call the card spent in those kernels (None when
    the profiler saw no kernel)."""
    events, cuda = _profiled(fn, iters)
    ops = sorted({e.name for e in events
                  if e.device_type != torch.autograd.DeviceType.CUDA})
    ms = (sum(e.time_range.elapsed_us() for e in cuda) / iters / 1e3
          if cuda else None)
    return ops, sorted({e.name for e in cuda}), ms


def kernel_ms(fn: Callable[[], object], iters: int = 1
              ) -> Tuple[Dict[str, float], float]:
    """({CUDA kernel name: ms per call the card spends in it}, largest
    first; kernels launched per call) over ``iters`` calls of ``fn`` under
    ``torch.profiler``."""
    _, cuda = _profiled(fn, iters)
    total: Dict[str, float] = {}
    for e in cuda:
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
    ranked = sorted(total.items(), key=lambda kv: -kv[1])
    return ({name: us / iters / 1e3 for name, us in ranked},
            len(cuda) / iters)


def kernel_ms_by_op(fn: Callable[[], object], iters: int = 1
                    ) -> Dict[str, float]:
    """{host op that launched them: ms per call the card spends in its
    kernels}, largest first, over ``iters`` calls of ``fn`` under
    ``torch.profiler`` (each kernel counts for the innermost op around its
    launch: ``aten::bmm``, ``aten::index_copy``, ...)."""
    events, _ = _profiled(fn, iters)
    total: Dict[str, float] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        us = sum(k.duration for k in e.kernels)
        if us:
            total[e.name] = total.get(e.name, 0.0) + us
    ranked = sorted(total.items(), key=lambda kv: -kv[1])
    return {name: us / iters / 1e3 for name, us in ranked}


def device_ms(fn: Callable[[], object], iters: int = 20) -> Optional[float]:
    """Mean ms per call that the card spends in ``fn``'s kernels (None when
    the profiler sees none)."""
    return profile_calls(fn, iters)[2]


def launch_ms(fn: Callable[[], object], iters: int = 20
              ) -> Tuple[Optional[float], int]:
    """For an ``fn`` that launches one kernel a call: (the mean ms of the
    kernel records the profiler kept, None without any; their number, of
    ``iters``). Where the profiler keeps fewer records than the calls
    launched, ``device_ms``'s sum over the calls reads low; this mean
    does not."""
    _, cuda = _profiled(fn, iters)
    if not cuda:
        return None, 0
    return (sum(e.time_range.elapsed_us() for e in cuda) / len(cuda) / 1e3,
            len(cuda))
