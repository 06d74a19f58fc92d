"""Timers of work on the card: CUDA events around many calls, and the
device time that ``torch.profiler`` traces."""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the device timeline: CUDA events
    around ``iters`` calls back to back, after ``warmup`` calls (host launch
    cost included where the device waits on it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel=None):
    """Milliseconds of device time per call of ``fn`` (all kernels it issues,
    summed), from ``torch.profiler``; with ``kernel``, also the time of the
    kernels whose name contains it.  A profiling session now and then comes
    back empty, so an empty one is repeated; three empty ones raise."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [
            event for event in prof.key_averages()
            if event.device_type == torch.autograd.DeviceType.CUDA
        ]
        total_us = sum(event.self_device_time_total for event in events)
        if total_us > 0:
            break
    else:
        raise RuntimeError("torch.profiler traced no device time in three sessions")
    if kernel is None:
        return total_us / iters / 1e3
    own_us = sum(event.self_device_time_total for event in events if kernel in event.key)
    return total_us / iters / 1e3, own_us / iters / 1e3
