"""Timers of work on the card: CUDA events around many calls, and the
device time that ``torch.profiler`` traces."""

from __future__ import annotations

import sys
import time

import torch

# A torch.profiler session on the card now and then traces only part of its
# device work, or none (python -m lynx_tpu_torch.benchmarks.profiler_sessions
# counts them on an NVIDIA H100 80GB HBM3 at 700 W): now and then a span of
# up to ~0.4 s is lost; some workloads, late in a long process, lose the
# first kernels of every session, however long the session waits first; a
# session of tens of thousands of device events can lose its last ones.  So LEAD_MARKERS marker kernels (torch.cuda._sleep's spin kernel)
# run before the calls, there to be lost, and TAIL_MARKERS after them, on
# their stream; a session counts only when its first and its last traced
# device event are markers.  Another is taken, at most PROFILER_SESSIONS in
# all, after a pause that grows with each one, over half the calls where no
# marker after them was traced; every other session also traces the host.
# PROFILER_TALLY counts the sessions of the process, and the most lead
# markers a whole one lost.
PROFILER_SESSIONS = 8
LEAD_MARKERS, TAIL_MARKERS = 64, 3
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
PROFILER_TALLY = {"whole": 0, "taken again": 0, "most lead markers lost": 0}


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


def trace_session(fn, iters: int = 1, host: bool = False):
    """One ``torch.profiler`` session of ``iters`` calls of ``fn``, with
    LEAD_MARKERS marker kernels before them and TAIL_MARKERS after (with
    ``host``, the host's activity traced too): ``(events, head, tail)``,
    the device events (kernels, memsets, copies) as ``key_averages()`` rows
    without the markers, and the markers traced before the calls' first
    device event and after their last."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=[*activities, ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        for _ in range(iters):
            fn()
        for _ in range(TAIL_MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    on_card = torch.autograd.DeviceType.CUDA
    starts = [(event.time_range.start, MARKER in event.name)
              for event in prof.events() if event.device_type == on_card]
    calls = [start for start, marker in starts if not marker]
    first, last = (min(calls), max(calls)) if calls else (float("inf"), float("-inf"))
    head = sum(marker and start < first for start, marker in starts)
    tail = sum(marker and start > last for start, marker in starts)
    events = [event for event in prof.key_averages()
              if event.device_type == on_card and MARKER not in event.key]
    return events, head, tail


def profiled_device_events(fn, iters: int = 1):
    """``(events, iters)``: the device events of ``iters`` calls of ``fn``
    (``trace_session``), after one warm-up call, from the first session
    with device time whose first and last traced device events are
    markers, and the calls it traced.  Each session taken again is noted on
    stderr; PROFILER_SESSIONS incomplete ones raise."""
    fn()
    torch.cuda.synchronize()
    for session in range(PROFILER_SESSIONS):
        events, head, tail = trace_session(fn, iters, host=bool(session % 2))
        if head and tail and sum(event.self_device_time_total for event in events) > 0:
            PROFILER_TALLY["whole"] += 1
            PROFILER_TALLY["most lead markers lost"] = max(
                PROFILER_TALLY["most lead markers lost"], LEAD_MARKERS - head)
            return events, iters
        PROFILER_TALLY["taken again"] += 1
        print(f"torch.profiler: session {session + 1} of {PROFILER_SESSIONS} ({iters} calls)"
              f" traced {head} of its {LEAD_MARKERS} markers before the calls and {tail} of"
              f" {TAIL_MARKERS} after them; tracing again", file=sys.stderr)
        time.sleep(0.1 * (session + 1))
        if not tail:
            iters = max(1, iters // 2)
        fn()
        torch.cuda.synchronize()
    raise RuntimeError(f"torch.profiler traced no whole session in {PROFILER_SESSIONS}")


def device_ms(fn, iters: int, kernel=None):
    """Milliseconds of device time per call of ``fn`` (all kernels it issues,
    summed), from ``torch.profiler``; with ``kernel``, also the time of the
    kernels whose name contains it."""
    events, iters = profiled_device_events(fn, iters)
    total_us = sum(event.self_device_time_total for event in events)
    if kernel is None:
        return total_us / iters / 1e3
    own_us = sum(event.self_device_time_total for event in events if kernel in event.key)
    return total_us / iters / 1e3, own_us / iters / 1e3


def device_launches(fn) -> dict:
    """``{name: count}`` of the device work one call of ``fn`` issues
    (kernels, memsets and copies), from ``torch.profiler``."""
    return {event.key: event.count for event in profiled_device_events(fn)[0]}
