"""The traced run: ``torch.profiler`` over a fixed number of calls, and the
reduction of its trace to the device's busy time, its idle gaps, and the
device operations by name.

A profiler session on the card now and then loses part of its device events
(fault F3 of the program's records): ``LEAD_MARKERS`` marker kernels
(``torch.cuda._sleep``'s spin kernel) run before the calls and
``TAIL_MARKERS`` after them, and a session counts only when its first and
its last traced device events are markers; else it is taken again, at most
``SESSIONS`` times.  The traced window runs from the start of the calls'
first device operation to the end of their last."""

from __future__ import annotations

import collections
import sys
from dataclasses import dataclass, field

import torch

SESSIONS = 4
LEAD_MARKERS, TAIL_MARKERS = 64, 3
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
HOST_SPAN = "portbench."


@dataclass
class Trace:
    calls: int
    window_s: float
    busy_s: float
    device_ops: list  # [(name, seconds)], all device operations, summed by name
    idle_gaps: list = field(default_factory=list)  # [(what the host did, seconds)]


def _union(intervals):
    total, end = 0.0, float("-inf")
    merged = []
    for lo, hi in sorted(intervals):
        if lo > end:
            merged.append([lo, hi])
        elif hi > merged[-1][1]:
            merged[-1][1] = hi
        end = max(end, hi)
    for lo, hi in merged:
        total += hi - lo
    return total, merged


def reduce(device_events, host_events, calls):
    """A :class:`Trace` from device events ``(name, start_us, end_us)`` and
    host spans ``(name, start_us, end_us)``, or None if the markers show
    that the session lost events."""
    markers = [e for e in device_events if MARKER in e[0]]
    work = [e for e in device_events if MARKER not in e[0]]
    if not work:
        return None
    first, last = min(e[1] for e in work), max(e[2] for e in work)
    lead = [e for e in markers if e[2] <= first]
    tail = [e for e in markers if e[1] >= last]
    if not lead or not tail:
        return None
    lo, hi = first, last
    busy, merged = _union([(max(s, lo), min(t, hi)) for _, s, t in work if t > lo and s < hi])
    ops = collections.Counter()
    for name, s, t in work:
        ops[name] += (t - s) / 1e6
    gaps = []
    previous = lo
    for s, t in merged + [[hi, hi]]:
        if s > previous:
            gaps.append((previous, s))
        previous = max(previous, t)
    labelled = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        middle = (s + t) / 2
        covering = [h for h in host_events if h[1] <= middle <= h[2]]
        name = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "no host span"
        labelled.append((name, (t - s) / 1e6))
    return Trace(calls, (hi - lo) / 1e6, busy / 1e6, ops.most_common(), labelled)


def session(run_calls, calls):
    """One profiler session around ``run_calls(calls, span)``, reduced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        run_calls(calls, record_function)
        for _ in range(TAIL_MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    on_card = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for event in prof.events():
        interval = (event.name, event.time_range.start, event.time_range.end)
        if event.device_type != on_card:
            host.append(interval)
        elif not getattr(event, "is_user_annotation", False) and HOST_SPAN not in event.name:
            device.append(interval)  # a range's annotation on the device's timeline is no work
    return reduce(device, host, calls)


def traced(run_calls, calls):
    """The first whole session of ``calls`` calls (see the module's note)."""
    for attempt in range(SESSIONS):
        trace = session(run_calls, calls)
        if trace is not None:
            return trace
        print(f"torch.profiler: session {attempt + 1} lost its markers; tracing again",
              file=sys.stderr)
    raise RuntimeError(f"torch.profiler traced no whole session in {SESSIONS}")
