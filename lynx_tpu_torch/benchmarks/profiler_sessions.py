"""How often a ``torch.profiler`` session on the card traces only part of
its device work, and whether the marker kernels that ``timing.trace_session``
runs before and after the calls show it.

Runs ``--sessions`` sessions of ``--iters`` calls each, taking in turns two
workloads (a few PyTorch operations; kernel B1's windowed read of 100,000
particles onto the flagship's 2040 x 2448 image) and the two settings that
``timing.profiled_device_events`` takes in turns (the card alone; the host
and the card), with no retry, and prints one JSON line: for each workload
and setting, how many sessions traced each number of device events with
each number of markers before and after the calls (``"events, head,
tail"``), the empty ones (each as its number and its start in seconds
after the first), and ``whole``, the sessions that traced a marker before
and after the calls and every event a whole session traces (the most
often traced count), against ``marked``, all that traced a marker on both
sides; and the longest run of empty sessions in a row, with the seconds
from its first start to the next traced session's.

    python -m lynx_tpu_torch.benchmarks.profiler_sessions --sessions 4000 --iters 20
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from lynx_tpu_torch.benchmarks.timing import trace_session
from lynx_tpu_torch.ops import histogram as hist

BINS = (2040, 2448)
RANGES = (-3.4e-3, 3.4e-3, -4.1e-3, 4.1e-3)
PARTICLES = 100_000


def workloads():
    """``{name: fn}``: the two workloads, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 1e-4 * torch.randn((1, PARTICLES), generator=gen, device="cuda")
    y = 1e-4 * torch.randn((1, PARTICLES), generator=gen, device="cuda")
    weights = torch.ones_like(x)
    window = hist._window_shape((256, 256), *BINS)
    ops_input = torch.randn(1 << 20, generator=gen, device="cuda")
    return {
        "torch ops": lambda: (ops_input * 2.0 + 1.0).sum(),
        "B1 read": lambda: hist.windowed_read(x, y, weights, RANGES, BINS, window, True),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sessions", type=int, default=400)
    parser.add_argument("--iters", type=int, default=1)
    args = parser.parse_args(argv)
    settings = {"card": False, "host and card": True}
    fns = workloads()
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    traced = {f"{name}, {setting}": [] for name in fns for setting in settings}
    longest, run, first = {"sessions": 0, "seconds": 0.0}, [], time.perf_counter()
    for session in range(args.sessions):
        name = list(fns)[session % len(fns)]
        setting = list(settings)[session // len(fns) % len(settings)]
        start = time.perf_counter() - first
        events, head, tail = trace_session(fns[name], args.iters, host=settings[setting])
        count = sum(event.count for event in events)
        traced[f"{name}, {setting}"].append((session, round(start, 3), count, (head, tail)))
        if count == 0:
            run.append(start)
        elif run:
            if len(run) > longest["sessions"]:
                longest = {"sessions": len(run), "seconds": round(start - run[0], 3)}
            run = []
    record = {}
    for cell, sessions in traced.items():
        counts = [count for _, _, count, _ in sessions]
        whole = max(set(counts), key=counts.count)
        histogram = {}
        for _, _, count, (head, tail) in sessions:
            key = f"{count}, {head}, {tail}"
            histogram[key] = histogram.get(key, 0) + 1
        marked = [count for _, _, count, (head, tail) in sessions if head and tail]
        record[cell] = {
            "sessions": len(sessions), "events, head, tail": histogram,
            "empty": [[s, t] for s, t, count, _ in sessions if count == 0],
            "marked": len(marked), "whole": sum(count == whole for count in marked),
        }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"profiler_sessions": record, "iters": args.iters, "longest_empty_run": longest,
              "seconds": round(time.perf_counter() - first, 3), "torch": torch.__version__,
              "card": card}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
