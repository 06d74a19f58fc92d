#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card: the numbers
compared for sound runs of the program on many seeds (the lower readings),
and for the reference put in the program's place in TF32 (the control) and
with planted faults, on a few seeds (the upper readings).

    python3 portbench/readings.py --workload NAME --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--faults half_batch] [--seconds 2]

A training cell's program readings need no window; a served cell's take a
short one at the cell's load.  One JSON line a reading, then a summary: the
largest program reading and the smallest control and fault readings of
each number."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    import torch

    from portbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.find_cell(ROOT, args.workload)
    readings = {}

    def emit(kind, seed, numbers, detail):
        print(json.dumps({"kind": kind, "seed": seed, **numbers, "detail": detail}), flush=True)
        for name, value in numbers.items():
            readings.setdefault(kind, {}).setdefault(name, []).append(value)

    for seed in args.seeds:
        loop = harness.make_loop(cell, seed, args.device)
        loop.setup()
        if cell.traffic["loop"] == "screen":
            harness.run_window(loop, seconds=args.seconds)
        loop.release()
        harness.free_program()
        emit("program", seed, loop.check(), loop.detail)
    for seed in args.control_seeds:
        for kind in ["tf32", *filter(None, args.faults.split(","))]:
            emit(kind, seed, *harness.control(cell, seed, args.device, kind))
            harness.free_program()
    summary = {kind: {name: (max(values) if kind == "program" else min(values))
                      for name, values in numbers.items()}
               for kind, numbers in readings.items()}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
