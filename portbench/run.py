#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``lynx_tpu_torch``) on
NVIDIA GPUs: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Set-up builds the cell's kernels, makes its
inputs and weights on the card from the seed and runs the checked first
steps; then the window: calls back to back for ``--seconds``, which give the
end-to-end metrics (``--trace 0``); with ``--trace 1``, ``trace_calls`` more
calls under ``torch.profiler`` follow it, and the per-layer metrics are read
from both.  Once the window has closed, the
program's state is freed and the plain reference judges what the window's
path produced.  The last line of standard output is the result, one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.  Without a card, or with fewer
than the cell asks for, or with JAX loaded, it exits non-zero and prints no
result."""

import time

START = time.perf_counter()

import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "lynx_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_info():
    """The card's name, power limit, SM clock and temperature (nvidia-smi)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as error:
        return f"nvidia-smi unavailable ({error})"


def parse(argv):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def run_cell(root, name, seed, seconds, trace, device="cuda", overrides=None, log=print):
    """One run of cell ``name``: the result's dict (without ``device``'s
    card fields), and the numbers compared."""
    import torch

    from portbench import compare, harness, tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(root, name, overrides)
    build_s = 0.0
    if device == "cuda" and cell.traffic.get("kernels"):
        from lynx_tpu_torch import _build

        _build.build_libraries(cell.traffic["kernels"])
        for kernel in cell.traffic["kernels"]:
            if kernel in _build.BUILD_LOG:
                build_s += _build.BUILD_LOG[kernel][0]
                log(f"built {kernel} in {_build.BUILD_LOG[kernel][0]:.2f} s")
    loop = harness.make_loop(cell, seed, device)
    loop.setup()
    harness.synchronize(loop.device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - START
    log(f"set-up {setup_s:.6f} s, of which kernel builds {build_s:.6f} s"
        + (" (a cold run: the checkout's first)" if build_s else ""))
    result = {"attempted": 0, "failed": 0, "metrics": {}, "build_s": build_s}
    window = harness.run_window(loop, seconds=seconds)
    result["attempted"] = window.calls
    host = sorted(window.host)
    log(f"window: {window.calls} calls in {window.seconds:.6f} s; host ms inside a call: mean"
        f" {1e3 * sum(host) / len(host):.4f}, median {1e3 * host[len(host) // 2]:.4f}, max"
        f" {1e3 * host[-1]:.4f}")
    if trace:
        def run_calls(calls, span):
            return harness.run_window(loop, calls=calls, span=span)

        traced = tracing.traced(run_calls, cell.traffic["trace_calls"])
        result["attempted"] += traced.calls
        context = Context(loop, traced, window)
        for metric in cell.per_layer():
            value = harness.reader(root, metric["name"])(context)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        result["trace"] = traced
    else:
        values = dict(loop.end_to_end(window), setup_s=setup_s)
        for metric in cell.end_to_end():
            result["metrics"][metric["name"]] = {"value": values.pop(metric["name"]),
                                                 "unit": metric["unit"]}
        log(f"measured besides the cell's metrics: {values}")
    result["forbidden"] = forbidden_modules()
    cache = loop.captures()
    if cache is not None:
        seconds = ", ".join(f"{s:.6f}" for s in harness.capture_seconds(cache) if s is not None)
        log(f"captures: {cache.name!r} captured {cache.captures}, kept ones took {seconds} s")
    graph = harness.replayed_graph(loop)
    if graph is not None:
        from lynx_tpu_torch import graphs

        log(f"graph: {graphs.graph_kernel_count(graph)} kernel nodes a call")
    if loop.device.type == "cuda":
        result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(loop.device)
    loop.release()
    harness.free_program()
    log(f"program: failed calls {loop.failed()}"
        + (f"; B1 fallbacks {loop.fallbacks}" if hasattr(loop, "fallbacks") else ""))
    numbers = loop.check()
    result["failed"] = loop.failed()
    result["correct"], result["checks"] = compare.verdict(numbers, cell.limits)
    return result


class Context:
    """What a per-layer reader reads: the traced calls' device trace, the
    untraced window before them (its host spans inside each entry call: the
    profiler's own cost inflates a traced call's host time many times), the
    replayed graph and the call's least work."""

    def __init__(self, loop, trace, window):
        self.loop, self.trace, self.window = loop, trace, window

    @property
    def calls(self):
        return self.trace.calls

    def graph_nodes(self):
        from portbench import harness

        graph = harness.replayed_graph(self.loop)
        if graph is None:
            return None
        from lynx_tpu_torch import graphs

        return graphs.graph_kernel_count(graph)

    def work(self):
        return self.loop.work()


def main(argv=None):
    args = parse(argv)
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3

    def log(message):
        print(message, file=sys.stderr, flush=True)

    log(f"card: {card_info()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, args.trace, log=log)
    log(f"card after the window: {card_info()}")
    found = sorted(set(result.pop("forbidden")) | set(forbidden_modules()))
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 4
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": cell["chips"], "memory_peak_bytes": result["memory_peak_bytes"]},
            "build_s": result["build_s"]}
    if args.trace:
        traced = result["trace"]
        line["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        line["breakdown"] = {"device_ops": [list(op) for op in traced.device_ops[:10]],
                             "idle_gaps": [list(gap) for gap in traced.idle_gaps[:10]]}
    line["checks"] = result["checks"]
    for name, check in result["checks"].items():
        log(f"check {name}: {check['value']!r} (limit {check['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
