"""Profiling hooks (counterpart of ``lynx_tpu.profiling``): a
``torch.profiler`` trace, a per-call timer and a per-op time table.

Where a function's outputs are CUDA tensors, times are the device's: CUDA
events (``benchmarks/timing.cuda_ms``) and the profiler's device time;
where they are CPU tensors, the host's clock and the profiler's CPU time.
The JAX package's ``marginal_seconds_per_iter`` and ``chain_with_scalar``
(a fetch-latency cancellation for remotely attached TPUs) are not ported:
CUDA events time the card directly.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from lynx_tpu_torch import graphs
from lynx_tpu_torch.benchmarks.timing import cuda_ms, profiled_device_events


def _tensors(out) -> list:
    """The tensors among ``out``'s leaves (tuples, lists, dicts and
    NamedTuples nest)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for item in out for t in _tensors(item)]
    return []


def _on_card(out) -> bool:
    return any(t.is_cuda for t in _tensors(out))


@contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (every activity the
    build supports) and write it to ``log_dir/trace.json`` as a Chrome
    trace (``chrome://tracing``, Perfetto)."""
    from torch.profiler import profile, supported_activities

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=list(supported_activities())) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def benchmark(fn, *args, iters: int = 30, warmup: int = 2, graph: bool = True) -> float:
    """Steady-state seconds per call of ``fn(*args)``: CUDA events around
    ``iters`` calls when the outputs are CUDA tensors (device timeline, host
    launch cost included where the device waits on it), else the host's
    ``perf_counter``.

    With ``graph`` (the default) ``fn`` runs through ``graphs.graphed``, as
    the JAX package jits it: on CUDA arguments captured in the first warm-up
    call and replayed after (a function already graphed is taken as it is);
    ``graph=False`` times ``fn`` itself."""
    if graph and not isinstance(fn, graphs.GraphedFunction):
        fn = graphs.graphed(fn)
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if _on_card(out):
        return cuda_ms(lambda: fn(*args), iters=iters, warmup=0) / 1e3
    start = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - start) / iters


def device_op_profile(fn, *args, iters: int = 10, top: int = 20) -> list:
    """Per-op time of ``fn(*args)`` over ``iters`` calls under
    ``torch.profiler``, after warm-up.

    Where the outputs are CUDA tensors the rows are the device's kernels,
    memsets and copies (self device time); where they are CPU tensors, the
    CPU ops (self CPU time), as the JAX package's CPU rows are host events.

    :return: ``[{"name", "us_per_iter", "count_per_iter", "long_name"}]``
        sorted by descending time, at most ``top`` rows; ``long_name`` is
        the op's input shapes where the profiler recorded them.
    """
    from torch.profiler import ProfilerActivity, profile

    card = _on_card(fn(*args))
    if card:
        events, iters = profiled_device_events(lambda: fn(*args), iters)
    else:
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            for _ in range(iters):
                fn(*args)
        events = prof.key_averages(group_by_input_shape=True)

    rows = []
    for event in events:
        total = event.self_device_time_total if card else event.self_cpu_time_total
        shapes = getattr(event, "input_shapes", None)
        rows.append({
            "name": event.key,
            "us_per_iter": round(total / iters, 2),
            "count_per_iter": event.count / iters,
            "long_name": str(shapes) if shapes else "",
        })
    rows.sort(key=lambda row: row["us_per_iter"], reverse=True)
    return rows[:top]
