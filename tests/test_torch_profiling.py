"""Profiling hooks of the port: ``tests/test_profiling.py``'s cases on the
CPU, where the outputs' device picks the host clock and CPU ops."""

import json
import pathlib

import torch

from lynx_tpu_torch import profiling
from lynx_tpu_torch.profiling import benchmark, device_op_profile, trace


def test_benchmark_returns_positive_seconds():
    x = torch.arange(1024.0)
    seconds = benchmark(lambda x: (x * 2).sum(), x, iters=5, warmup=1)
    assert 0 < seconds < 10


def test_benchmark_times_cpu_outputs_on_the_host(monkeypatch):
    """CPU outputs, however nested, never reach the CUDA-event timer."""
    def no_card(*args, **kwargs):
        raise AssertionError("CUDA events timed CPU outputs")

    monkeypatch.setattr(profiling, "cuda_ms", no_card)
    x = torch.ones(16)
    seconds = benchmark(lambda x: {"a": (x, [x + 1]), "b": 3}, x, iters=3, warmup=0)
    assert seconds > 0


def test_trace_writes_profile(tmp_path):
    with trace(str(tmp_path)):
        torch.arange(16.0).sum()
    produced = list(pathlib.Path(tmp_path).rglob("*"))
    assert produced, "profiler trace produced no files"
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("aten::sum" in event.get("name", "") for event in events)


def test_device_op_profile_returns_attributed_rows():
    rows = device_op_profile(
        lambda x: torch.sin(x) @ x.T, torch.ones((128, 128)), iters=3, top=8
    )
    assert rows, "no trace events collected"
    assert all({"name", "us_per_iter", "count_per_iter", "long_name"} <= set(r) for r in rows)
    assert all(r["us_per_iter"] >= 0 for r in rows)
    times = [r["us_per_iter"] for r in rows]
    assert times == sorted(times, reverse=True)
    names = {r["name"] for r in rows}
    assert {"aten::sin", "aten::mm"} <= names
    assert len(rows) <= 8
    assert next(r for r in rows if r["name"] == "aten::sin")["count_per_iter"] == 1.0
