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


class _Session:
    """A stand-in for ``torch.profiler.profile``: session i traces
    ``traces[i]``, ``(markers before, kernel launches, markers after)`` in
    that order on the device's clock, the kernel taking 2 us a launch;
    sessions past the list trace three markers on each side and two
    launches."""

    traces = []
    activities = []
    sleeps = []

    def __init__(self, activities):
        type(self).activities.append(list(activities))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _trace(self):
        session = len(type(self).activities) - 1
        return type(self).traces[session] if session < len(type(self).traces) else (3, 2, 3)

    def events(self):
        head, launches, tail = self._trace()
        names = ["spin_kernel"] * head + ["kernel_b1"] * launches + ["spin_kernel"] * tail
        return [type("Event", (), dict(name=name, time_range=type("Range", (), dict(start=t)),
                                       device_type=torch.autograd.DeviceType.CUDA))()
                for t, name in enumerate(names)]

    def key_averages(self):
        head, launches, tail = self._trace()
        rows = [("kernel_b1", launches, 2.0 * launches),
                ("at::cuda::spin_kernel(long)", head + tail, 1.0 * (head + tail))]
        return [type("Event", (), dict(key=key, count=count, self_device_time_total=us,
                                       device_type=torch.autograd.DeviceType.CUDA))()
                for key, count, us in rows if count]


def _fake_profiler(monkeypatch, traces):
    from lynx_tpu_torch.benchmarks import timing

    monkeypatch.setattr(_Session, "traces", traces)
    monkeypatch.setattr(_Session, "activities", [])
    monkeypatch.setattr(torch.profiler, "profile", _Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(_Session, "sleeps", [])
    monkeypatch.setattr(timing.time, "sleep", _Session.sleeps.append)
    monkeypatch.setattr(timing, "PROFILER_TALLY", {"whole": 0, "taken again": 0,
                                                   "most lead markers lost": 0})
    return timing


def test_an_incomplete_profiler_session_is_taken_again(monkeypatch):
    """Sessions that trace nothing, or no marker before or after the calls
    (with or without some of the calls' events), are taken again, every
    other one tracing the host too; the first whole session gives the
    counts and times, the markers left out.  A session whose first markers
    went untraced but not all of them is whole."""
    incomplete = [(0, 0, 0), (0, 2, 3), (3, 2, 0), (0, 1, 0), (3, 0, 3)]
    timing = _fake_profiler(monkeypatch, [*incomplete, (1, 2, 3)])
    calls = []
    assert timing.device_launches(lambda: calls.append(1)) == {"kernel_b1": 2}
    assert len(_Session.activities) == len(incomplete) + 1
    cpu = torch.profiler.ProfilerActivity.CPU
    assert [cpu in a for a in _Session.activities] == [False, True, False, True, False, True]
    # the warm-up, a call a traced session, a call after each incomplete one
    assert len(calls) == 1 + 2 * len(incomplete) + 1
    assert timing.PROFILER_TALLY == {"whole": 1, "taken again": 5,
                                     "most lead markers lost": timing.LEAD_MARKERS - 1}
    assert timing.device_ms(lambda: None, 2, kernel="b1") == (0.002, 0.002)


def test_a_session_that_lost_its_end_traces_half_the_calls(monkeypatch):
    """No marker after the calls: the next session traces half of them
    (at least one), and per-call times divide by the calls of the whole
    session (4 calls in the third, 2 launches of 2 us); the pause before
    each session taken again grows."""
    timing = _fake_profiler(monkeypatch, [(3, 8, 0), (0, 4, 3)])
    calls = []
    assert timing.device_ms(lambda: calls.append(1), 8) == 4.0 / 4 / 1e3
    assert len(calls) == 1 + 8 + 1 + 4 + 1 + 4
    assert _Session.sleeps == [0.1, 0.2]


def test_profiler_sessions_that_stay_incomplete_raise(monkeypatch):
    timing = _fake_profiler(monkeypatch, [(0, 0, 0), (3, 3, 0)] * 10)
    try:
        timing.device_ms(lambda: None, 3)
    except RuntimeError as error:
        assert "no whole session" in str(error)
    else:
        raise AssertionError("incomplete profiler sessions gave a time")
    assert len(_Session.activities) == timing.PROFILER_SESSIONS
