"""The readers of the program's spans (``portbench/spans.py``) on a made-up
phase, and the instrumented phase itself at small sizes on the CPU: it
leaves what the other readers read as it was."""

import pytest

from conftest import ROOT, SMALL
from portbench import harness, spans
from portbench.run import Context

CELLS = sorted(SMALL)
NAMES = [f"{metric}.{cell}" for metric in ("key_ms", "launch_ms", "plan_ms", "kernel_ms",
                                           "idle_ms") for cell in ("ppo", "read", "tune")]


def made_up_phase():
    """Two calls, on one clock in ns: host spans of the harness and the
    program, and each call's replay with a plan and a kernel inside it."""
    from lynx_tpu_torch.profiling import DeviceSpan, Span

    host = [Span("portbench.call", 0, 100_000, -1, 0), Span("graphs.key", 1_000, 21_000, 0, 0),
            Span("graphs.capture", 5_000, 9_000, 1, 0),
            Span("graphs.replay", 22_000, 52_000, 0, 0),
            Span("portbench.call", 200_000, 300_000, -1, 4),
            Span("graphs.key", 201_000, 211_000, 4, 4),
            Span("graphs.replay", 212_000, 232_000, 4, 4),
            Span("portbench.wait", 100_000, 199_000, -1, 7)]
    device = [DeviceSpan("replay", 60_000, 160_000, -1, 0, 23_000),
              DeviceSpan("track.plan", 70_000, 130_000, 0, 0, 23_000),
              DeviceSpan("kernel.moment_sweep", 100_000, 120_000, 1, 0, 23_000),
              DeviceSpan("replay", 220_000, 320_000, -1, 1, 213_000),
              DeviceSpan("track.plan", 230_000, 290_000, 3, 1, 213_000),
              DeviceSpan("kernel.moment_sweep", 260_000, 280_000, 4, 1, 213_000)]
    return spans.Phase(2, 0.3e-3, host, device)


def test_readers_on_a_made_up_phase():
    class Ctx:
        program_spans = made_up_phase()

    values = {name: harness.reader(ROOT, name)(Ctx()) for name in NAMES}
    for cell in ("ppo", "read", "tune"):
        assert values[f"key_ms.{cell}"] == pytest.approx((16e3 + 10e3) / 2 / 1e6)  # less capture
        assert values[f"launch_ms.{cell}"] == pytest.approx((30e3 + 20e3) / 2 / 1e6)
        assert values[f"plan_ms.{cell}"] == pytest.approx(40e3 / 1e6)  # 60 us less its kernel
        assert values[f"kernel_ms.{cell}"] == pytest.approx(20e3 / 1e6)
        assert values[f"idle_ms.{cell}"] == pytest.approx(60e3 / 1e6)  # 160 us to 220 us
    phase = Ctx.program_spans
    assert phase.longest_gaps() == [(pytest.approx(0.06), "portbench.wait")]
    assert dict(phase.stage_ms()) == pytest.approx(
        {"replay": 0.04, "track.plan": 0.04, "kernel.moment_sweep": 0.02})


def test_readers_read_nothing_without_the_programs_spans(monkeypatch):
    class Ctx:
        program_spans = None

    assert all(harness.reader(ROOT, name)(Ctx()) is None for name in NAMES)
    from lynx_tpu_torch import profiling

    monkeypatch.delattr(profiling, "tracing")  # a program from before spans

    class Older:
        loop = type("Loop", (), {"captures": lambda self: object()})()

    assert spans.phase(Older()) is None


@pytest.mark.parametrize("name", CELLS)
def test_the_phase_leaves_the_other_readers_inputs(monkeypatch, name):
    """At a small size on the CPU: the phase runs in a child process on the
    run's cell and seed, and the window, the trace, the capture cache and
    the graph a call replays (the last key used: tracing off) are what they
    were."""
    from lynx_tpu_torch import profiling

    monkeypatch.setattr(spans, "MIN_SECONDS", 0.0)
    cell = harness.find_cell(ROOT, name, SMALL[name])
    loop = harness.make_loop(cell, 2**31 + 5, "cpu")
    loop.setup()
    window = harness.run_window(loop, calls=2)
    host, seconds, calls = list(window.host), window.seconds, window.calls
    trace = type("Trace", (), {"calls": 2, "device_ops": []})()
    ctx = Context(loop, trace, window)
    nodes = ctx.graph_nodes()
    cache = loop.captures()
    captures, keys = cache.captures, list(cache._cache)
    phase = spans.phase(ctx)
    assert spans.phase(ctx) is phase  # once a run
    assert ctx.window is window and ctx.trace is trace
    assert (window.host, window.seconds, window.calls) == (host, seconds, calls)
    assert ctx.graph_nodes() == nodes
    assert (cache.captures, list(cache._cache)) == (captures, keys)
    assert keys[-1][-1] is False and not profiling.enabled()  # the key of tracing off
    assert phase.calls == 2 and phase.device == [] and phase.counters["captures"] == 0
    names = {r.name for r in phase.host}
    assert {"portbench.feed", "portbench.call", "portbench.wait", "graphs.key"} <= names
    assert "graphs.capture" not in names and phase.span_ns > 0
    assert "key_ms" in phase.metrics()
    assert spans.Phase.from_json(phase.to_json()) == phase
    loop.release()
    harness.free_program()
