"""The instrumented phase of a traced run: the program's own spans
(``lynx_tpu_torch.profiling``) over a window of calls, on one clock.

The phase runs once a run, at the first reader that asks for it
(:func:`phase`), after the profiler's session and the readers listed before
it in ``BENCHMARK.json``.  It runs in a child process
(``python3 portbench/spans.py REQUEST``) that sets the cell up again from
the same seed: a process that has run a ``torch.profiler`` session launches
each replayed graph node at a higher host cost for the rest of its life (an
H100: about 0.25 us a node, 0.3-0.8 ms a call of these cells), which would
count in ``launch_ms`` and the screen's ``idle_ms``.  So the run's own
process, and what its other readers read (the untraced window, the trace,
the replayed graph, the memory peak), is left as it was.

In the child: set-up, then an untraced window of ``MIN_SECONDS`` (the
baseline against which tracing's cost is read); tracing on and one call,
which captures the program's graph again with stamps of its stages; an
anchor of the device's clock; ``max(trace_calls, MIN_SECONDS of calls)``
calls with ``profiling.span`` as the window's span (the harness's
``portbench.feed/call/wait`` become spans on the same clock); a second
anchor.  It fails where a call of the window captured, or the program's
replay counter does not count one replay a call.  A program without spans
(no ``profiling.tracing``) or a loop without a capture cache reads nothing.

Each metric is a mean a call over the window:

* ``key_ms``: host self time of ``graphs.key`` (flatten, key, lookup);
* ``launch_ms``: host self time of ``graphs.replay`` (copy in, replay,
  clones out);
* ``plan_ms``: device self time of ``track.plan`` (the maps and the plan's
  algebra, its kernels' spans excluded);
* ``kernel_ms``: device time of the ``kernel.*`` spans;
* ``idle_ms``: the device's idle time between consecutive replays, from one
  replay's last stamp to the next one's first (what runs between replays
  outside the graph, such as a feed's draw, counts in it)."""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.metrics.torch_ops_ms import PORT_KERNELS  # noqa: E402

#: The baseline's length and the instrumented window's least length, in
#: seconds of calls.
MIN_SECONDS = 2.0


@dataclass
class Phase:
    """The instrumented window's calls, its host spans and its device spans
    (``profiling.Span`` and ``profiling.DeviceSpan``, both on the host's
    clock in ns), the clocks' anchors, the program's counters over the
    window, and the untraced baseline before it."""

    calls: int
    seconds: float
    host: list
    device: list
    anchors: list = field(default_factory=list)  # [start, end] profiling.Anchor, on a card
    resolution_ns: int = 0
    losses: dict = field(default_factory=dict)  # profiling.stamp_losses()
    counters: dict = field(default_factory=dict)  # captures and replays in the window
    baseline: dict = field(default_factory=dict)  # the untraced window: calls, seconds, host
    span_ns: float = 0.0  # one span's host cost with tracing on, measured in the run

    def to_json(self):
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, text):
        from lynx_tpu_torch.profiling import Anchor, DeviceSpan, Span

        fields = json.loads(text)
        fields["host"] = [Span(*r) for r in fields["host"]]
        fields["device"] = [DeviceSpan(*r) for r in fields["device"]]
        fields["anchors"] = [Anchor(*a) for a in fields["anchors"]]
        return cls(**fields)

    def replays(self):
        """The replays whose stamps were read."""
        return sum(1 for d in self.device if d.parent < 0)

    def metrics(self):
        """``{metric: value}``; a metric with nothing to read is left out."""
        from lynx_tpu_torch import profiling

        out = {}
        host_own = profiling.self_times(self.host)
        names = {r.name for r in self.host}
        for metric, name in (("key_ms", "graphs.key"), ("launch_ms", "graphs.replay")):
            if name in names:
                out[metric] = sum(t for r, t in zip(self.host, host_own)
                                  if r.name == name) / 1e6 / self.calls
        replays = self.replays()
        if replays:  # device means are over the replays read (all, unless the ring lost some)
            device_own = profiling.self_times(self.device)
            kinds = {d.name for d in self.device}
            if "track.plan" in kinds:
                out["plan_ms"] = sum(t for d, t in zip(self.device, device_own)
                                     if d.name == "track.plan") / 1e6 / replays
            if any(k.startswith("kernel.") for k in kinds):
                out["kernel_ms"] = sum(d.end - d.start for d in self.device
                                       if d.name.startswith("kernel.")) / 1e6 / replays
            if replays > 1:
                gaps = profiling.replay_gaps(self.device)
                out["idle_ms"] = sum(b - a for a, b in gaps) / 1e6 / (replays - 1)
        return out

    def host_ms(self):
        """Host self time a call by span, longest first."""
        from lynx_tpu_torch import profiling

        by_span = collections.Counter()
        for r, own in zip(self.host, profiling.self_times(self.host)):
            by_span[r.name] += own / 1e6 / self.calls
        return by_span.most_common()

    def stage_ms(self):
        """Device self time a call by stage, longest first."""
        from lynx_tpu_torch import profiling

        by_stage = collections.Counter()
        for d, own in zip(self.device, profiling.self_times(self.device)):
            by_stage[d.name] += own / 1e6 / self.replays()
        return by_stage.most_common()

    def idle_by_span(self):
        """Idle ms a call between replays by the innermost host span over
        each interval's midpoint, longest first."""
        from lynx_tpu_torch import profiling

        gaps = profiling.replay_gaps(self.device)
        by_span = collections.Counter()
        for (a, b), name in zip(gaps, profiling.attribute(gaps, self.host, "no host span")):
            by_span[name] += (b - a) / 1e6 / (self.replays() - 1)
        return by_span.most_common()

    def longest_gaps(self, count=10):
        """The ``count`` longest idle intervals between replays, ``(ms, the
        innermost host span over its midpoint)``."""
        from lynx_tpu_torch import profiling

        gaps = sorted(profiling.replay_gaps(self.device), key=lambda g: g[0] - g[1])[:count]
        names = profiling.attribute(gaps, self.host, fallback="no host span")
        return [((b - a) / 1e6, name) for (a, b), name in zip(gaps, names)]

    def early_stamps(self):
        """Replays whose first stamp precedes the host's launch of them by
        more than the anchors' round trip: 0 where the clocks agree."""
        slack = max(a.round_trip for a in self.anchors) if self.anchors else 0
        return sum(1 for d in self.device if d.parent < 0 and d.start < d.launched - slack)


def phase(ctx):
    """The run's instrumented phase (measured at the first call, then kept
    on ``ctx``), or None where the program has no spans."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = measure(ctx)
        if ctx.program_spans is not None:
            report(ctx, ctx.program_spans)
    return ctx.program_spans


def measure(ctx):
    """The phase, measured in a child process on the run's cell and seed."""
    try:
        from lynx_tpu_torch import profiling
    except ImportError:
        return None
    loop = ctx.loop
    if not hasattr(profiling, "tracing") or loop.captures() is None:
        return None
    cell = loop.cell
    request = {"root": str(cell.root), "workload": cell.name, "seed": loop.seed,
               "device": str(loop.device), "calls": ctx.calls, "seconds": MIN_SECONDS,
               "overrides": {"config": cell.cfg, "traffic": cell.traffic}}
    done = subprocess.run([sys.executable, str(Path(__file__).resolve()), json.dumps(request)],
                          cwd=cell.root, stdout=subprocess.PIPE, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"the instrumented phase failed (exit code {done.returncode})")
    last = done.stdout.strip().splitlines()[-1]
    return None if last == "null" else Phase.from_json(last)


def one_call(loop):
    loop.feed()
    loop.call()
    loop.wait()
    harness.synchronize(loop.device)


def span_cost(profiling, count=10_000):
    """One span's host ns with tracing on (its records then cleared)."""
    start = time.perf_counter_ns()
    for _ in range(count):
        with profiling.span("portbench.span_cost"):
            pass
    cost = (time.perf_counter_ns() - start) / count
    profiling.clear_spans()
    return cost


def run(loop, baseline, least_calls, seconds):
    """The instrumented window on ``loop``, set up and past its ``baseline``
    window; None where the program has no spans or the loop no cache."""
    from lynx_tpu_torch import profiling

    cache = loop.captures()
    if not hasattr(profiling, "tracing") or cache is None or not hasattr(cache, "replays"):
        return None
    card = loop.device.type == "cuda"
    calls = max(least_calls, math.ceil(seconds * baseline.calls / baseline.seconds))
    with profiling.tracing(True):
        one_call(loop)
        captures, replays = cache.captures, cache.replays
        cost = span_cost(profiling)
        start = profiling.anchor(loop.device) if card else None
        window = harness.run_window(loop, calls=calls, span=profiling.span)
        end = profiling.anchor(loop.device) if card else None
        host = profiling.spans()
        device = profiling.device_spans(start, end) if card else []
        captured, replayed = cache.captures - captures, cache.replays - replays
    if captured or (card and replayed != window.calls):
        raise RuntimeError(
            f"{cache.name}: the instrumented window's {window.calls} calls captured {captured}"
            f" graphs and replayed {replayed}; each call must replay the graph its first call"
            " captured")
    return Phase(window.calls, window.seconds, host, device, [start, end] if card else [],
                 profiling.timer_resolution(loop.device) if card else 0,
                 profiling.stamp_losses(), {"captures": captured, "replays": replayed},
                 {"calls": baseline.calls, "seconds": baseline.seconds, "host": baseline.host},
                 cost)


def report(ctx, phase, out=sys.stderr):
    """The phase on standard error: cost, stages, idle intervals, clocks."""
    def say(message):
        print(f"program spans: {message}", file=out, flush=True)

    def mean_ms(values):
        return 1e3 * sum(values) / len(values) if values else float("nan")

    per_call = 1e3 * phase.seconds / phase.calls
    base = phase.baseline
    untraced = 1e3 * base["seconds"] / base["calls"]
    say(f"{phase.calls} instrumented calls, {per_call:.4f} ms a call against {untraced:.4f} ms"
        f" untraced before them (tracing's cost {100 * (per_call / untraced - 1):.2f}%)")
    metrics = phase.metrics()
    say("metrics " + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
    inside = [(r.end - r.start) / 1e9 for r in phase.host if r.name == "portbench.call"]
    say(f"key_ms + launch_ms {metrics.get('key_ms', 0) + metrics.get('launch_ms', 0):.6f};"
        f" host ms inside a call: instrumented {mean_ms(inside):.6f}, untraced before them"
        f" {mean_ms(base['host']):.6f}; a span costs {phase.span_ns:.0f} ns on the host")
    say("host self ms a call by span: "
        + ", ".join(f"{name} {ms:.6f}" for name, ms in phase.host_ms()))
    if not phase.device:
        return
    say("device self ms a call by stage: "
        + ", ".join(f"{name} {ms:.6f}" for name, ms in phase.stage_ms()))
    profiled = sum(s for name, s in getattr(ctx.trace, "device_ops", [])
                   if any(k in name for k in PORT_KERNELS))
    say(f"the profiler's device ms a call of the port's kernels {1e3 * profiled / ctx.calls:.6f}")
    say("idle ms a call between replays by host span: "
        + ", ".join(f"{name} {ms:.6f}" for name, ms in phase.idle_by_span()))
    say("longest idle intervals between replays (ms, host span): "
        + ", ".join(f"{ms:.6f} {name}" for ms, name in phase.longest_gaps()))
    from lynx_tpu_torch import profiling

    start, end = phase.anchors
    say(f"anchors: round trips {start.round_trip} and {end.round_trip} ns, drift"
        f" {profiling.drift(start, end)} ns over {(end.host - start.host) / 1e9:.3f} s, timer"
        f" resolution {phase.resolution_ns} ns; replays stamped before their launch"
        f" {phase.early_stamps()}")
    say(f"stamp losses {phase.losses}; counters over the window {phase.counters}")


def main(request):
    """The child: set-up, baseline and instrumented window; the phase as
    one JSON line (``null`` where nothing is read) on standard output."""
    import torch

    request = json.loads(request)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    cell = harness.find_cell(request["root"], request["workload"], request["overrides"])
    device = torch.device(request["device"])
    if device.type == "cuda":
        from lynx_tpu_torch import _build

        _build.build_libraries(cell.traffic.get("kernels", []) + ["span_stamp"])
    loop = harness.make_loop(cell, request["seed"], device)
    loop.setup()
    baseline = harness.run_window(loop, seconds=request["seconds"])
    result = run(loop, baseline, request["calls"], request["seconds"])
    print("null" if result is None else result.to_json(), flush=True)
    loop.release()
    harness.free_program()


if __name__ == "__main__":
    main(sys.argv[1])
