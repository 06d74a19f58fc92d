"""The program's spans (``profiling.span``, ``profiling.tracing``) and the
stamps they put into captured graphs.

On the CPU: what tracing off leaves as it was, how spans nest, that tracing
is part of every structure key, the stamp book driven through the host
build of ``csrc/span_stamp.cu`` (a captured graph stands in as the list of
stamp launches its capture made, replayed in order), ring overflow, gap
attribution on made-up intervals, and the spans in ``profiling.trace``'s
Chrome trace.  Marked ``card``: the stamps against CUDA events around B3,
and two replays in flight.  This file imports no JAX: on the card run it
alone, without the suite's conftest,

    python3 -m pytest tests/test_torch_spans.py --noconftest -m card -q
"""

import ctypes
import json
import shutil
import subprocess

import pytest
import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch import _build, graphs, profiling, tuning


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no spans kept."""
    profiling.tracing(False)
    profiling.clear_spans()
    yield
    profiling.tracing(False)
    profiling.clear_spans()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def segment(k1=4.2):
    def a(value):
        return torch.tensor([value])

    return ltt.Segment([ltt.Drift(length=a(0.5), name="d1"),
                        ltt.Quadrupole(length=a(0.2), k1=a(k1), name="q1"),
                        ltt.Drift(length=a(0.5), name="d2")], name="seg")


def beam(device="cpu"):
    return ltt.ParameterBeam.from_parameters(sigma_x=torch.tensor([1e-4]),
                                             energy=torch.tensor([1e8]), device=device)


def graphed_call():
    """A graphed track: ``(call, captures)``."""
    track = graphs.graphed(ltt.functional.track)
    lattice, incoming = segment(), beam()
    return (lambda: track(lattice, incoming)), (lambda: track.captures)


def tuner_call():
    """A tuner step (a ``StepCache``): ``(call, captures)``."""
    params = [torch.tensor([4.2], requires_grad=True)]
    lattice, incoming = segment(), beam()

    def loss_fn(params, lattice, incoming):
        lattice.elements[1].k1 = params[0]
        return ltt.functional.track(lattice, incoming)[0].sigma_x.sum()

    tuner = tuning.make_tuner(torch.optim.Adam(params, lr=1e-3), loss_fn)
    return (lambda: tuner(params, 1, lattice, incoming)), (lambda: tuner.cache.captures)


CALLS = {"graphed": graphed_call, "tuner": tuner_call}


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_tracing_off_records_nothing_and_keys_as_before(kind):
    call, captures = CALLS[kind]()
    assert profiling.span("graphs.key") is profiling.span("track.plan")  # one object, no record
    for _ in range(3):
        call()
    assert profiling.spans() == [] and captures() == 1
    assert profiling.stamp_book("cpu") is None


def test_spans_nest_with_parents_calls_and_self_times():
    profiling.tracing(True)
    with profiling.span("call"):
        with profiling.span("a"):
            with profiling.span("a.inner"):
                pass
        with profiling.span("b"):
            pass
    with profiling.span("next"):
        pass
    records = profiling.spans()
    assert [r.name for r in records] == ["call", "a", "a.inner", "b", "next"]
    assert [r.parent for r in records] == [-1, 0, 1, 0, -1]
    assert [r.call for r in records] == [0, 0, 0, 0, 4]
    assert all(r.start <= r.end for r in records)
    own = profiling.self_times(records)
    duration = [r.end - r.start for r in records]
    assert own[0] == duration[0] - duration[1] - duration[3]
    assert own[1] == duration[1] - duration[2]
    assert own[2] == duration[2] and own[4] == duration[4]
    profiling.clear_spans()
    assert profiling.spans() == []


def test_tracing_is_a_context_and_a_call():
    with profiling.tracing(True):
        assert profiling.enabled()
        with profiling.tracing(False):
            assert not profiling.enabled()
        assert profiling.enabled()
    assert not profiling.enabled()
    profiling.tracing(True)
    assert profiling.enabled()


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_tracing_on_is_a_new_key_and_off_the_old_one(kind):
    call, captures = CALLS[kind]()
    call()
    assert captures() == 1
    with profiling.tracing(True):
        call()
        assert captures() == 2
        call()
        assert captures() == 2
    call()
    assert captures() == 2
    names = {r.name for r in profiling.spans()}
    assert {"graphs.key", "graphs.capture", "track.plan"} <= names


# -- stamps: the host build of the kernel ---------------------------------------------


@pytest.fixture(scope="module")
def host_stamp_library(tmp_path_factory):
    """``csrc/span_stamp.cu`` compiled as host C++ against the kernels'
    stand-in ``cuda_runtime.h``."""
    from test_torch_kernels_host import STAND_IN, host_source

    compiler = shutil.which("g++")
    assert compiler, "the host build of the kernels needs g++"
    root = tmp_path_factory.mktemp("span_stamp")
    (root / "cuda_runtime.h").write_text(STAND_IN)
    (root / "span_stamp.cpp").write_text(host_source((_build.CSRC / "span_stamp.cu").read_text()))
    target = root / "libspan_stamp.so"
    subprocess.run([compiler, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{root}",
                    "-o", str(target), str(root / "span_stamp.cpp")],
                   check=True, capture_output=True, text=True)
    library = ctypes.CDLL(str(target))
    for function, (restype, argtypes) in profiling._STAMP_SIGNATURE.items():
        getattr(library, function).restype = restype
        getattr(library, function).argtypes = argtypes
    return library


class FakeGraph:
    """A captured graph on the CPU: the stamp launches its capture made,
    run again in order at each replay, through the host build."""

    def __init__(self, library):
        self.library, self.launches = library, []

    def stamp(self, library, ring, counter, slot, slots, rows, advance, device):
        self.launches.append((ring, counter, slot, slots, rows, advance))

    def replay(self, book):
        book.replayed()
        for ring, counter, slot, slots, rows, advance in self.launches:
            code = self.library.lynx_span_stamp(ring.data_ptr(), counter.data_ptr(), slot, slots,
                                                rows, advance, None)
            assert code == 0


def capture(monkeypatch, library, body):
    """``body()`` captured with tracing on into a fake graph: ``(graph, book)``."""
    graph = FakeGraph(library)
    monkeypatch.setattr(profiling, "_stamp", graph.stamp)
    monkeypatch.setattr(profiling, "stamp_library", lambda: library)
    profiling.tracing(True)
    book = profiling.stamp_book("cpu")
    with profiling.stamping(book):
        body()
    return graph, book


def stage():
    with profiling.span("env.step"):
        with profiling.span("track.plan"):
            with profiling.span("kernel.moment_sweep"):
                pass


def test_stamps_read_back_per_replay(monkeypatch, host_stamp_library):
    graph, book = capture(monkeypatch, host_stamp_library, lambda: [stage(), stage()])
    assert [s[0] for s in book.spans] == ["replay"] + ["env.step", "track.plan",
                                                       "kernel.moment_sweep"] * 2
    assert len(graph.launches) == 2 * len(book.spans)
    profiling.clear_spans()
    for _ in range(3):
        graph.replay(book)
    device = profiling.device_spans()
    assert len(device) == 3 * len(book.spans)
    assert [d.replay for d in device] == [r for r in range(3) for _ in book.spans]
    for replay in range(3):
        rows = [d for d in device if d.replay == replay]
        root = rows[0]
        assert root.name == "replay" and root.parent == -1
        for d in rows[1:]:
            parent = device[d.parent]
            assert parent.replay == replay and parent.start <= d.start <= d.end <= parent.end
        assert root.launched <= root.start
    assert all(a.end <= b.start for a, b in zip(device, device[len(book.spans):])
               if a.name == b.name == "replay")
    assert profiling.device_spans() == []  # read once
    assert profiling.stamp_losses() == {"overflow": 0, "lost": 0}
    assert int(book.counter) == 3


def test_ring_overflow_is_counted(monkeypatch, host_stamp_library):
    monkeypatch.setattr(profiling, "STAMP_SLOTS", 6)
    monkeypatch.setattr(profiling, "STAMP_ROWS", 2)
    graph, book = capture(monkeypatch, host_stamp_library, lambda: [stage(), stage()])
    # Five slots for enters and exits, the sixth the root's exit: two spans
    # whole, and the one entered in the fifth slot cannot close.
    assert book.overflow > 0 and book.spans[0][3] == 5
    profiling.clear_spans()
    for _ in range(5):
        graph.replay(book)
    device = profiling.device_spans()
    assert {d.replay for d in device} == {3, 4}
    assert profiling.stamp_losses() == {"overflow": book.overflow, "lost": 3}
    assert all(d.end >= d.start for d in device)


def test_anchor_and_mapping_onto_the_host_clock():
    start = profiling.Anchor(host=1_000, device=10_000, round_trip=40)
    end = profiling.Anchor(host=2_100, device=11_000, round_trip=30)
    assert profiling.drift(start, end) == 100
    assert profiling.to_host(10_000, start) == 1_000
    assert profiling.to_host(10_500, start, end) == 1_550
    assert profiling.to_host(11_000, start, end) == 2_100


def test_gaps_are_put_down_to_the_innermost_host_span():
    D, S = profiling.DeviceSpan, profiling.Span
    device = [D("replay", 100, 200, -1, 0, 90), D("track.plan", 110, 150, 0, 0, 90),
              D("replay", 260, 300, -1, 1, 240), D("replay", 300, 380, -1, 2, 290),
              D("replay", 500, 520, -1, 3, 480)]
    gaps = profiling.replay_gaps(device)
    assert gaps == [(200, 260), (380, 500)]
    host = [S("portbench.call", 180, 400, -1, 0), S("graphs.key", 215, 235, 0, 0),
            S("graphs.replay", 236, 250, 0, 0), S("portbench.wait", 401, 430, -1, 3)]
    assert profiling.attribute(gaps, host, "no span") == ["graphs.key", "no span"]
    assert profiling.attribute([(402, 420)], host) == ["portbench.wait"]
    assert profiling.attribute([(0, 10)], host) == [None]


def test_the_chrome_trace_holds_the_program_spans(tmp_path):
    track = graphs.graphed(ltt.functional.track)
    lattice, incoming = segment(), beam()
    with profiling.tracing(True), profiling.trace(str(tmp_path)):
        track(lattice, incoming)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {event.get("name", "") for event in events}
    assert {"graphs.key", "graphs.capture", "track.plan"} <= names


# -- on the card ----------------------------------------------------------------------


def b3_sweep(B, device="cuda"):
    """``sweep(mu, cov)``: B3 through a drift-quadrupole-drift plan of B
    settings (float32), and its moments."""
    from lynx_tpu_torch.accelerator import fused
    from lynx_tpu_torch.ops import fused_track

    generator = torch.Generator(device=device).manual_seed(0)
    k1 = 1 + torch.rand(B, generator=generator, device=device)
    elements = [ltt.Drift(length=torch.tensor([0.5], device=device)),
                ltt.Quadrupole(length=torch.tensor([0.2], device=device), k1=k1),
                ltt.Drift(length=torch.tensor([0.5], device=device))]
    energy = torch.full((B,), 1e8, device=device)
    plan = fused.plan_run([fused.element_map_builder(e) for e in elements], energy,
                          lambda x: torch.broadcast_to(x, (B,)).reshape(B))
    mu = torch.zeros((B, 7), device=device)
    mu[:, 6] = 1
    cov = torch.eye(7, device=device).expand(B, 7, 7).contiguous() * 1e-8

    def sweep(mu, cov):
        with torch.no_grad():
            return fused_track.fused_moment_sweep_plan(plan, energy, mu, cov)

    return sweep, mu, cov


class TimedLibrary:
    """B3's library with CUDA events recorded just before and after each
    launch: the eager twin of the ``kernel.moment_sweep`` span's stamps."""

    def __init__(self, library):
        self.library, self.times = library, []

    def __getattr__(self, name):
        return getattr(self.library, name)

    def lynx_moment_sweep(self, *args):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        code = self.library.lynx_moment_sweep(*args)
        events[1].record()
        self.times.append(events)
        return code


@pytest.mark.card
def test_stamps_around_b3_agree_with_cuda_events(card, monkeypatch):
    from lynx_tpu_torch.ops import fused_track

    sweep, mu, cov = b3_sweep(1 << 20)
    sweep(mu, cov)
    timed = TimedLibrary(fused_track.moment_sweep_library())
    with monkeypatch.context() as patch:
        patch.setattr(fused_track, "moment_sweep_library", lambda: timed)
        for _ in range(21):
            sweep(mu, cov)
        torch.cuda.synchronize()
    eager = sorted(a.elapsed_time(b) * 1e6 for a, b in timed.times)
    step = graphs.graphed(sweep)
    with profiling.tracing(True):
        step(mu, cov)
        profiling.clear_spans()
        for _ in range(21):
            step(mu, cov)
        device = profiling.device_spans()
    stamped = sorted(d.end - d.start for d in device if d.name == "kernel.moment_sweep")
    assert len(stamped) == 21 and len(eager) == 21
    assert stamped[10] == pytest.approx(eager[10], rel=0.1)


@pytest.mark.card
def test_two_replays_in_flight_keep_separate_stamps(card):
    cycles = 2_000_000  # about a millisecond at the H100's clock

    def spin(x):
        with profiling.span("kernel.spin"):
            torch.cuda._sleep(cycles)
        return x + 1

    step = graphs.graphed(spin)
    x = torch.zeros(1, device="cuda")
    with profiling.tracing(True):
        step(x)
        torch.cuda.synchronize()
        profiling.clear_spans()
        start = profiling.anchor()
        step(x)
        step(x)  # queued behind the first
        end = profiling.anchor()
        device = profiling.device_spans(start, end)
    roots = [d for d in device if d.name == "replay"]
    spins = [d.end - d.start for d in device if d.name == "kernel.spin"]
    assert [d.replay for d in roots] == [1, 2] and len(spins) == 2
    assert roots[0].end <= roots[1].start
    assert spins[0] > 100_000 and spins[0] == pytest.approx(spins[1], rel=0.2)
    slack = max(start.round_trip, end.round_trip)
    assert all(d.launched - slack <= d.start for d in roots)
