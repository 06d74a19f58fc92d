"""Profiling hooks (counterpart of ``lynx_tpu.profiling``): a
``torch.profiler`` trace, a per-call timer, a per-op time table, and the
program's own spans.

Where a function's outputs are CUDA tensors, times are the device's: CUDA
events (``benchmarks/timing.cuda_ms``) and the profiler's device time;
where they are CPU tensors, the host's clock and the profiler's CPU time.
The JAX package's ``marginal_seconds_per_iter`` and ``chain_with_scalar``
(a fetch-latency cancellation for remotely attached TPUs) are not ported:
CUDA events time the card directly.

**Spans.** ``with span(name):`` marks a stage of the program.  Tracing is
off by default: a span is then one test of a module-level flag, and nothing
is recorded, allocated or launched.  ``tracing(True)`` turns it on, as a
call or as a context that puts the previous state back; no environment
variable or setting turns it on.  On, each span records its name, its start
and end (``time.perf_counter_ns``), its parent and its call (the index of
the outermost open span, which every span of one call shares) in a buffer
grown in chunks of :data:`CHUNK`; :func:`spans` returns the records,
:func:`self_times` each span's duration less its children's, and
:func:`clear_spans` empties the buffer.  While a ``torch.profiler`` session
is active each span also enters ``record_function(name)``, so that
:func:`trace`'s Chrome trace shows the program's spans over the kernels.

The program's spans.  On the host: ``graphs.key`` (flattening the
arguments, the structure key and the cache lookup), ``graphs.replay`` (the
copy into the static inputs, ``graph.replay()``, the metric records queued,
the outputs cloned), ``graphs.capture`` (warm-ups, capture, instantiate).
Inside captured code: ``replay`` (the whole captured region), ``env.step``
(``AresEATransverseTuning.batched_step``), ``env.observe`` (a particle
beam's observation, ``batched_particle_beam_parameters``: its plan of the
tuned maps over the settings runs as ``track.plan``), ``particle.center``
(``ops.fused_track.sweep_particle_moments``: the cloud's centre and its walk
through the plan), ``track.plan`` (a run of linear elements flushed, or a
particle observation's plan: maps, plan and their kernels), ``kernel.<name>`` (a
kernel's launch: ``moment_sweep`` B3, ``moment_sweep_bwd`` B4,
``window_histogram`` B1, ``particle_apply`` B2, ``particle_moment_sweep``
B5, ``packed_gram`` B6; ``kde`` and ``kde_bwd``, the screen's KDE image and
its backward, ``ops.kde``), ``reconstruct.generator`` (the GPSR beam
generator's forward, ``reconstruction``), ``backward`` and
``optimizer.step``.

**Stamps.** Whether tracing is on is part of every structure key of
``graphs``, as the active mesh is: turning it on captures new graphs, which
hold stamps; turning it off replays the old ones, which hold none.  A span
entered while a graph is captured with tracing on launches, at its enter
and at its exit, a one-thread kernel (``csrc/span_stamp.cu``) that writes
the device's ``%globaltimer`` into the graph's ring (:class:`StampBook`):
the stamp's slot in the graph, the row of the replay counter the graph keeps
on the device.  The graph's last stamp, the exit of ``replay``, advances the
counter: each replay writes a row of its own, however many are queued.
:func:`device_spans` reads the rows of the replays since the last
:func:`clear_spans` and puts them on the host's clock by two anchors
(:func:`anchor`: eager stamps between two ``perf_counter_ns`` reads, the
closest pair kept), one taken before the replays and one after; their
difference is the clocks' drift.  :func:`replay_gaps` gives the device's
idle intervals between consecutive replays and :func:`attribute` the
innermost host span over each one's midpoint.  Replays past the ring's
:data:`STAMP_ROWS` before a read, and stamps past a graph's
:data:`STAMP_SLOTS`, are counted (:func:`stamp_losses`), never silent.

An operator's use::

    from lynx_tpu_torch import profiling

    with profiling.tracing(True):
        step()                          # captures the stamped graph
        profiling.clear_spans()
        start = profiling.anchor()
        for _ in range(100):
            step()
        end = profiling.anchor()
    host = profiling.spans()            # graphs.key, graphs.replay, ...
    device = profiling.device_spans(start, end)  # replay, track.plan, kernel.*, ...
    host_self = profiling.self_times(host)
"""

from __future__ import annotations

import ctypes
import os
import time
import weakref
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

import torch

from lynx_tpu_torch import _build
from lynx_tpu_torch.benchmarks.timing import cuda_ms, profiled_device_events

#: Records the span buffer grows by.
CHUNK = 4096
#: Stamps one replay of a stamped graph can hold (the last kept for the exit
#: of its ``replay`` span).
STAMP_SLOTS = 512
#: Replays a stamped graph's ring holds before it wraps.
STAMP_ROWS = 4096

# One buffer and one stack of open spans for the process: a backward's
# kernels (and their spans) run on the autograd engine's device thread while
# the calling thread waits inside ``backward()``, so spans still nest.
_STATE = {"on": False, "count": 0, "book": None}
_RECORDS: list = [None] * CHUNK  # [name, start, end, parent, call] a span
_OPEN: List[int] = []  # indices of the open spans, innermost last
_BOOKS: list = []  # weak references to every stamp book, in capture order


class Span(NamedTuple):
    """A span on the host's clock (ns); ``parent`` and ``call`` index the
    same list (-1: none); ``end`` is -1 while the span is open."""

    name: str
    start: int
    end: int
    parent: int
    call: int


class DeviceSpan(NamedTuple):
    """A stamped span of one replay, on the host's clock (ns) where anchors
    were given, else on the device's; ``parent`` indexes the same list;
    ``replay`` counts the graph's replays; ``launched`` is the host's clock
    as the host launched that replay."""

    name: str
    start: int
    end: int
    parent: int
    replay: int
    launched: int


class Anchor(NamedTuple):
    """One eager stamp: the host's clock at the middle of its round trip,
    the device's stamp, and the round trip (ns)."""

    host: int
    device: int
    round_trip: int


class tracing:
    """``tracing(True)`` turns the program's spans on, ``tracing(False)``
    off; as a context it puts the previous state back on leaving."""

    def __init__(self, on: bool = True):
        self.previous = _STATE["on"]
        _STATE["on"] = bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _STATE["on"] = self.previous


def enabled() -> bool:
    """Whether tracing is on: part of every graph's structure key."""
    return _STATE["on"]


class _Off:
    """The span while tracing is off: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "index", "profiled", "stamp")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        index = _STATE["count"]
        if index == len(_RECORDS):
            _RECORDS.extend([None] * CHUNK)
        _STATE["count"] = index + 1
        parent = _OPEN[-1] if _OPEN else -1
        call = _RECORDS[parent][4] if parent >= 0 else index
        record = _RECORDS[index] = [self.name, 0, -1, parent, call]
        _OPEN.append(index)
        self.index = index
        self.profiled = None
        if torch.autograd._profiler_enabled():
            self.profiled = torch.profiler.record_function(self.name)
            self.profiled.__enter__()
        book = _STATE["book"]
        self.stamp = None if book is None else book.enter(self.name)
        record[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.stamp is not None:
            _STATE["book"].exit(self.stamp)
        if self.profiled is not None:
            self.profiled.__exit__(*exc)
        _RECORDS[self.index][2] = end
        _OPEN.pop()


def span(name: str):
    """A context marking a stage ``name`` (see the module's note): with
    tracing off it does nothing."""
    if not _STATE["on"]:
        return _OFF
    return _Span(name)


def spans() -> List[Span]:
    """The spans recorded since the last :func:`clear_spans`, in the order
    they were entered."""
    return [Span(*record) for record in _RECORDS[:_STATE["count"]]]


def clear_spans() -> None:
    """Empty the span buffer, and mark every stamped graph's replays so far
    as read.  Call it between calls, with no span open."""
    if _OPEN:
        raise RuntimeError(f"clear_spans: {len(_OPEN)} span(s) still open")
    _STATE["count"] = 0
    for book in _books():
        book.skip()


def self_times(records) -> List[int]:
    """Each span's duration less its children's (spans or device spans,
    children nested in their parent and disjoint), in ns."""
    own = [r.end - r.start for r in records]
    for r in records:
        if r.parent >= 0:
            own[r.parent] -= r.end - r.start
    return own


# -- stamps in captured graphs --------------------------------------------------

_STAMP_SIGNATURE = {
    "lynx_span_stamp": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]),
    "lynx_span_timer_resolution": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int,
                                                  ctypes.c_void_p]),
}


def stamp_library() -> ctypes.CDLL:
    """The stamp kernel's library, built with nvcc at first use."""
    return _build.load_library("span_stamp", _STAMP_SIGNATURE)


def _stamp(library, ring, counter, slot, slots, rows, advance, device) -> None:
    with torch.cuda.device(device):
        code = library.lynx_span_stamp(ring.data_ptr(), counter.data_ptr(), slot, slots, rows,
                                       advance, torch.cuda.current_stream(device).cuda_stream)
    _build.check(library, code, "span_stamp")


class StampBook:
    """A stamped graph's ring ``(STAMP_ROWS, STAMP_SLOTS)`` and replay
    counter on the device, made before its capture, and the spans its
    stamps bracket ``[name, parent, enter slot, exit slot]`` (the first,
    ``replay``, the root).  ``replays`` counts the replays the host
    launched, ``launched`` their host times since the last read;
    ``overflow`` the stamps that found no slot, ``lost`` the replays the
    ring overwrote before a read."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.library = stamp_library()
        self.ring = torch.zeros((STAMP_ROWS, STAMP_SLOTS), dtype=torch.int64, device=device)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.spans: list = []
        self.open: List[int] = []
        self.slots = 0
        self.overflow = 0
        self.replays = 0
        self.read = 0
        self.lost = 0
        self.launched: List[int] = []
        _BOOKS.append(weakref.ref(self))

    def _next(self, advance: int) -> int:
        slot = self.slots
        self.slots += 1
        _stamp(self.library, self.ring, self.counter, slot, STAMP_SLOTS, STAMP_ROWS, advance,
               self.device)
        return slot

    def enter(self, name: str) -> Optional[int]:
        if self.slots >= STAMP_SLOTS - 1:  # the last slot is the root's exit
            self.overflow += 1
            return None
        index = len(self.spans)
        self.spans.append([name, self.open[-1] if self.open else -1, self._next(0), -1])
        self.open.append(index)
        return index

    def exit(self, index: int) -> None:
        self.open.pop()
        if index == 0:
            self.spans[0][3] = self._next(1)  # the graph's last stamp advances the counter
        elif self.slots < STAMP_SLOTS - 1:
            self.spans[index][3] = self._next(0)
        else:
            self.overflow += 1

    def replayed(self) -> None:
        """Count a replay the host is launching (before ``graph.replay()``)."""
        self.replays += 1
        self.launched.append(time.perf_counter_ns())

    def skip(self) -> None:
        self.read = self.replays
        self.launched = []

    def rows(self):
        """``(first replay, ring rows)`` of the replays since the last read:
        the device synchronised, its counter checked against the host's."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        done = int(self.counter)
        if done != self.replays:
            raise RuntimeError(f"stamped graph: the device finished {done} replays, the host"
                               f" launched {self.replays}")
        first = max(self.read, self.replays - STAMP_ROWS)
        self.lost += first - self.read
        launched = self.launched[first - self.read:]
        rows = self.ring.cpu().tolist() if self.replays > first else []
        self.skip()
        return first, rows, launched


def stamp_book(device) -> Optional[StampBook]:
    """A stamp book for a graph about to be captured on ``device``, or None
    while tracing is off."""
    return StampBook(device) if _STATE["on"] else None


@contextmanager
def _stamping(book: StampBook):
    _STATE["book"] = book
    try:
        with span("replay"):
            yield book
    finally:
        _STATE["book"] = None


def stamping(book: Optional[StampBook]):
    """Inside a capture: the ``replay`` span around the captured region,
    every span entered in it stamped into ``book``; nothing where ``book``
    is None."""
    return _OFF if book is None else _stamping(book)


def _books() -> List[StampBook]:
    live = [ref() for ref in _BOOKS]
    _BOOKS[:] = [weakref.ref(book) for book in live if book is not None]
    return [book for book in live if book is not None]


def stamp_losses() -> dict:
    """Stamps that found no slot at capture (``overflow``) and replays the
    rings overwrote before a read (``lost``), over every live stamped graph."""
    books = _books()
    return {"overflow": sum(b.overflow for b in books), "lost": sum(b.lost for b in books)}


def _card(device) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if device is None else \
        torch.device(device)


def anchor(device=None, samples: int = 32) -> Anchor:
    """The device's clock against the host's: ``samples`` eager stamps, each
    between two ``perf_counter_ns`` reads around a launch and a
    synchronise, the one with the shortest round trip kept."""
    device = _card(device)
    library = stamp_library()
    out = torch.zeros((1, samples), dtype=torch.int64, device=device)
    counter = torch.zeros((), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device)
    trips = []
    for k in range(samples):
        torch.cuda.synchronize(device)
        before = time.perf_counter_ns()
        _stamp(library, out, counter, k, samples, 1, 0, device)
        stream.synchronize()
        trips.append((before, time.perf_counter_ns()))
    stamps = out[0].tolist()
    best = min(range(samples), key=lambda k: trips[k][1] - trips[k][0])
    before, after = trips[best]
    return Anchor((before + after) // 2, stamps[best], after - before)


def timer_resolution(device=None, changes: int = 64) -> int:
    """The device timer's smallest step (ns), read by one thread spinning
    on it until it changed ``changes`` times."""
    device = _card(device)
    library = stamp_library()
    out = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        code = library.lynx_span_timer_resolution(
            out.data_ptr(), changes, torch.cuda.current_stream(device).cuda_stream)
    _build.check(library, code, "span_timer_resolution")
    return int(out)


def drift(start: Anchor, end: Anchor) -> int:
    """How far the host's clock ran ahead of the device's between two
    anchors (ns)."""
    return (end.host - end.device) - (start.host - start.device)


def to_host(t: int, start: Anchor, end: Optional[Anchor] = None) -> int:
    """A device time on the host's clock: the anchors' offset, interpolated
    between them where both are given."""
    offset = start.host - start.device
    if end is not None and end.device != start.device:
        offset += drift(start, end) * (t - start.device) // (end.device - start.device)
    return t + offset


def device_spans(start: Optional[Anchor] = None, end: Optional[Anchor] = None
                 ) -> List[DeviceSpan]:
    """The stamped spans of every replay since the last :func:`clear_spans`
    (or read), graph by graph, each replay's in capture order; on the
    host's clock where ``start`` (and ``end``) are given."""
    out: List[DeviceSpan] = []
    for book in _books():
        first, rows, launched = book.rows()
        for replay in range(first, book.replays):
            row = rows[replay % STAMP_ROWS]
            places = {}
            for k, (name, parent, enter, exit_) in enumerate(book.spans):
                if exit_ < 0:
                    continue
                places[k] = len(out)
                t0, t1 = row[enter], row[exit_]
                if start is not None:
                    t0, t1 = to_host(t0, start, end), to_host(t1, start, end)
                out.append(DeviceSpan(name, t0, t1, places.get(parent, -1), replay,
                                      launched[replay - first]))
    return out


def replay_gaps(records) -> List[tuple]:
    """``(start, end)`` of the device's idle intervals between consecutive
    replays: from one replay's last stamp to the next one's first, over
    every stamped graph in time order."""
    roots = sorted((r for r in records if r.parent < 0), key=lambda r: r.start)
    return [(a.end, b.start) for a, b in zip(roots, roots[1:]) if b.start > a.end]


def attribute(intervals, host_records, fallback: Optional[str] = None) -> List[str]:
    """The innermost (shortest) host span over each interval's midpoint,
    by name; ``fallback`` where none covers it."""
    names = []
    for lo, hi in intervals:
        middle = (lo + hi) / 2
        covering = [r for r in host_records if r.start <= middle <= r.end]
        names.append(min(covering, key=lambda r: r.end - r.start).name if covering
                     else fallback)
    return names


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
    from lynx_tpu_torch import graphs

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
