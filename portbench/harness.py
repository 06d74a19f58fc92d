"""The benchmark's driver: finds a cell's configuration, traffic, limits
and per-layer readers by name, runs set-up, the measured window (or the
traced one) and the check, and assembles the result line.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``, whose
``loop`` names the general driver in ``loops/``); its limits are
``limits/<workload>.json``, and each per-layer metric is read by
``metrics/<metric name>.py``, or else by ``metrics/<name before the first
dot>.py``.  A new cell, mix, configuration or metric is new files and
entries only."""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import importlib.util
import json
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


def load_json(path):
    return json.loads(Path(path).read_text())


@dataclass
class Cell:
    """One workload with everything found for it."""

    root: Path
    bench: dict
    workload: dict
    cfg: dict
    traffic: dict
    limits: dict

    @property
    def name(self):
        return self.workload["name"]

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self.name in m.get("workloads", [self.name])]


def find_cell(root, name, overrides=None) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json``; ``overrides``
    (``{"config": {...}, "traffic": {...}}``) replaces entries, for tests at
    small sizes."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    workload = next(w for w in bench["workloads"] if w["name"] == name)
    config = next(c for c in bench["configs"] if c["name"] == workload["config"])
    cfg = load_json(root / config["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{workload['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return Cell(root, bench, workload, cfg, traffic, limits)


def reader(root, metric):
    """The per-layer metric's ``read(ctx)``: ``metrics/<name>.py`` or
    ``metrics/<name before the first dot>.py``."""
    folder = Path(root) / "portbench" / "metrics"
    for stem in (metric, metric.split(".")[0]):
        path = folder / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r} under {folder}")


class Loop:
    """A traffic mix's driver.  ``setup()`` builds the program's objects from
    the seed and runs the checked first steps; ``feed()`` prepares a call's
    inputs, ``call()`` makes the entry call, ``wait()`` waits where the
    client waits for its answer; ``in_flight`` calls may be outstanding on
    the device (``None``: the call's own wait bounds them).

    The check: set-up (or the window) leaves ``check_inputs``, the inputs
    of what is judged, and ``program_result``, what the program produced
    from them.  ``draw_check_inputs(cell, seed, device)`` draws the same
    inputs from the seed alone, ``reference(cell, inputs, device, dtype,
    fault)`` is the plain reference's result on them (in ``dtype``, or with
    a planted ``fault``), and ``judge(result, truth)`` gives the numbers
    compared and their detail: :meth:`check` and :func:`control` call the
    same three."""

    in_flight = 2
    units_per_call = 1

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.cfg, self.traffic = cell, cell.cfg, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.lattice_path = cell.root / self.cfg["lattice"]

    def setup(self):
        raise NotImplementedError

    def feed(self):
        pass

    def call(self):
        raise NotImplementedError

    def wait(self):
        pass

    def end_to_end(self, window) -> dict:
        raise NotImplementedError

    def failed(self) -> int:
        return 0

    def captures(self):
        """The program's cache of the graphs a call replays
        (``graphs.StepCache`` or ``graphs.GraphedFunction``), or None."""
        return None

    def work(self):
        """``(bytes, flops)`` the least a call's work needs, or None."""
        return None

    def release(self):
        """Drop the program's objects; keep what the check needs."""

    @staticmethod
    def draw_check_inputs(cell, seed, device) -> dict:
        raise NotImplementedError

    @staticmethod
    def reference(cell, inputs, device, dtype=torch.float64, fault=None):
        raise NotImplementedError

    @staticmethod
    def judge(result, truth):
        raise NotImplementedError

    def check(self) -> dict:
        """The numbers compared: the program's result against the
        reference's in float64 (their detail in ``self.detail``)."""
        truth = self.reference(self.cell, self.check_inputs, self.device)
        numbers, self.detail = self.judge(self.program_result, truth)
        return numbers


def loop_class(cell: Cell):
    return importlib.import_module(f"portbench.loops.{cell.traffic['loop']}").LOOP


def make_loop(cell: Cell, seed, device) -> Loop:
    return loop_class(cell)(cell, seed, device)


def control(cell: Cell, seed, device, kind):
    """``(numbers, detail)`` of the plain reference put in the program's
    place on ``seed``'s inputs, judged against the reference in float64:
    computed in TF32 (``kind="tf32"``, the control) or in float64 with a
    planted fault (``kind``, a fault the loop's reference knows)."""
    from portbench.reference import precision

    loop = loop_class(cell)
    inputs = loop.draw_check_inputs(cell, seed, device)
    truth = loop.reference(cell, inputs, device)
    if kind == "tf32":
        with precision.tf32():
            result = loop.reference(cell, inputs, device, torch.float32)
    else:
        result = loop.reference(cell, inputs, device, fault=kind)
    return loop.judge(result, truth)


def replayed_graph(loop: Loop):
    """The CUDA graph a call of ``loop`` replays: the most recently used one
    kept in the program's capture cache (``loop.captures()``); None where
    nothing is captured (the CPU, where the program runs its steps
    eagerly).  A cache on the card that keeps no graph is an error."""
    cache = loop.captures()
    if cache is None or loop.device.type != "cuda":
        return None
    kept = [step.graph for step in cache.steps] if hasattr(cache, "steps") else cache.graphs
    kept = [graph for graph in kept if graph is not None]
    if not kept:
        raise RuntimeError(f"{cache.name}: the cell's calls replay no kept graph")
    return kept[-1]


def capture_seconds(cache):
    """Host seconds of each capture kept in the program's ``cache``
    (warm-ups included)."""
    if hasattr(cache, "steps"):
        return [getattr(step, "captured", step).capture_seconds for step in cache.steps]
    return list(cache.capture_seconds)


@dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0
    host: list = field(default_factory=list)  # seconds inside each entry call
    latency: list = field(default_factory=list)  # seconds from issue to the answer


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(loop: Loop, seconds=None, calls=None, span=None) -> Window:
    """Call ``loop`` back to back for ``seconds`` of host time, or ``calls``
    times, and wait for the device; ``span(name)`` is a context manager
    that marks each call (the traced run's ``record_function``)."""
    span = span or (lambda name: contextlib.nullcontext())
    cuda = loop.device.type == "cuda"
    pending = collections.deque()
    window = Window()
    synchronize(loop.device)
    start = time.perf_counter()
    while True:
        with span("portbench.feed"):
            loop.feed()
        t0 = time.perf_counter()
        with span("portbench.call"):
            loop.call()
        t1 = time.perf_counter()
        with span("portbench.wait"):
            loop.wait()
            t2 = time.perf_counter()
            if cuda and loop.in_flight:
                event = torch.cuda.Event()
                event.record()
                pending.append(event)
                if len(pending) > loop.in_flight:
                    pending.popleft().synchronize()
        window.host.append(t1 - t0)
        window.latency.append(t2 - t0)
        window.calls += 1
        if calls is not None and window.calls >= calls:
            break
        if seconds is not None and t1 - start >= seconds:
            break
    synchronize(loop.device)
    window.seconds = time.perf_counter() - start
    return window


def percentile(values, q):
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def free_program():
    """Drop every captured graph of the program and return its memory."""
    from lynx_tpu_torch import graphs

    graphs.release()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
