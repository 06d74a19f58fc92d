"""Capture once, replay on new values: the port's counterpart of ``jax.jit``
over the JAX package's pytrees (``lynx_tpu._module``).

``graphed(fn)`` returns a callable that flattens its arguments into tensor
leaves and a *structure key* (:func:`flatten`), the counterpart of a
treedef with its avals:

* a ``Segment``'s elements, in order, each with its class, its name, its
  buffers and its plain attributes (a screen's ``is_active``, ``binning``,
  ``resolution``, ``histogram_window``; readings excluded);
* a beam's type and its tensors;
* tuples (named ones too), lists and dicts of these;
* each tensor leaf's shape, dtype, device and ``requires_grad``; Python
  numbers, strings and ``None`` by value; any other object (a
  ``torch.Generator``) by identity.  A CUDA generator is registered with
  the graph (``CUDAGraph.register_generator_state``): a replay draws from
  its state at the replay, as an eager call would.

Names are structure, as in JAX's treedef: a ``Segment`` or element built
anew each call without a name gets a new generated name, so its key is new
and the call captures again.  Build it once and re-tune its fields, or
name it.  A graphed function keeps at most :data:`CACHE_SIZE` keys, the
least recently used evicted with a warning past that.

On CUDA leaves the first call for a key runs ``fn`` eagerly on a side
stream (the warm-up: it builds the kernels' libraries and tapes, which a
capture may not copy to the card) and then captures it in a
``torch.cuda.CUDAGraph``.  Every later call with that key copies the
current leaves into the graph's static inputs, replays it and returns
fresh outputs (clones), which the caller may keep across calls as it keeps
JAX arrays.  The forward-only graphs of one graphed function share one
memory pool: a replay's outputs are cloned before any other replay, on the
same stream.  Re-tuning a magnet with a tensor of the same shape and dtype
replays; a structural change captures again.  Where a leaf requires grad
(and grad mode is on), the forward and the backward are captured together
(``torch.cuda.make_graphed_callables``, a pool each: autograd keeps the
forward's tensors until the backward), so autograd flows through a replay
as ``jax.grad`` flows through ``jax.jit``.  The warm-ups leave the screen
read's fallback counters as they found them: a replay counts a read once,
as a JAX execution does.

A host sync inside ``fn`` (``.item()``, ``bool()`` of a tensor, a copy to
or from the host) makes the capture raise, as a tracer would in JAX: the
error is never caught and ``fn`` never runs eagerly on the card instead.

On CPU leaves there is no graph: the same key and cache count the
"captures", and ``fn`` runs eagerly under :func:`capturing`, so that the
CPU computes what the graph computes.  :func:`host_read_guard` rehearses a
capture's refusals on the CPU, for the tests and before a first capture.

A training step (parameters and optimizer state updated in place, a carry
threaded from step to step, as a ``lax.scan`` carry) is captured by
:class:`CapturedStep` and kept by key in a :class:`StepCache`: the tuner
(``tuning``) and PPO's update (``examples/ppo_ares_ea``) use both.
``metrics.emit_metrics`` inside a graphed function or step writes a record
the capture owns; the host logs it after each replay (JAX's
``jax.debug.callback``).  The active mesh (``with mesh:``) is part of every
key: a graph captured inside a mesh holds its collectives.  So is whether
the program's spans are traced (``profiling.tracing``): a graph captured
while tracing is on holds stamps of its stages (``profiling.StampBook``),
one captured while it is off holds none.  The host spans of a call:
``graphs.key`` (flatten, key, lookup), ``graphs.replay`` (the copy in, the
replay, the clones out) and ``graphs.capture``.  Each cache counts its
``captures`` and its ``replays``.

Kernel launch counters (``window_histogram.launches`` and the like) count
the launches *issued* from Python: the warm-up's and the capture's, never a
replay's.  A replay's kernels are counted from the graph
(:func:`graph_kernel_count`) or from the profiler
(``benchmarks/timing.device_launches``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import os
import tempfile
import time
import warnings
import weakref
from typing import Any, Callable, List, Tuple

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

from lynx_tpu_torch import _collectives, metrics, profiling

__all__ = ["CapturedStep", "capturing", "counters_kept", "flatten", "graphed", "host_read_guard",
           "HostReadError", "make_capturable", "release", "StepCache"]

Tensor = torch.Tensor

_STATE = {"capturing": 0, "host": 0}
#: Eager runs of a function on the card before its capture: the first
#: builds the kernels' libraries and tapes, the second runs as the capture
#: will, on warm caches.
WARMUP = 2
#: Structure keys a graphed function keeps (on the card, their graphs).
CACHE_SIZE = 8
#: Optimizers whose step runs captured (``capturable=True``) and whose fresh
#: state is zeros, so that a warm-up's step can be undone in place.
CAPTURABLE = (torch.optim.Adam, torch.optim.AdamW)
#: The capture's ``cudaStreamCaptureMode``: only this thread's unsafe calls
#: fail it, so that other threads (NCCL's watchdog, which queries its
#: collectives' events) run on while a step with collectives is captured.
CAPTURE_MODE = "thread_local"
#: Every graphed function and step cache, for :func:`release`.
_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def capturing() -> bool:
    """True while a graphed function is being warmed up, captured or (on the
    CPU) run: what decides on values in eager code (a cavity's
    ``is_active``) then takes the path that serves every value, as JAX's
    traced code does."""
    return _STATE["capturing"] > 0


@contextlib.contextmanager
def capture_scope():
    """Mark the enclosed code as captured (see :func:`capturing`)."""
    _STATE["capturing"] += 1
    try:
        yield
    finally:
        _STATE["capturing"] -= 1


# -- host reads ----------------------------------------------------------------


class HostReadError(RuntimeError):
    """A graphed function read a tensor's value on the host, or copied host
    data to its device: a CUDA graph capture refuses both."""


_HOST_READS = {
    Tensor.item, Tensor.tolist, Tensor.numpy, Tensor.cpu, Tensor.__bool__, Tensor.__int__,
    Tensor.__float__, Tensor.__index__, Tensor.__complex__, Tensor.nonzero, torch.nonzero,
    Tensor.masked_select, torch.masked_select, torch.unique, Tensor.unique,
    torch.unique_consecutive, Tensor.unique_consecutive, torch.argwhere, Tensor.argwhere,
}
_HOST_DATA = {torch.tensor, torch.as_tensor}
_INDEXING = {Tensor.__getitem__, Tensor.__setitem__}


def _name(func) -> str:
    return getattr(func, "__qualname__", getattr(func, "__name__", repr(func)))


@contextlib.contextmanager
def host_side():
    """Mark the enclosed code as the host's side of a graph, outside the
    captured function (logging a replay's metric records): the
    :func:`host_read_guard` lets its reads pass."""
    _STATE["host"] += 1
    try:
        yield
    finally:
        _STATE["host"] -= 1


class _HostReadGuard(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _STATE["host"]:
            return func(*args, **kwargs)
        if func in _HOST_READS:
            raise HostReadError(
                f"{_name(func)} reads a tensor on the host inside a graphed function; a CUDA"
                " graph capture refuses it (return the tensor instead)"
            )
        if func in _HOST_DATA and args and not isinstance(args[0], Tensor):
            device = kwargs.get("device", args[2] if len(args) > 2 else None)
            if device is not None and device != "cpu":  # "cpu" spelled out stays on the host
                raise HostReadError(
                    f"{_name(func)} copies host data to a device inside a graphed function;"
                    " a CUDA graph capture refuses it (make the tensor before, or with"
                    " torch.full / torch.zeros on the device)"
                )
        if func in _INDEXING and len(args) > 1:
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, Tensor) and i.dtype == torch.bool for i in index):
                raise HostReadError(
                    "a boolean mask index sizes its result on the host inside a graphed"
                    " function; a CUDA graph capture refuses it (use torch.where)"
                )
        return func(*args, **kwargs)


def host_read_guard():
    """A mode under which the host reads and host-to-device copies that a
    CUDA graph capture refuses raise :class:`HostReadError` on any device:
    the CPU's rehearsal of a capture (entered by the tests, and by the
    smoke run before its first capture; never by the port itself)."""
    return _HostReadGuard()


@contextlib.contextmanager
def counters_kept():
    """Run eager warm-ups without counting them: the screen read's fallback
    counters (``ops.histogram``) are put back, in place, as they were
    (a graph holds their addresses; one made inside starts at zero).  The
    caller has synchronised the warm-ups' stream before leaving."""
    from lynx_tpu_torch.ops import histogram

    saved = {device: counter.clone() for device, counter in histogram._COUNTERS.items()}
    try:
        yield
    finally:
        for device, counter in histogram._COUNTERS.items():
            if device in saved:
                counter.copy_(saved[device])
            else:
                counter.zero_()


# -- flattening -------------------------------------------------------------------

_PRIMITIVES = (type(None), bool, int, float, complex, str, bytes, torch.dtype, torch.device)
#: nn.Module bookkeeping, stored readings and an aperture's lost particles
#: (the last eager track's): not part of an element's structure.
_NOT_STRUCTURE = frozenset(vars(nn.Module())) | {
    "reading", "cached_reading", "_read_beam", "lost_mask", "_last_particles", "_last_charges"}


class _Identity:
    """An object keyed by identity (and kept alive by the key)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Identity) and other.obj is self.obj


def _static_value(value):
    """A plain attribute as part of a key: primitives and tuples of them by
    value, anything else by identity."""
    if isinstance(value, _PRIMITIVES):
        return value
    if isinstance(value, tuple):
        return tuple(_static_value(v) for v in value)
    return _Identity(value)


def _flatten(tree, leaves: List[Tensor]):
    """``(key, build)``: ``build(iterator of leaves)`` makes ``tree`` again
    from new leaves, in the order this call appended them."""
    from lynx_tpu_torch.accelerator.element import Element
    from lynx_tpu_torch.accelerator.segment import Segment
    from lynx_tpu_torch.particles import Beam

    if isinstance(tree, Tensor):
        leaves.append(tree)
        key = ("tensor", tuple(tree.shape), tree.dtype, str(tree.device), tree.requires_grad)
        return key, lambda it: next(it)
    if isinstance(tree, _PRIMITIVES):
        return ("const", type(tree), tree), lambda it: tree
    if isinstance(tree, Segment):
        parts = [_flatten(element, leaves) for element in tree.elements]
        cls, name = type(tree), tree.name
        return (("segment", cls, name, tuple(k for k, _ in parts)),
                lambda it: cls([build(it) for _, build in parts], name=name))
    if isinstance(tree, Element):
        if tree._parameters:
            raise TypeError(f"graphed: {type(tree).__name__} {tree.name!r} holds parameters")
        names = [n for n, b in tree._buffers.items() if b is not None]
        parts = [_flatten(tree._buffers[n], leaves) for n in names]
        static = tuple(sorted(
            (n, _static_value(v)) for n, v in vars(tree).items() if n not in _NOT_STRUCTURE
        ))
        key = ("element", type(tree), tuple(zip(names, (k for k, _ in parts))), static)
        return key, lambda it: tree.replace(**{n: build(it) for n, (_, build) in zip(names, parts)})
    if isinstance(tree, Beam):
        items = list(vars(tree).items())
        parts = [_flatten(v, leaves) for _, v in items]
        cls = type(tree)

        def build_beam(it):
            beam = cls.__new__(cls)
            beam.__dict__.update({n: build(it) for (n, _), (_, build) in zip(items, parts)})
            return beam

        return ("beam", cls, tuple((n, k) for (n, _), (k, _) in zip(items, parts))), build_beam
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a named tuple
        parts = [_flatten(v, leaves) for v in tree]
        cls = type(tree)
        return (("namedtuple", cls, tuple(k for k, _ in parts)),
                lambda it: cls(*(build(it) for _, build in parts)))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v, leaves) for v in tree]
        cls = type(tree)
        return (("sequence", cls, tuple(k for k, _ in parts)),
                lambda it: cls(build(it) for _, build in parts))
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k], leaves) for k in keys]
        cls = type(tree)
        return (("dict", cls, tuple(zip(keys, (k for k, _ in parts)))),
                lambda it: cls((k, build(it)) for k, (_, build) in zip(keys, parts)))
    return ("object", _Identity(tree)), lambda it: tree


def _generators(key) -> List[torch.Generator]:
    """The CUDA generators among a key's objects (kept by identity)."""
    if isinstance(key, _Identity):
        obj = key.obj
        return [obj] if isinstance(obj, torch.Generator) and obj.device.type == "cuda" else []
    if isinstance(key, tuple):
        return [g for part in key for g in _generators(part)]
    return []


def flatten(tree) -> Tuple[List[Tensor], tuple, Callable[[List[Tensor]], Any]]:
    """``(leaves, key, rebuild)``: the tensor leaves of ``tree``, its
    structure key (equal keys: the same structure with leaves of the same
    shapes, dtypes, devices and ``requires_grad``) and ``rebuild(leaves)``,
    which makes the same structure around other leaves (elements through
    ``Element.replace``: plain attributes shared)."""
    leaves: List[Tensor] = []
    key, build = _flatten(tree, leaves)

    def rebuild(new_leaves):
        return build(iter(new_leaves))

    return leaves, key, rebuild


def mesh_key() -> "_Identity":
    """The active mesh (``with mesh:``, or none), part of every structure
    key: a function captured inside a mesh holds its collectives, one
    captured outside holds none."""
    return _Identity(_collectives._groups["mesh"])


def run_eagerly(fn: Callable, *args, **kwargs):
    """``fn`` run as a graph form runs on the CPU: eagerly under
    :func:`capturing`, its metric records logged when it returns (outside
    the function, as a replay's are)."""
    with capture_scope(), metrics.recording() as records:
        out = fn(*args, **kwargs)
    with host_side():
        metrics.log_records(records)
    return out


# -- a captured training step ---------------------------------------------------------


def optimizer_step(optimizer) -> None:
    """``optimizer.step()`` in a step's graph form.  On the card the
    optimizer runs capturable (no host read).  On the CPU, where torch's
    optimizers cannot run capturable, Adam reads its own step count on the
    host: the host-read guard lets that read pass as the host's side."""
    on_card = any(p.is_cuda for group in optimizer.param_groups for p in group["params"])
    with profiling.span("optimizer.step"), contextlib.nullcontext() if on_card else host_side():
        optimizer.step()


def make_capturable(optimizer) -> None:
    """Set Adam or AdamW ``capturable`` (any other optimizer raises
    ``TypeError``, naming itself), its step counts on the parameters' device
    in the parameters' precision: a capturable Adam forms its bias
    corrections from its step tensor, which torch makes float32 (a float64
    parameter would take them 2e-6 off the eager Adam's, which forms them
    in double on the host).  A fresh state is made here as Adam makes it."""
    if not isinstance(optimizer, CAPTURABLE):
        raise TypeError(
            f"captured step: {type(optimizer).__name__} does not run captured; use"
            " torch.optim.Adam or AdamW, or graph=False"
        )
    for group in optimizer.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            state = optimizer.state[p]
            dtype = torch.float64 if p.dtype == torch.float64 else torch.float32
            if not state:
                state["step"] = torch.zeros((), dtype=dtype, device=p.device)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                if group["amsgrad"]:
                    state["max_exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            elif isinstance(state.get("step"), Tensor):  # kept by an eager run
                state["step"] = state["step"].to(p.device, dtype)


def _optimizer_state(optimizer) -> dict:
    """``{parameter: {name: copy}}`` of the optimizer's state tensors."""
    if optimizer is None:
        return {}
    return {p: {k: v.clone() for k, v in optimizer.state[p].items() if isinstance(v, Tensor)}
            for group in optimizer.param_groups for p in group["params"]}


def _put_back(optimizer, kept: dict) -> None:
    """The optimizer's state tensors as :func:`_optimizer_state` kept them,
    in place; those made since are zeroed (a fresh Adam or AdamW state is
    zeros)."""
    for p, old in kept.items():
        for k, v in optimizer.state[p].items():
            if not isinstance(v, Tensor):
                continue
            if k in old:
                v.copy_(old[k])
            else:
                v.zero_()


class CapturedStep:
    """One step of a training loop captured once and replayed: the
    counterpart of a jitted step over the carry a ``lax.scan`` threads.

    ``step()`` takes no arguments: it runs on tensors the caller keeps (the
    graph's static inputs: parameters, the optimizer's state, the carried
    observations and states), writes what it carries to the next step into
    them in place, and returns its outputs.

    On ``device`` CUDA the constructor makes the ``optimizer`` capturable
    (:func:`make_capturable`: any but Adam and AdamW raises), runs ``step``
    once on a side stream (the warm-up: kernels built, tapes and index
    tensors made, the optimizer's state allocated, NCCL communicators
    created by the first collective), then puts back, in place, the tensors
    of ``keep`` (the parameters and the carry), the optimizer's state
    (zeros where the warm-up made it), the state of each generator (the
    device's default one and ``generators``, the CUDA ``torch.Generator``s
    the step draws from) and the screen read's fallback counters, calls
    ``reset()``, drops the gradients and captures one step.  The generators
    are registered with the graph: a replay draws from their state then, as
    an eager step would.  A call replays the graph, queues the step's
    metric records for logging (``metrics.enqueue``) and returns the
    captured outputs: the graph's own tensors, which the next replay
    rewrites.

    On the CPU a call runs ``step()`` eagerly under :func:`capturing` and
    logs its metric records when it returns (:func:`run_eagerly`).

    ``capture_seconds`` is the warm-up and capture's host time; ``cache``
    the :class:`StepCache` that keeps the step (it counts the replays), or
    None; ``book`` the graph's stamps (captured while tracing), or None.
    """

    def __init__(self, step: Callable[[], Any], device, keep=(), optimizer=None,
                 generators=(), reset: Callable[[], None] = None):
        self.step = step
        self.graph = None
        self.outputs = None
        self.records: list = []
        self.capture_seconds = None
        self.cache = None
        self.book = None
        device = torch.device(device)
        if device.type == "cuda":
            if optimizer is not None:
                make_capturable(optimizer)
            self._capture(device, list(keep), optimizer, generators, reset)

    def _capture(self, device, keep, optimizer, generators, reset) -> None:
        with profiling.span("graphs.capture"):
            self._capture_step(device, keep, optimizer, generators, reset)

    def _capture_step(self, device, keep, optimizer, generators, reset) -> None:
        default = torch.cuda.default_generators[
            device.index if device.index is not None else torch.cuda.current_device()]
        saved = [default]
        for g in generators:
            if not any(g is s for s in saved):
                saved.append(g)
        registered = saved[1:]  # the default generator is the capture's own
        if registered and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise TypeError("CapturedStep: this torch cannot register a generator with a graph")
        start = time.perf_counter()
        kept = [t.detach().clone() for t in keep]
        kept_state = _optimizer_state(optimizer)
        states = [g.get_state() for g in saved]
        with counters_kept():
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), capture_scope():
                self.step()
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
        with torch.no_grad():
            for t, old in zip(keep, kept):
                t.copy_(old)
            if optimizer is not None:
                _put_back(optimizer, kept_state)
        for generator, state in zip(saved, states):
            generator.set_state(state)
        if reset is not None:
            reset()
        if optimizer is not None:
            optimizer.zero_grad(set_to_none=True)  # the capture's backward makes the grads
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for graph_kernel_count
        for generator in registered:
            graph.register_generator_state(generator)
        book = profiling.stamp_book(device)
        with capture_scope(), metrics.recording() as records, \
                torch.cuda.graph(graph, capture_error_mode=CAPTURE_MODE), profiling.stamping(book):
            self.outputs = self.step()
        graph.instantiate()
        torch.cuda.synchronize(device)
        self.graph, self.records, self.book = graph, records, book
        self.capture_seconds = time.perf_counter() - start

    def __call__(self):
        if self.graph is None:
            return run_eagerly(self.step)
        with profiling.span("graphs.replay"):
            if self.book is not None:
                self.book.replayed()
            self.graph.replay()
            metrics.enqueue(self.records)
        if self.cache is not None:
            self.cache.replays += 1
        return self.outputs


# -- captures kept by key -------------------------------------------------------------


class _Captures:
    """Captures kept by structure key: at most :data:`CACHE_SIZE`, the least
    recently used evicted with a warning.  ``captures`` counts the keys seen,
    evicted ones included; ``replays`` the graphs' replays."""

    def __init__(self, name: str):
        self.name = name
        self.captures = 0
        self.replays = 0
        self._cache: collections.OrderedDict = collections.OrderedDict()
        _CACHES.add(self)

    def _entry(self, key, capture):
        """``key``'s cache entry, made by ``capture()`` where missing."""
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        with profiling.span("graphs.capture"):
            entry = self._cache[key] = capture()
        self.captures += 1
        if len(self._cache) > CACHE_SIZE:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()  # no replay of the evicted graph in flight
            self._cache.popitem(last=False)
            warnings.warn(
                f"{self.name}: {self.captures} structure keys captured, the least recently used"
                f" evicted (CACHE_SIZE {CACHE_SIZE}). A Segment or element built anew each call"
                " without a name keys anew each call: build it once and re-tune its fields, or"
                " name it.",
                stacklevel=3,
            )
        return entry

    def clear(self) -> None:
        """Drop every capture: the next call captures again."""
        self._cache.clear()


class StepCache(_Captures):
    """Captured training steps kept by key, as :func:`graphed` keeps its
    graphs: ``tuning.make_tuner``'s and PPO's update's.  ``steps`` lists the
    kept steps, the most recently used last."""

    @property
    def steps(self) -> list:
        return [step for step, _ in self._cache.values()]

    def __call__(self, owners, tree, make: Callable, stale: Callable = None):
        """The step for ``owners`` (objects keyed by identity: the tuned
        parameters, a policy, a generator) and the structure of ``tree`` (a
        pytree of the step's inputs, :func:`flatten`) in the active mesh,
        with ``tree``'s leaves in its static inputs.  Where none is kept for
        that key, or ``stale(step)``, it is made by ``make(static,
        generators)``: ``static`` is ``tree`` around copies of its leaves
        (the graph's static inputs), ``generators`` the CUDA generators among
        ``owners`` and ``tree``, for :class:`CapturedStep`.  A kept step gets
        the current leaves copied into its static inputs, except those passed
        back as they are (a carry the step returned).  The step's
        :class:`CapturedStep` (``make``'s result, or its ``captured``)
        counts its replays in this cache's ``replays``."""
        with profiling.span("graphs.key"):
            leaves, tree_key, rebuild = flatten(tree)
            key = (tuple(_Identity(o) for o in owners), tree_key, mesh_key(),
                   profiling.enabled())
            if key in self._cache and stale is not None and stale(self._cache[key][0]):
                del self._cache[key]
            kept = key in self._cache

            def capture():
                static = [t.detach().clone() for t in leaves]
                step = make(rebuild(static), _generators(key))
                captured = step if isinstance(step, CapturedStep) else getattr(step, "captured",
                                                                               None)
                if captured is not None:
                    captured.cache = self
                return step, static

            step, static = self._entry(key, capture)
        if kept:
            with profiling.span("graphs.replay"):
                moved = [(s, t) for s, t in zip(static, leaves) if s is not t]
                if moved:
                    torch._foreach_copy_([s for s, _ in moved], [t.detach() for _, t in moved])
        return step


# -- the graphed callable ------------------------------------------------------------


class _FreshGradient(torch.autograd.Function):
    """The identity, whose backward hands on a copy of the gradient: a
    captured backward writes its gradients into static buffers that the
    next replay overwrites."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.clone()


def graph_kernel_count(graph: "torch.cuda.CUDAGraph", name: str = "", kind: str = "KERNEL") -> int:
    """Kernel nodes (``kind`` "MEMSET": memset nodes) of a captured graph
    whose node text (a kernel's mangled name among it) holds ``name``, from
    the graph's DOT dump (``CUDAGraph.debug_dump`` of a graph made with
    ``keep_graph=True``, as :func:`graphed` and :class:`CapturedStep` make
    them)."""
    with tempfile.TemporaryDirectory() as directory:
        path = os.path.join(directory, "graph.dot")
        graph.debug_dump(path)
        with open(path) as dump:
            statements = dump.read().split("];")
    return sum(1 for s in statements if kind in s and name in s)


class _Replay:
    """A captured graph: static inputs, static outputs and how to rebuild
    the outputs around fresh copies."""

    def __init__(self, graph, static, outputs, rebuild, records, book=None):
        self.graph, self.static, self.outputs, self.rebuild = graph, static, outputs, rebuild
        self.records = records  # metric records (metrics.emit_metrics) the capture made
        self.book = book  # the graph's stamps (profiling.StampBook), or None

    def __call__(self, leaves):
        with profiling.span("graphs.replay"):
            if self.static:
                torch._foreach_copy_(self.static, [t.detach() for t in leaves])
            if self.book is not None:
                self.book.replayed()
            self.graph.replay()
            metrics.enqueue(self.records)
            return self.rebuild([o.clone() for o in self.outputs])


class _GradReplay:
    """A forward and backward captured together (``make_graphed_callables``)."""

    def __init__(self, function, spec, records):
        self.function, self.spec, self.records = function, spec, records

    def __call__(self, leaves):
        with profiling.span("graphs.replay"):
            inputs = [_FreshGradient.apply(t) if t.requires_grad else t for t in leaves]
            outputs = self.function(*inputs)
            metrics.enqueue(self.records)
            return self.spec["rebuild"]([o.clone() for o in outputs])


class GraphedFunction(_Captures):
    """See :func:`graphed`.  ``captures`` counts the structure keys seen
    (graphs captured on the card, eager runs' keys on the CPU), evicted
    ones included; ``replays`` the calls on the card (each replays one
    graph); ``graphs`` lists the kept forward-only graphs, the most
    recently used last; ``capture_seconds`` the captures' seconds (host
    clock, warm-ups included), in order."""

    def __init__(self, fn: Callable):
        super().__init__(f"graphed {getattr(fn, '__qualname__', fn)!r}")
        self.fn = fn
        self._pool = None  # the forward-only graphs' memory pool
        self.capture_seconds: List[float] = []

    def clear(self) -> None:
        super().clear()
        self._pool = None

    @property
    def graphs(self) -> List["torch.cuda.CUDAGraph"]:
        return [e.graph for e in self._cache.values() if isinstance(e, _Replay)]

    def __call__(self, *args, **kwargs):
        with profiling.span("graphs.key"):
            leaves, key, rebuild = flatten((args, kwargs))
            devices = {t.device.type for t in leaves}
            if "cuda" in devices and devices != {"cuda"}:
                raise ValueError(
                    "graphed: the leaves mix CUDA and CPU tensors; move them to the card")
            grad = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
            key = (key, grad, mesh_key(), profiling.enabled())
            capture = (functools.partial(self._capture_key, leaves, rebuild, grad, key)
                       if "cuda" in devices else lambda: None)
            replay = self._entry(key, capture)
        if replay is None:  # CPU leaves: no graph
            return run_eagerly(self.fn, *args, **kwargs)
        self.replays += 1
        return replay(leaves)

    def _capture_key(self, leaves, rebuild, grad, key):
        start = time.perf_counter()
        if grad:
            entry = self._capture_grad(leaves, rebuild)
        else:
            entry = self._capture(leaves, rebuild, _generators(key))
        torch.cuda.synchronize()
        self.capture_seconds.append(time.perf_counter() - start)
        return entry

    def _call(self, rebuild, leaves):
        args, kwargs = rebuild(leaves)
        return self.fn(*args, **kwargs)

    def _capture(self, leaves, rebuild, generators=()) -> _Replay:
        """Warm up on a side stream and capture.  A CUDA generator among the
        arguments is put back after the warm-up and registered with the
        graph, so that each replay draws from its state then, as an eager
        call would."""
        if generators and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise TypeError("graphed: this torch cannot register a generator with a graph")
        device = leaves[0].device
        static = [t.detach().clone() for t in leaves]
        states = [g.get_state() for g in generators]
        with counters_kept():
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), capture_scope(), torch.no_grad():
                for _ in range(WARMUP):
                    self._call(rebuild, static)
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
        for generator, state in zip(generators, states):
            generator.set_state(state)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for graph_kernel_count
        for generator in generators:
            graph.register_generator_state(generator)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        book = profiling.stamp_book(device)
        with capture_scope(), metrics.recording() as records, torch.no_grad(), \
                torch.cuda.graph(graph, pool=self._pool, capture_error_mode=CAPTURE_MODE), \
                profiling.stamping(book):
            out = self._call(rebuild, static)
        graph.instantiate()
        outputs, _, out_rebuild = flatten(out)
        return _Replay(graph, static, outputs, out_rebuild, records, book)

    def _capture_grad(self, leaves, rebuild) -> _GradReplay:
        static = [t.detach().clone().requires_grad_(t.requires_grad) for t in leaves]
        spec = {}

        records: list = []

        def flat(*flat_leaves):
            # The capture's metric records are kept, the warm-ups' dropped.
            recorded = (metrics.recording() if torch.cuda.is_current_stream_capturing()
                        else contextlib.nullcontext([]))
            with capture_scope(), recorded as made:
                out = self._call(rebuild, list(flat_leaves))
            records.extend(made)
            outputs, _, spec["rebuild"] = flatten(out)
            return tuple(outputs)

        with counters_kept():  # make_graphed_callables synchronises after its warm-ups
            function = torch.cuda.make_graphed_callables(
                flat, tuple(static), num_warmup_iters=WARMUP, allow_unused_input=True
            )
        return _GradReplay(function, spec, records)


def graphed(fn: Callable) -> GraphedFunction:
    """``fn`` captured once per structure key and replayed (see the module's
    note)."""
    return GraphedFunction(fn)


def release() -> None:
    """Log the replays' pending metric lines (``metrics.flush``), then drop
    every graphed function's graphs and every step cache's steps, and the
    captured steps no longer referenced (a cycle through their step keeps
    them until a collection).  Call it before
    ``torch.distributed.destroy_process_group`` once graphs were captured
    inside ``with mesh:``: NCCL does not destroy a communicator while a
    graph that holds its collectives lives (on four H100s the destroy waited
    forever).  A later call captures again."""
    metrics.flush()
    for captures in list(_CACHES):
        captures.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
