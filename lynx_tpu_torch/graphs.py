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

Kernel launch counters (``window_histogram.launches`` and the like) count
the launches *issued* from Python: the warm-up's and the capture's, never a
replay's.  A replay's kernels are counted from the graph
(:func:`graph_kernel_count`) or from the profiler
(``benchmarks/timing.device_launches``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
import warnings
from typing import Any, Callable, List, Tuple

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

__all__ = ["capturing", "counters_kept", "flatten", "graphed", "host_read_guard", "HostReadError"]

Tensor = torch.Tensor

_STATE = {"capturing": 0}
#: Eager runs of a function on the card before its capture: the first
#: builds the kernels' libraries and tapes, the second runs as the capture
#: will, on warm caches.
WARMUP = 2
#: Structure keys a graphed function keeps (on the card, their graphs).
CACHE_SIZE = 8


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


class _HostReadGuard(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
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
#: nn.Module bookkeeping and stored readings: not part of an element's structure.
_NOT_STRUCTURE = frozenset(vars(nn.Module())) | {"reading", "cached_reading", "_read_beam"}


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


def graph_kernel_count(graph: "torch.cuda.CUDAGraph", name: str = "") -> int:
    """Kernel nodes of a captured graph whose node text (the kernel's
    mangled name among it) holds ``name``, from the graph's DOT dump
    (``CUDAGraph.debug_dump`` of a graph made with ``keep_graph=True``, as
    :func:`graphed` makes them)."""
    with tempfile.TemporaryDirectory() as directory:
        path = os.path.join(directory, "graph.dot")
        graph.debug_dump(path)
        with open(path) as dump:
            statements = dump.read().split("];")
    return sum(1 for s in statements if "KERNEL" in s and name in s)


class _Replay:
    """A captured graph: static inputs, static outputs and how to rebuild
    the outputs around fresh copies."""

    def __init__(self, graph, static, outputs, rebuild):
        self.graph, self.static, self.outputs, self.rebuild = graph, static, outputs, rebuild

    def __call__(self, leaves):
        if self.static:
            torch._foreach_copy_(self.static, [t.detach() for t in leaves])
        self.graph.replay()
        return self.rebuild([o.clone() for o in self.outputs])


class _GradReplay:
    """A forward and backward captured together (``make_graphed_callables``)."""

    def __init__(self, function, spec):
        self.function, self.spec = function, spec

    def __call__(self, leaves):
        inputs = [_FreshGradient.apply(t) if t.requires_grad else t for t in leaves]
        outputs = self.function(*inputs)
        return self.spec["rebuild"]([o.clone() for o in outputs])


class GraphedFunction:
    """See :func:`graphed`.  ``captures`` counts the structure keys seen
    (graphs captured on the card, eager runs' keys on the CPU), evicted
    ones included; ``graphs`` lists the kept forward-only graphs, the most
    recently used last; ``capture_seconds`` the captures' seconds (host
    clock, warm-ups included), in order."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.captures = 0
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._pool = None  # the forward-only graphs' memory pool
        self.capture_seconds: List[float] = []

    @property
    def graphs(self) -> List["torch.cuda.CUDAGraph"]:
        return [e.graph for e in self._cache.values() if isinstance(e, _Replay)]

    def __call__(self, *args, **kwargs):
        leaves, key, rebuild = flatten((args, kwargs))
        devices = {t.device.type for t in leaves}
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
        key = (key, grad)
        if "cuda" not in devices:
            self._entry(key, lambda: None)
            with capture_scope():
                return self.fn(*args, **kwargs)
        if devices != {"cuda"}:
            raise ValueError("graphed: the leaves mix CUDA and CPU tensors; move them to the card")

        def capture():
            start = time.perf_counter()
            if grad:
                entry = self._capture_grad(leaves, rebuild)
            else:
                entry = self._capture(leaves, rebuild, _generators(key))
            torch.cuda.synchronize()
            self.capture_seconds.append(time.perf_counter() - start)
            return entry

        return self._entry(key, capture)(leaves)

    def _entry(self, key, capture):
        """``key``'s cache entry, made by ``capture()`` where missing; past
        CACHE_SIZE keys the least recently used is evicted, with a warning."""
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        entry = self._cache[key] = capture()
        self.captures += 1
        if len(self._cache) > CACHE_SIZE:
            if entry is not None:
                torch.cuda.synchronize()  # no replay of the evicted graph in flight
            self._cache.popitem(last=False)
            warnings.warn(
                f"graphed {getattr(self.fn, '__qualname__', self.fn)!r}: {self.captures}"
                f" structure keys captured, the least recently used evicted (CACHE_SIZE"
                f" {CACHE_SIZE}). A Segment or element built anew each call without a name"
                " keys anew each call: build it once and re-tune its fields, or name it.",
                stacklevel=3,
            )
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
        with capture_scope(), torch.no_grad(), torch.cuda.graph(graph, pool=self._pool):
            out = self._call(rebuild, static)
        graph.instantiate()
        outputs, _, out_rebuild = flatten(out)
        return _Replay(graph, static, outputs, out_rebuild)

    def _capture_grad(self, leaves, rebuild) -> _GradReplay:
        static = [t.detach().clone().requires_grad_(t.requires_grad) for t in leaves]
        spec = {}

        def flat(*flat_leaves):
            with capture_scope():
                out = self._call(rebuild, list(flat_leaves))
            outputs, _, spec["rebuild"] = flatten(out)
            return tuple(outputs)

        with counters_kept():  # make_graphed_callables synchronises after its warm-ups
            function = torch.cuda.make_graphed_callables(
                flat, tuple(static), num_warmup_iters=WARMUP, allow_unused_input=True
            )
        return _GradReplay(function, spec)


def graphed(fn: Callable) -> GraphedFunction:
    """``fn`` captured once per structure key and replayed (see the module's
    note)."""
    return GraphedFunction(fn)
