"""Gradient-tuning loops (counterpart of ``lynx_tpu.tuning``).

``loss_fn(params, *args) -> scalar`` is minimised by a ``torch.optim``
optimizer: one value-and-gradient and one optimizer step per iteration.
Where the JAX package compiles the loop into one ``lax.scan``
(:func:`make_tuner`, :func:`tune`) or one ``lax.while_loop``
(:func:`tune_until`), the port captures one step in a CUDA graph on CUDA
parameters and replays it: no host read between steps, the loss history
written on the device at a device step index.  ``tune_until`` decides on the
device, as JAX's ``cond_fn`` does, whether a step runs: a step after the
predicate turned false leaves the parameters, the optimizer's state and the
history as they were, and the host reads the stop flag once every
:data:`UNTIL_READ_EVERY` replays.

The captured step needs an optimizer that runs captured: Adam or AdamW,
which the tuner sets ``capturable=True`` on; any other raises on CUDA
parameters.  The graph is made once per ``params`` object and structure of
``args`` (``graphs.flatten``); later calls copy ``args`` into it.  Before
the capture one step runs eagerly (the warm-up), and the parameters and
the optimizer's state (and the screen read's fallback counters) are then
put back as they were.  On CPU parameters the same step runs eagerly,
under ``graphs.capturing``: the CPU computes what the graph computes.
``graph=False`` runs the same step eagerly with no capture anywhere; so
does ``with mesh:`` (the parallel layer's collectives are not captured
yet).

``params`` is a tensor or a list/tuple of tensors for :func:`tune` and
:func:`tune_until`, which optimise a detached copy and return it in the same
form.  ``optimizer`` is a factory ``optimizer(list_of_tensors) ->
torch.optim.Optimizer``; the default is Adam with learning rate 5e-2, as
``optax.adam(5e-2)`` in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, List, Optional

import torch

from lynx_tpu_torch import _collectives
from lynx_tpu_torch.graphs import _Identity, capture_scope, counters_kept, flatten

__all__ = ["make_tuner", "tune", "tune_until"]

#: The default optimizer: Adam, learning rate 5e-2.
DEFAULT_OPTIMIZER = functools.partial(torch.optim.Adam, lr=5e-2)
#: Optimizers whose step runs captured (``capturable=True``) and whose fresh
#: state is zeros, so that the warm-up's step can be undone in place.
CAPTURABLE = (torch.optim.Adam, torch.optim.AdamW)
#: ``tune_until`` replays this many steps between reads of its stop flag.
UNTIL_READ_EVERY = 16


def _leaves(params) -> List[torch.Tensor]:
    return list(params) if isinstance(params, (list, tuple)) else [params]


def _detached(params):
    """A trainable copy of ``params``, in its own form."""
    copies = [p.detach().clone().requires_grad_(True) for p in _leaves(params)]
    if isinstance(params, (list, tuple)):
        return type(params)(copies)
    return copies[0]


def _tuned(optimizer) -> List[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _state_tensors(optimizer, tuned) -> List[torch.Tensor]:
    """The optimizer's state tensors, in a fixed order."""
    return [v for p in tuned for _, v in sorted(optimizer.state[p].items())
            if isinstance(v, torch.Tensor)]


def _make_capturable(optimizer) -> None:
    if not isinstance(optimizer, CAPTURABLE):
        raise TypeError(
            f"graphed tuner: {type(optimizer).__name__} does not run captured; use"
            " torch.optim.Adam or AdamW, or graph=False"
        )
    for group in optimizer.param_groups:
        group["capturable"] = True
    for state in optimizer.state.values():  # steps kept on the host by an eager run
        if isinstance(state.get("step"), torch.Tensor) and not state["step"].is_cuda:
            state["step"] = state["step"].to(next(p for p in _tuned(optimizer)).device)


class _Loop:
    """One step of a tuning loop and its device state: the ``args``, the
    loss ``history``, the step ``index`` and, for ``tune_until``, the last
    loss and the stop flag.  ``graph_form`` runs the step as a graph runs
    it: captured on CUDA parameters (:meth:`capture`), else eagerly under
    ``capture_scope``; without it the step runs plainly eagerly."""

    def __init__(self, optimizer, loss_fn, params, args, capacity, until=None, graph_form=True):
        self.optimizer, self.loss_fn, self.params, self.until = optimizer, loss_fn, params, until
        self.tuned = _tuned(optimizer)
        self.args, self.static = args, None  # static: the graph's copies of the args' leaves
        self.scope = capture_scope if graph_form else contextlib.nullcontext
        device = self.tuned[0].device
        self.capacity = capacity
        self.index = torch.zeros((), dtype=torch.int64, device=device)
        self.history = None  # made at the first step, in the loss's dtype (float32 for until)
        self.last = None  # tune_until's last loss, in the loss's dtype
        if until is not None:
            self.history = torch.full((capacity,), float("nan"), dtype=torch.float32,
                                      device=device)
            self.stop = torch.zeros((), dtype=torch.bool, device=device)
        self.graph = None

    def load(self, args) -> None:
        if self.static is None:
            self.args = args
        elif self.static:
            torch._foreach_copy_(self.static, [t.detach() for t in flatten(args)[0]])

    def step(self) -> None:
        """One step: the loss, its gradient and the optimizer's update, the
        loss written to the history at the device index.  Its buffers are made
        at the first (eager) step: a capture only writes them."""
        self.optimizer.zero_grad(set_to_none=True)  # a capture's backward makes the grads
        loss = _collectives.backward(self.loss_fn(self.params, *self.args), self.tuned)
        if self.history is None:
            self.history = torch.full((self.capacity,), float("nan"), dtype=loss.dtype,
                                      device=loss.device)
        if self.until is not None and self.last is None:
            self.last = torch.full((), float("inf"), dtype=loss.dtype, device=loss.device)
        if self.until is not None:
            return self._until_step(loss)
        self.optimizer.step()
        self.history.index_copy_(0, self.index.view(1), loss.reshape(1).to(self.history.dtype))
        self.index.add_(1)

    def _until_step(self, loss) -> None:
        """``tune_until``'s step: it runs unless the stop flag is set, else
        it leaves everything as it was; then JAX's ``cond_fn`` sets the flag
        for the next step: it runs while ``i < max_steps & (i < 2 |
        improving)``, improving comparing the last loss with the one before
        it (from the float32 history)."""
        tol, max_steps = self.until
        active = ~self.stop
        kept = [t.detach().clone() for t in self.tuned]
        state = _state_tensors(self.optimizer, self.tuned)
        kept_state = [t.clone() for t in state]
        self.optimizer.step()
        with torch.no_grad():
            for t, old in zip(self.tuned + state, kept + kept_state):
                t.copy_(torch.where(active, t, old))
        slot = self.index.clamp(max=max_steps - 1).view(1)
        value = loss.detach().reshape(1).to(self.history.dtype)
        self.history.index_copy_(0, slot, torch.where(active, value, self.history[slot]))
        self.last.copy_(torch.where(active, loss.detach().to(self.last.dtype), self.last))
        self.index.add_(active.to(self.index.dtype))
        i = self.index
        previous = self.history.index_select(0, (i - 2).clamp(min=0).view(1))[0]
        going = (i < max_steps) & ((i < 2) | _improving(previous, self.last, tol))
        self.stop.copy_(~going)

    def capture(self) -> None:
        """Warm up (one step, then the parameters, the optimizer's state and
        the fallback counters put back) and capture one step in a CUDA
        graph, on static copies of the args."""
        _make_capturable(self.optimizer)
        leaves, _, rebuild = flatten(self.args)
        self.static = [t.detach().clone() for t in leaves]
        self.args = rebuild(self.static)
        device = self.tuned[0].device
        kept = [p.detach().clone() for p in self.tuned]
        had_state = {p: {k: v.clone() for k, v in self.optimizer.state[p].items()
                         if isinstance(v, torch.Tensor)} for p in self.tuned}
        with counters_kept():
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), capture_scope():
                self.step()
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
        with torch.no_grad():
            for p, old in zip(self.tuned, kept):
                p.copy_(old)
            for p in self.tuned:  # fresh Adam and AdamW state is zeros
                for k, v in self.optimizer.state[p].items():
                    if not isinstance(v, torch.Tensor):
                        continue
                    if k in had_state[p]:
                        v.copy_(had_state[p][k])
                    else:
                        v.zero_()
        self.reset()
        self.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        with capture_scope(), torch.cuda.graph(self.graph):
            self.step()
        torch.cuda.synchronize(device)

    def reset(self) -> None:
        self.index.zero_()
        if self.until is not None:
            self.history.fill_(float("nan"))
            self.stop.zero_()
            if self.last is not None:
                self.last.fill_(float("inf"))

    def run(self, steps: int) -> None:
        """``steps`` steps: graph replays, or the step run eagerly."""
        for _ in range(steps):
            if self.graph is not None:
                self.graph.replay()
            else:
                with self.scope():
                    self.step()


def _graph_form(graph: bool) -> bool:
    """Whether a loop runs as a graph: asked for, and outside ``with mesh:``
    (the parallel layer's collectives are not captured yet)."""
    return graph and _collectives._groups["mesh"] is None


def _start(optimizer, loss_fn, params, args, capacity, graph, until=None) -> _Loop:
    form = _graph_form(graph)
    loop = _Loop(optimizer, loss_fn, params, args, capacity, until, graph_form=form)
    if form and all(p.is_cuda for p in loop.tuned):
        loop.capture()
    return loop


def make_tuner(optimizer: torch.optim.Optimizer, loss_fn: Callable[..., torch.Tensor],
               graph: bool = True):
    """Build ``tuner(params, steps, *args) -> (params, losses)``: ``steps``
    iterations of ``optimizer``, which must already hold ``params`` (the
    trainable tensors themselves, updated in place), on ``loss_fn(params,
    *args)``.  ``losses`` is the ``(steps,)`` history, on the loss's device.

    On CUDA parameters one step is captured and replayed ``steps`` times,
    with no host read (see the module's note); a call with more steps than
    the first, or with a new ``params`` object or new structure of
    ``args``, captures again.  ``tuner.captures`` counts the captures (the
    eager runs' keys on the CPU).  ``graph=False`` runs the same step
    eagerly, with no capture: for an optimizer that does not run captured,
    or as the eager reference.

    Inside ``with mesh:`` (``lynx_tpu_torch.parallel``) the step runs
    eagerly and sums the gradients over the ranks
    (``_collectives.backward``); the history is the global loss.
    """
    loops: dict = {}

    def tuner(params, steps: int, *args):
        if not _graph_form(graph):
            loop = _start(optimizer, loss_fn, params, args, max(steps, 1), graph)
        else:
            key = (_Identity(params), flatten(args)[1])
            loop = loops.get(key)
            if loop is None or loop.capacity < steps:
                loop = loops[key] = _start(optimizer, loss_fn, params, args, max(steps, 1), graph)
                tuner.captures += 1
            else:
                loop.load(args)
            loop.reset()
        loop.run(steps)
        if loop.history is None:
            return params, torch.empty(0)
        return params, loop.history[:steps].clone()

    tuner.captures = 0
    return tuner


def tune(
    loss_fn: Callable[..., torch.Tensor],
    params: Any,
    *args,
    optimizer: Optional[Callable] = None,
    steps: int = 100,
    chunk: Optional[int] = None,
    callback: Optional[Callable[[int, float], None]] = None,
    graph: bool = True,
):
    """Minimise ``loss_fn(params, *args)`` for ``steps`` iterations; return
    ``(params, losses)``: the tuned copy and the ``(steps,)`` loss history.

    :param optimizer: optimizer factory (default Adam, lr 5e-2).
    :param chunk: if given, run in chunks of this many steps and call
        ``callback(step, loss)`` between chunks (each call reads one loss
        from the device).  One capture serves all chunks.
    :param graph: ``False`` runs the eager loop (see :func:`make_tuner`).
    """
    params = _detached(params)
    opt = (optimizer or DEFAULT_OPTIMIZER)(_leaves(params))
    tuner = make_tuner(opt, loss_fn, graph=graph)

    if not chunk or chunk >= steps:
        params, losses = tuner(params, steps, *args)
        if callback is not None:
            callback(steps - 1, float(losses[-1]))
        return params, losses

    histories = []
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        params, losses = tuner(params, n, *args)
        histories.append(losses)
        done += n
        if callback is not None:
            callback(done - 1, float(losses[-1]))
    return params, torch.cat(histories)


def _improving(previous, last, tol):
    """JAX's ``cond_fn`` test, in the loss's dtype: the float32 history's
    ``previous`` loss against the ``last`` one."""
    return (previous.to(last.dtype) - last).abs() > tol * torch.clamp(last.abs(), min=1.0)


def tune_until(
    loss_fn: Callable[..., torch.Tensor],
    params: Any,
    *args,
    optimizer: Optional[Callable] = None,
    tol: float = 1e-8,
    max_steps: int = 1000,
    graph: bool = True,
):
    """Minimise until the loss improves by less than ``tol`` (relative to
    ``max(1, |loss|)``) between consecutive steps, or ``max_steps``.  The
    test runs on the device after each step, for the next (JAX's
    ``cond_fn``);
    the host reads the stop flag once every :data:`UNTIL_READ_EVERY` steps
    (``tune_until.host_reads`` holds the last run's count).  ``graph=False``
    runs the same step eagerly and reads the flag after every step.

    :return: ``(params, losses, num_steps)``: ``losses`` is a fixed
        ``(max_steps,)`` float32 history, NaN past ``num_steps``.
    """
    params = _detached(params)
    opt = (optimizer or DEFAULT_OPTIMIZER)(_leaves(params))
    loop = _start(opt, loss_fn, params, args, max(max_steps, 1), graph, until=(tol, max_steps))
    loop.reset()
    every = UNTIL_READ_EVERY if _graph_form(graph) else 1
    done, reads = 0, 0
    while done < max_steps:
        burst = min(every, max_steps - done)
        loop.run(burst)
        done += burst
        reads += 1
        if bool(loop.stop):
            break
    tune_until.host_reads = reads
    return params, loop.history[:max_steps].clone(), int(loop.index)


tune_until.host_reads = None
