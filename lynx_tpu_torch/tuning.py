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
which the capture sets ``capturable=True`` on (``graphs.make_capturable``);
any other raises on CUDA parameters.  The graph is made once per ``params``
object and structure of ``args`` (``graphs.StepCache``); later calls copy
``args`` into it.  Before the capture one step runs eagerly (the warm-up),
and the parameters and the optimizer's state (and the screen read's
fallback counters) are then put back as they were
(``graphs.CapturedStep``).  On CPU parameters the same step runs eagerly,
under ``graphs.capturing``: the CPU computes what the graph computes.
``graph=False`` runs the same step eagerly with no capture anywhere.
Inside ``with mesh:`` the captured step holds the parallel layer's
all-reduces (NCCL collectives captured in the graph).

``params`` is a tensor or a list/tuple of tensors for :func:`tune` and
:func:`tune_until`, which optimise a detached copy and return it in the same
form.  ``optimizer`` is a factory ``optimizer(list_of_tensors) ->
torch.optim.Optimizer``; the default is Adam with learning rate 5e-2, as
``optax.adam(5e-2)`` in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional

import torch

from lynx_tpu_torch import _collectives
from lynx_tpu_torch.graphs import CapturedStep, StepCache, capturing, optimizer_step

__all__ = ["make_tuner", "tune", "tune_until"]

#: The default optimizer: Adam, learning rate 5e-2.
DEFAULT_OPTIMIZER = functools.partial(torch.optim.Adam, lr=5e-2)
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


class _Loop:
    """One step of a tuning loop and its device state: the ``args``, the
    loss ``history``, the step ``index`` and, for ``tune_until``, the last
    loss and the stop flag.  After :meth:`capture` the step runs as a
    graph runs it: captured on CUDA parameters, else eagerly under
    ``graphs.capturing``; without it the step runs plainly eagerly."""

    def __init__(self, optimizer, loss_fn, params, args, capacity, until=None):
        self.optimizer, self.loss_fn, self.params, self.until = optimizer, loss_fn, params, until
        self.tuned = _tuned(optimizer)
        self.args = args
        device = self.tuned[0].device
        self.capacity = capacity
        self.index = torch.zeros((), dtype=torch.int64, device=device)
        self.history = None  # made at the first step, in the loss's dtype (float32 for until)
        self.last = None  # tune_until's last loss, in the loss's dtype
        if until is not None:
            self.history = torch.full((capacity,), float("nan"), dtype=torch.float32,
                                      device=device)
            self.stop = torch.zeros((), dtype=torch.bool, device=device)
        self.captured = None  # the graph form's step (graphs.CapturedStep)

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
        self._optimizer_step()
        self.history.index_copy_(0, self.index.view(1), loss.reshape(1).to(self.history.dtype))
        self.index.add_(1)

    def _optimizer_step(self) -> None:
        if capturing():
            optimizer_step(self.optimizer)
        else:
            self.optimizer.step()

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
        self._optimizer_step()
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

    def capture(self, generators=()) -> "_Loop":
        """The graph form's step (``graphs.CapturedStep``): on CUDA
        parameters, warmed up (one step, then the parameters, the
        optimizer's state, the generators and the fallback counters put
        back) and captured in a CUDA graph; on the CPU, run eagerly under
        ``graphs.capturing``."""
        self.captured = CapturedStep(self.step, self.tuned[0].device, keep=self.tuned,
                                     optimizer=self.optimizer, generators=generators,
                                     reset=self.reset)
        return self

    @property
    def graph(self):
        """The captured step's CUDA graph, or None."""
        return None if self.captured is None else self.captured.graph

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
            if self.captured is not None:
                self.captured()
            else:
                self.step()


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

    Inside ``with mesh:`` (``lynx_tpu_torch.parallel``) the step sums the
    gradients over the ranks (``_collectives.backward``), captured with its
    all-reduces on CUDA (a graph captured inside a mesh is not replayed
    outside it: the mesh is part of the key); the history is the global
    loss.
    """
    loops = StepCache("make_tuner's step")

    def tuner(params, steps: int, *args):
        if not graph:
            loop = _Loop(optimizer, loss_fn, params, args, max(steps, 1))
        else:
            loop = loops((params,), args, lambda static, generators: _Loop(
                optimizer, loss_fn, params, static, max(steps, 1)).capture(generators),
                stale=lambda loop: loop.capacity < steps)
            tuner.captures = loops.captures
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
    loop = _Loop(opt, loss_fn, params, args, max(max_steps, 1), until=(tol, max_steps))
    if graph:
        loop.capture()
    loop.reset()
    every = UNTIL_READ_EVERY if graph else 1
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
