"""Gradient-tuning loops (counterpart of ``lynx_tpu.tuning``).

``loss_fn(params, *args) -> scalar`` is minimised by a ``torch.optim``
optimizer in a host loop: one value-and-gradient and one optimizer step per
iteration.  Where the JAX package compiles the loop into one ``lax.scan``
or ``lax.while_loop``, this port runs it eagerly; the loss history stays on
the device until the loop ends, so :func:`tune` reads the device only where
a ``callback`` asks for a loss.

``params`` is a tensor or a list/tuple of tensors; the loops optimise a
detached copy and return it in the same form.  ``optimizer`` is a factory
``optimizer(list_of_tensors) -> torch.optim.Optimizer``; the default is
Adam with learning rate 5e-2, as ``optax.adam(5e-2)`` in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional

import torch

from lynx_tpu_torch import _collectives

__all__ = ["make_tuner", "tune", "tune_until"]

#: The default optimizer: Adam, learning rate 5e-2.
DEFAULT_OPTIMIZER = functools.partial(torch.optim.Adam, lr=5e-2)


def _leaves(params) -> List[torch.Tensor]:
    return list(params) if isinstance(params, (list, tuple)) else [params]


def _detached(params):
    """A trainable copy of ``params``, in its own form."""
    copies = [p.detach().clone().requires_grad_(True) for p in _leaves(params)]
    if isinstance(params, (list, tuple)):
        return type(params)(copies)
    return copies[0]


def make_tuner(optimizer: torch.optim.Optimizer, loss_fn: Callable[..., torch.Tensor]):
    """Build ``tuner(params, steps, *args) -> (params, losses)``: ``steps``
    iterations of ``optimizer``, which must already hold ``params`` (the
    trainable tensors themselves, updated in place), on ``loss_fn(params,
    *args)``.  ``losses`` is the ``(steps,)`` history, on the loss's device.

    Inside ``with mesh:`` (``lynx_tpu_torch.parallel``) each step sums the
    gradients over the ranks (``_collectives.backward``), and the history is
    the global loss.
    """
    tuned = [p for group in optimizer.param_groups for p in group["params"]]

    def tuner(params, steps: int, *args):
        losses = []
        for _ in range(steps):
            optimizer.zero_grad(set_to_none=True)
            losses.append(_collectives.backward(loss_fn(params, *args), tuned))
            optimizer.step()
        return params, torch.stack(losses) if losses else torch.empty(0)

    return tuner


def tune(
    loss_fn: Callable[..., torch.Tensor],
    params: Any,
    *args,
    optimizer: Optional[Callable] = None,
    steps: int = 100,
    chunk: Optional[int] = None,
    callback: Optional[Callable[[int, float], None]] = None,
):
    """Minimise ``loss_fn(params, *args)`` for ``steps`` iterations; return
    ``(params, losses)``: the tuned copy and the ``(steps,)`` loss history.

    :param optimizer: optimizer factory (default Adam, lr 5e-2).
    :param chunk: if given, run in chunks of this many steps and call
        ``callback(step, loss)`` between chunks (each call reads one loss
        from the device).
    """
    params = _detached(params)
    opt = (optimizer or DEFAULT_OPTIMIZER)(_leaves(params))
    tuner = make_tuner(opt, loss_fn)

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


def tune_until(
    loss_fn: Callable[..., torch.Tensor],
    params: Any,
    *args,
    optimizer: Optional[Callable] = None,
    tol: float = 1e-8,
    max_steps: int = 1000,
):
    """Minimise until the loss improves by less than ``tol`` (relative to
    ``max(1, |loss|)``) between consecutive steps, or ``max_steps``.  The
    test reads the loss on the host once per step.

    :return: ``(params, losses, num_steps)``: ``losses`` is a fixed
        ``(max_steps,)`` float32 history, NaN past ``num_steps``.
    """
    params = _detached(params)
    opt = (optimizer or DEFAULT_OPTIMIZER)(_leaves(params))
    history = torch.full((max_steps,), float("nan"), dtype=torch.float32)
    previous = None
    i = 0
    while i < max_steps:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, *args)
        loss.backward()
        opt.step()
        last = float(loss.detach())
        history[i] = last
        i += 1
        if previous is not None and abs(previous - last) <= tol * max(1.0, abs(last)):
            break
        previous = last
    return params, history, i
