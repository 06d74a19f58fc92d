"""The collectives of a sharded run, written out where XLA inserts its own.

Under JAX's ``with mesh:`` the compiler inserts a ``psum`` over the
particle axis wherever a statistic sums over particles, and one over the
screen image.  The port runs on plain local tensors, so those sums read the
active particle group from here: :class:`lynx_tpu_torch.parallel.Mesh`
activates its groups on ``with mesh:``.  With no group active every helper
is the plain local reduction, and the single-device paths pay one check.

Gradient convention: the all-reduce's backward all-reduces the cotangents
(the adjoint of a sum over ranks).  Every rank goes on to compute the same
replicated loss, so each rank must count 1/size of it: the summed
cotangent of a global sum is then the whole one, and every intermediate
that a rank shares (the mean, before the deviations' sum) gets the
cotangents of every rank's particles.  A rank's gradient is its own
particles' part; :func:`backward` scales the loss and sums the gradients
across the ranks.  (An identity backward would drop the
other ranks' part of a shared intermediate's cotangent: the second moment's
gradient through the mean would be wrong.)
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from lynx_tpu_torch import profiling

#: The process group of the particle axis and of the batch axis while a
#: mesh is active (``with mesh:``), else ``None``; the innermost mesh wins.
_groups = {"particles": None, "batch": None, "mesh": None}

#: Attribute set on a tensor that ``parallel.shard_segment`` split over the
#: batch axis: its gradient sums over the particle group only.
BATCH_SHARDED = "_lynx_batch_sharded"

#: All-reduces issued through :func:`all_reduce_sum`, counted where they
#: are issued (the collectives a sharded run inserts).
counts = {"all_reduce": 0}


@contextmanager
def active(mesh, particles=None, batch=None):
    """Activate ``mesh`` and its particle and batch groups for the block."""
    saved = dict(_groups)
    _groups.update(particles=particles, batch=batch, mesh=mesh)
    try:
        yield mesh
    finally:
        _groups.update(saved)


def batch_group():
    """The active batch-axis group, or ``None``."""
    return _groups["batch"]


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the cotangents over it
    (module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        counts["all_reduce"] += 1
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (differentiable: the
    backward sums the cotangents)."""
    counts["all_reduce"] += 1
    return _AllReduceSum.apply(x, group)


def group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def particle_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x.sum(dim)`` over the whole particle axis: the local sum, then,
    under an active particle group, its all-reduce."""
    total = x.sum(dim=dim)
    group = _groups["particles"]
    return total if group is None else all_reduce_sum(total, group)


def particle_count(local: int) -> int:
    """The particle count of the whole beam, from a rank's ``local`` count
    (the particle axis is split evenly)."""
    group = _groups["particles"]
    return local if group is None else local * group_size(group)


def all_lost(survival: torch.Tensor) -> bool:
    """Whether every particle of every shard is lost (one host read)."""
    group = _groups["particles"]
    if group is None:
        return bool((survival == 0).all())
    return bool(all_reduce_sum((survival != 0).sum(), group) == 0)


def particle_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """A rank's partial result over its particles (a screen image, a Gram)
    summed over the particle axis: one all-reduce under an active particle
    group, else ``x``."""
    group = _groups["particles"]
    return x if group is None else all_reduce_sum(x, group)


def all_reduce_flat(tensors: list, group) -> None:
    """Sum ``tensors`` over ``group`` in place, in one all-reduce (not
    differentiable: gradients and reported values)."""
    if not tensors:
        return
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    counts["all_reduce"] += 1
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view_as(t))
        start += t.numel()


def backward(loss: torch.Tensor, params: list) -> torch.Tensor:
    """Backpropagate a training step's ``loss`` into ``params``; return the
    loss to report.

    With no mesh active this is ``loss.backward()``.  Inside ``with mesh:``
    every rank counts its share of the global loss, its local mean over the
    number of ranks (the batch ranks' means sum to the global mean, and the
    particle ranks hold the same value), so each rank's gradient is its
    share.  The gradients of fields split over ``batch``
    (:data:`BATCH_SHARDED`) are then summed over ``particles``, those of
    replicated fields over every rank (one all-reduce each).  The loss
    returned is the global one, all-reduced over ``batch``."""
    with profiling.span("backward"):
        return _backward(loss, params)


def _backward(loss: torch.Tensor, params: list) -> torch.Tensor:
    mesh = _groups["mesh"]
    if mesh is None:
        loss.backward()
        return loss.detach()
    import torch.distributed as dist

    (loss / mesh.size).backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    split = [p.grad for p in params if getattr(p, BATCH_SHARDED, False)]
    replicated = [p.grad for p in params if not getattr(p, BATCH_SHARDED, False)]
    if _groups["particles"] is not None:
        all_reduce_flat(split, _groups["particles"])
    all_reduce_flat(replicated, dist.group.WORLD)
    reported = loss.detach()
    if _groups["batch"] is not None:
        reported = reported / group_size(_groups["batch"])
        all_reduce_flat([reported], _groups["batch"])
    return reported
