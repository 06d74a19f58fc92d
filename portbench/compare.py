"""The numbers that decide ``correct``, each compared with its limit.

Training cells (the PPO update, the tuner's step) compare the first three
steps with the plain reference's: each step's loss, the first gradient as
the optimizer got it, and the parameters' change over the three steps, the
last two by the worst leaf: the gap between the program's norm of a leaf and
the reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger.  The median leaf is taken over the leaves whose
reference gradient is not exactly zero.  Leaves whose reference gradient is
under a thousandth of the median leaf's (a field the loss does not depend
on) move under Adam by round-off alone and are left out of the change.
Served answers (the screen's images) compare each sampled image with the
reference's: the particles counted in another pixel."""

from __future__ import annotations

import statistics

import torch

GRADIENT_FLOOR = 1e-3


def _norms(leaves):
    return {name: float(torch.linalg.vector_norm(t.double())) for name, t in leaves.items()}


def _gaps(program, reference, names):
    ref = _norms(reference)
    prog = _norms(program)
    scale = statistics.median([ref[n] for n in names]) if names else 0.0
    return {n: abs(prog[n] - ref[n]) / max(ref[n], scale) for n in names}


def training(program, reference, detail=None):
    """``{loss_gap, first_loss_gap, grad_gap, change_gap}`` of the
    program's ``(losses, first_gradient, change)`` against the reference's
    (leaves by name): the largest relative gap of the steps' losses and of
    the first step's, and the worst leaf's gap of the first gradient and of
    the change."""
    p_losses, p_grad, p_change = program
    r_losses, r_grad, r_change = reference
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(p_losses, r_losses))
    grad_norms = _norms(r_grad)
    moving = [n for n, v in grad_norms.items() if v > 0]
    median = statistics.median([grad_norms[n] for n in moving])
    kept = [n for n in moving if grad_norms[n] >= GRADIENT_FLOOR * median]
    grad_gaps = _gaps(p_grad, r_grad, moving)
    change_gaps = _gaps(p_change, r_change, kept)
    if detail is not None:  # for the readings: each step's and each leaf's gap
        detail.update(loss_gaps=[abs(p - r) / abs(r) for p, r in zip(p_losses, r_losses)],
                      grad_gaps=grad_gaps, change_gaps=change_gaps)
    return {"loss_gap": loss_gap,
            "first_loss_gap": abs(p_losses[0] - r_losses[0]) / abs(r_losses[0]),
            "grad_gap": max(grad_gaps.values(), default=0.0),
            "change_gap": max(change_gaps.values(), default=0.0)}


def columns(t, names):
    """``(B, n)`` -> ``{name: (B,)}``."""
    return {name: t[:, i] for i, name in enumerate(names)}


def moved(image, reference):
    """Particles the image counts in another pixel than the reference does."""
    return float(torch.sum(torch.abs(image.double() - reference.double()))) / 2


def verdict(numbers, limits):
    """``(correct, checks)``: every number that ``limits`` names at or under
    its limit, and ``{name: {"value", "limit"}}``."""
    checks = {name: {"value": float(numbers[name]), "limit": float(limit)}
              for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())  # NaN fails
    return correct, checks
