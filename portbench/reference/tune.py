"""Plain gradient tuning of a lattice's fields: the loss the sum over B
settings of |mu_x| + sigma_x + |mu_y| + sigma_y of a Gaussian beam at the
line's end, its gradient by autograd through the plain maps, and Adam, run
for a few steps."""

from __future__ import annotations

import torch

from portbench.reference import optics
from portbench.reference.ppo import adam


def loss_and_gradient(line, fields, mu, cov, block, fault=None):
    """``(loss, gradient)`` at ``fields`` ``(B, n)``: the sum over settings
    of |mu_x| + sigma_x + |mu_y| + sigma_y at the line's end, taken in
    blocks of ``block`` settings.  ``fault="half_batch"`` takes the first
    half of the settings only, the mean over them scaled back to B (a
    planted fault)."""
    B = fields.shape[0]
    used = B // 2 if fault == "half_batch" else B
    total, grads = 0.0, torch.zeros_like(fields)
    for lo in range(0, used, block):
        hi = min(lo + block, used)
        part = fields[lo:hi].detach().clone().requires_grad_(True)
        m, c = line.moments(part, mu[lo:hi], cov[lo:hi])
        loss = torch.sum(m[:, 0].abs() + optics.sigma(c, 0) + m[:, 2].abs()
                         + optics.sigma(c, 2)) * (B / used)
        grads[lo:hi] = torch.autograd.grad(loss, part)[0]
        total += float(loss.detach())
    return total, grads


def steps(line, fields, mu, cov, n, lr, block, fault=None):
    """``n`` Adam steps from ``fields`` ``(B, n_fields)``: ``(losses,
    first_gradient, change)``, the gradient and change ``(B, n_fields)``."""
    weights = {"fields": fields.clone()}
    state, losses, first = {}, [], None
    for t in range(1, n + 1):
        loss, grad = loss_and_gradient(line, weights["fields"], mu, cov, block, fault)
        if first is None:
            first = grad.clone()
        adam(weights, {"fields": grad}, state, t, lr)
        losses.append(loss)
    return losses, first, weights["fields"] - fields
