"""The screen's kernel-density image of a particle beam: GPSR's smooth,
differentiable camera reading (Roussel et al., PRL 130, 145001, 2023).

For each setting ``s`` the unnormalised image is

    raw_s[r, c] = sum_p w_p * exp(-1/2 ((y_p - Y_r) / h)^2) * exp(-1/2 ((x_p - X_c) / h)^2)

with ``X_c`` and ``Y_r`` the pixels' centres, ``w_p`` the survival (or 1)
and ``h`` the bandwidth: ``K_y^T diag(w) K_x``, two Gaussian kernel
matrices of every particle against every column and every row, and one
product over the particles.  Nothing is truncated: every pixel gets every
particle's term.  :func:`normalised` divides each image by its sum (plus
1e-10), as GPSR's normalised joint KDE does.

:func:`kde_sums` computes ``raw`` in blocks of :data:`BLOCK` particles
(:class:`_BlockedSums`): the kernel values of a block are made, used in one
batched float32 product (``baddbmm``) and dropped, so that the
``(S, N, H + W)`` kernel values are never held whole.  Its backward is
written out and makes the kernel values again, block by block::

    A = K_y G,   dL/dx_p = -(w_p / h^2) sum_c A[p, c] K_x[p, c] (x_p - X_c)
    B = K_x G^T, dL/dy_p = -(w_p / h^2) sum_r B[p, r] K_y[p, r] (y_p - Y_r)
    dL/dw_p = sum_c A[p, c] K_x[p, c]

for the image's cotangent ``G``: two more products of the same size, three
in all.  The products run in full float32 whatever
``torch.backends.cuda.matmul.allow_tf32`` says (TF32 keeps 10 bits).
:func:`kde_sums_reference` is the plain version, the oracle of the tests:
the kernel matrices of all particles at once, an ``exp`` and a ``matmul``,
differentiated by autograd.

``kde_sums.blocks`` counts the particle blocks issued, forward and
backward (a captured step issues them once, at its capture).  The forward's
blocks run inside the span ``kernel.kde``, the backward's inside
``kernel.kde_bwd``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch

from lynx_tpu_torch import profiling

Tensor = torch.Tensor

#: Particles a block takes.
BLOCK = 16384

#: Added to each image's sum before the division (GPSR's guard against an
#: empty image).
NORM_EPS = 1e-10


def _kernel(v: Tensor, centres: Tensor, h) -> Tuple[Tensor, Tensor]:
    """``(d, k)``: ``d = v - centres`` and ``k = exp(-d^2 / (2 h^2))``, each
    ``(..., n, C)`` for ``v`` ``(..., n)`` and ``centres`` ``(C,)``."""
    d = torch.sub(v[..., None], centres)
    return d, torch.square(d).mul_(-0.5 / h**2).exp_()


def kde_sums_reference(x: Tensor, y: Tensor, weights: Optional[Tensor], x_centres: Tensor,
                       y_centres: Tensor, bandwidth) -> Tensor:
    """The plain version: ``(..., H, W)`` unnormalised images of the
    particles at ``x``, ``y`` ``(..., N)`` with ``weights`` (``(..., N)``,
    or None for 1), all particles at once."""
    kx = torch.exp(-0.5 * ((x[..., None] - x_centres) / bandwidth) ** 2)  # (..., N, W)
    ky = torch.exp(-0.5 * ((y[..., None] - y_centres) / bandwidth) ** 2)  # (..., N, H)
    if weights is not None:
        kx = kx * weights[..., None]
    return torch.matmul(ky.transpose(-2, -1), kx)


@contextlib.contextmanager
def _full_float32():
    """Matrix products in full float32 inside (TF32 off), the setting put
    back on leaving."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _blocks(n: int, block: int):
    for lo in range(0, n, block):
        yield lo, min(lo + block, n)


class _BlockedSums(torch.autograd.Function):
    """The blocked sums (see the module's note) on ``(B, N)`` particles."""

    @staticmethod
    def forward(ctx, x, y, weights, x_centres, y_centres, bandwidth, block):
        B, N = x.shape
        raw = x.new_zeros((B, y_centres.shape[0], x_centres.shape[0]))
        with profiling.span("kernel.kde"), _full_float32():
            for lo, hi in _blocks(N, block):
                _, kx = _kernel(x[:, lo:hi], x_centres, bandwidth)
                _, ky = _kernel(y[:, lo:hi], y_centres, bandwidth)
                if weights is not None:
                    kx.mul_(weights[:, lo:hi, None])
                raw.baddbmm_(ky.transpose(1, 2), kx)
                kde_sums.blocks += 1
        ctx.save_for_backward(x, y, weights, x_centres, y_centres)
        ctx.bandwidth, ctx.block = bandwidth, block
        return raw

    @staticmethod
    def backward(ctx, grad):
        x, y, weights, x_centres, y_centres = ctx.saved_tensors
        h, block = ctx.bandwidth, ctx.block
        scale = -1 / h**2
        need_x, need_y, need_w = ctx.needs_input_grad[:3]
        grad_x = torch.zeros_like(x) if need_x else None
        grad_y = torch.zeros_like(y) if need_y else None
        grad_w = torch.zeros_like(weights) if need_w else None
        grad = grad.contiguous()
        with profiling.span("kernel.kde_bwd"), _full_float32():
            for lo, hi in _blocks(x.shape[1], block):
                dx, kx = _kernel(x[:, lo:hi], x_centres, h)
                dy, ky = _kernel(y[:, lo:hi], y_centres, h)
                w = None if weights is None else weights[:, lo:hi]
                if need_x or need_w:
                    ak = torch.bmm(ky, grad).mul_(kx)  # A * K_x, (B, b, W)
                    if need_w:
                        grad_w[:, lo:hi] = ak.sum(-1)
                    if need_x:
                        gx = ak.mul_(dx).sum(-1).mul_(scale)
                        grad_x[:, lo:hi] = gx if w is None else gx.mul_(w)
                if need_y:
                    bk = torch.bmm(kx, grad.transpose(1, 2)).mul_(ky).mul_(dy)
                    gy = bk.sum(-1).mul_(scale)
                    grad_y[:, lo:hi] = gy if w is None else gy.mul_(w)
                kde_sums.blocks += 1
        return grad_x, grad_y, grad_w, None, None, None, None


def kde_sums(x: Tensor, y: Tensor, weights: Optional[Tensor], x_centres: Tensor,
             y_centres: Tensor, bandwidth: Union[float, Tensor], block: int = None) -> Tensor:
    """``(..., H, W)`` unnormalised KDE images (see the module's note) of the
    particles at ``x``, ``y`` ``(..., N)`` with ``weights`` (broadcast to
    ``x``; None for 1), on the pixels' centres ``x_centres`` ``(W,)`` and
    ``y_centres`` ``(H,)``, with bandwidth ``bandwidth`` (a number or a 0-d
    tensor), differentiable in ``x``, ``y`` and ``weights``, in blocks of
    ``block`` (default :data:`BLOCK`) particles."""
    batch, n = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, n)
    y = torch.broadcast_to(y, (*batch, n)).reshape(-1, n)
    if weights is not None:
        weights = torch.broadcast_to(weights, (*batch, n)).reshape(-1, n)
    raw = _BlockedSums.apply(x, y, weights, x_centres, y_centres, bandwidth,
                             block or BLOCK)
    return raw.reshape(*batch, *raw.shape[-2:])


kde_sums.blocks = 0


def normalised(raw: Tensor) -> Tensor:
    """Each ``(H, W)`` image over its sum plus :data:`NORM_EPS`."""
    return raw / (raw.sum(dim=(-2, -1), keepdim=True) + NORM_EPS)


__all__ = ["BLOCK", "kde_sums", "kde_sums_reference", "normalised"]
