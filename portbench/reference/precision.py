"""The reference's arithmetic: float64, or, for the control that has to fail
the comparison, float32 with every matrix product's operands rounded to
TF32 (10 explicit mantissa bits, rounded to nearest, ties away from zero, as
the tensor cores round them), the precision a float32 program gets with
TF32 switched on.  The rounding is done here, so the control reads the same
on the CPU and on the card."""

from __future__ import annotations

import contextlib

import torch

_STATE = {"tf32": False}


@contextlib.contextmanager
def tf32():
    """Inside, :func:`matmul` rounds its float32 operands to TF32."""
    before = _STATE["tf32"]
    _STATE["tf32"] = True
    try:
        yield
    finally:
        _STATE["tf32"] = before


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """A product whose operands, forward and backward, are rounded to TF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_tf32(a), to_tf32(b))

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = to_tf32(grad)
        grad_a = torch.matmul(grad, to_tf32(b).transpose(-2, -1))
        grad_b = torch.matmul(to_tf32(a).transpose(-2, -1), grad)
        return _unbroadcast(grad_a, a.shape), _unbroadcast(grad_b, b.shape)


def _unbroadcast(grad, shape):
    while grad.dim() > len(shape):
        grad = grad.sum(0)
    for axis, size in enumerate(shape):
        if size == 1 and grad.shape[axis] != 1:
            grad = grad.sum(axis, keepdim=True)
    return grad


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _STATE["tf32"] and a.dtype == torch.float32:
        return _TF32MatMul.apply(a, b)
    return torch.matmul(a, b)
