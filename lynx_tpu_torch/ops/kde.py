"""The screen's kernel-density image of a particle beam: GPSR's smooth,
differentiable camera reading (Roussel et al., PRL 130, 145001, 2023).

For each setting ``s`` the unnormalised image is

    raw_s[r, c] = sum_p w_p * exp(-1/2 ((y_p - Y_r) / h)^2) * exp(-1/2 ((x_p - X_c) / h)^2)

with ``X_c`` and ``Y_r`` the pixels' centres, ``w_p`` the survival (or 1)
and ``h`` the bandwidth: ``K_y^T diag(w) K_x``, two Gaussian kernel
matrices of every particle against every column and every row, and one
product over the particles.  Nothing is truncated: every pixel gets every
particle's term.  Its gradient for the image's cotangent ``G``::

    A = K_y G,   dL/dx_p = -(w_p / h^2) sum_c A[p, c] K_x[p, c] (x_p - X_c)
    B = K_x G^T, dL/dy_p = -(w_p / h^2) sum_r B[p, r] K_y[p, r] (y_p - Y_r)
    dL/dw_p = sum_c A[p, c] K_x[p, c]

two more products of the same size, three in all.  :func:`normalised`
divides each image by its sum (plus 1e-10), as GPSR's normalised joint KDE
does.

:func:`kde_sums` routes by device:

* **CUDA tensors** launch kernel **B9** (``csrc/kde.cu``, built with nvcc at
  the first call on a CUDA tensor, never at import), always, with no
  fallback.  It never writes a kernel value to device memory: each block
  makes its tile's Gaussian values in shared memory from the particles and
  the pixels' centres and feeds them straight into a float32 FMA product
  tiled in registers (no tensor cores, no term skipped), forward and
  backward; the backward's sums over ``A K`` are taken in the product's
  epilogue.  Its bound is the three products' operations at the H100's
  float32 rate outside the tensor cores (67 TFLOP/s): 11.18 ms at GPSR's 16
  settings of 100,000 particles on 255 x 306 pixels.  The forward splits the
  particles where the image's tiles alone do not fill the card
  (:func:`kde_plan`, from the shapes and the SM count) and adds the splits'
  partial images in a fixed order: every call gives the same bits.
* **CPU tensors** take the blocked route (:class:`_BlockedSums`): the kernel
  values of :data:`BLOCK` particles are made, used in one batched float32
  product (``baddbmm``) and dropped, so that the ``(S, N, H + W)`` kernel
  values are never held whole; its written-out backward makes them again,
  block by block.  The products run in full float32 whatever
  ``torch.backends.cuda.matmul.allow_tf32`` says.

:func:`kde_sums_reference` is the plain version, the oracle of the tests:
the kernel matrices of all particles at once, an ``exp`` and a ``matmul``,
differentiated by autograd.

``kde_sums.launches`` counts B9's kernel launches (a forward's image kernel
and, where it splits the particles, the splits' sum; a backward's one
kernel); ``kde_sums.blocks`` counts the blocked route's particle blocks,
forward and backward.  A captured step issues either once, at its
capture.  The forward runs inside the span ``kernel.kde``, the backward
inside ``kernel.kde_bwd``, on either route.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from lynx_tpu_torch import profiling
from lynx_tpu_torch._build import check, load_library

Tensor = torch.Tensor

#: Particles a block takes.
BLOCK = 16384

#: Added to each image's sum before the division (GPSR's guard against an
#: empty image).
NORM_EPS = 1e-10

#: B9's image tile (``csrc/kde.cu``: ``kTileM`` rows, in float and in double,
#: by ``kTileN`` columns), its particles a chunk in float (a split's span is a
#: multiple of it), and the image blocks an SM holds (its launch bounds).
TILE_ROWS = {torch.float32: 256, torch.float64: 128}
TILE_COLS, CHUNK, RESIDENT = 64, 16, 2
#: The share of the card's resident blocks the forward's last wave must fill
#: before :func:`kde_plan` stops adding splits.
FILL = 0.95


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


# -- Kernel B9 ---------------------------------------------------------------


class KdePlan(NamedTuple):
    """B9's forward grid: ``row_tiles`` x ``col_tiles`` tiles of the image a
    setting, and the particles cut into ``splits`` ranges of ``span``
    (split ``k`` takes ``[k span, min((k + 1) span, N))``, none empty)."""

    row_tiles: int
    col_tiles: int
    splits: int
    span: int


@functools.lru_cache(maxsize=None)
def kde_plan(settings: int, n: int, height: int, width: int, sms: int,
             dtype: torch.dtype = torch.float32) -> KdePlan:
    """The forward's tiles and split of ``n`` particles for ``settings``
    images of ``height`` x ``width`` in ``dtype`` (the tiles' rows by
    :data:`TILE_ROWS`) on a card of ``sms`` SMs: the fewest splits whose
    blocks fill the last wave of the card's resident blocks (:data:`RESIDENT`
    an SM) to :data:`FILL` (else the best fill up to eight waves), at most one
    a chunk of :data:`CHUNK` particles."""
    row_tiles, col_tiles = -(-height // TILE_ROWS[dtype]), -(-width // TILE_COLS)
    tiles = settings * row_tiles * col_tiles
    chunks = max(1, -(-n // CHUNK))
    slots = sms * RESIDENT
    splits, best = 1, 0.0
    for candidate in range(1, min(chunks, max(1, -(-8 * slots // max(tiles, 1)))) + 1):
        blocks = tiles * candidate
        fill = blocks / (-(-blocks // slots) * slots) if blocks else 1.0
        if fill > best:
            splits, best = candidate, fill
        if fill >= FILL:
            break
    span = -(-chunks // splits) * CHUNK
    return KdePlan(row_tiles, col_tiles, max(1, -(-n // span)), span)


_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_OPERANDS = [ctypes.c_int, _P, _P, _P] + [_LL] * 6 + [_P, _P, _P, ctypes.c_double]
#: C signatures of B9's entry points: is_double, x, y, w, their (setting,
#: particle) strides, the centres, the bandwidth (a pointer or a number),
#: then the image's settings, particles, height, width, the plan's row and
#: column tiles, splits and span, parts, out and stream, or the gradient's
#: cotangent, settings, particles, height, width, gx, gy, gw and stream.
_B9_SIGNATURE = {
    "lynx_kde_image": (ctypes.c_int, _OPERANDS + [_LL, _LL] + [ctypes.c_int] * 5
                       + [_LL, _P, _P, _P]),
    "lynx_kde_grad": (ctypes.c_int, _OPERANDS + [_P, _LL, _LL, ctypes.c_int, ctypes.c_int,
                                                _P, _P, _P, _P]),
}


def kde_library() -> ctypes.CDLL:
    """Kernel B9's library, built with nvcc at first use."""
    return load_library("kde", _B9_SIGNATURE)


def _check_operands(x: Tensor, y: Tensor, weights: Optional[Tensor], x_centres: Tensor,
                    y_centres: Tensor) -> None:
    """Raise ``ValueError`` on what B9 does not take: dtypes other than one
    float32 or float64 for all, operands on two devices, particles not
    ``(S, N)`` alike, centres not contiguous ``(W,)`` and ``(H,)`` with at
    least one pixel, more than 32,767 settings (the gradient's grid)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kde_sums: B9 takes float32 or float64, got {x.dtype}")
    named = {"y": y, "weights": weights, "x_centres": x_centres, "y_centres": y_centres}
    for name, t in named.items():
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"kde_sums: {name} is {t.dtype} on {t.device}; B9 takes every"
                             f" operand as x's {x.dtype} on {x.device}")
    if x.ndim != 2 or y.shape != x.shape or (weights is not None and weights.shape != x.shape):
        raise ValueError("kde_sums: B9 takes x, y and weights as one (S, N) shape, got"
                         f" {tuple(x.shape)}, {tuple(y.shape)},"
                         f" {None if weights is None else tuple(weights.shape)}")
    if x.shape[0] > 32767:
        raise ValueError(f"kde_sums: B9 takes at most 32,767 settings, got {x.shape[0]}")
    for name in ("x_centres", "y_centres"):
        if named[name].ndim != 1 or not named[name].is_contiguous() or not len(named[name]):
            raise ValueError(f"kde_sums: B9 takes {name} as one contiguous, non-empty axis, got"
                             f" shape {tuple(named[name].shape)}, strides {named[name].stride()}")


def _bandwidth(bandwidth, like: Tensor) -> Tuple[Optional[Tensor], float]:
    """``(tensor, number)``: a tensor bandwidth as a 0-d tensor of ``like``'s
    dtype on its device, which the kernels read (a CPU tensor beside CUDA
    particles gives its number instead, without a sync), or None and the
    number."""
    if isinstance(bandwidth, Tensor):
        if bandwidth.numel() != 1:
            raise ValueError(f"kde_sums: the bandwidth is one number, got {tuple(bandwidth.shape)}")
        if bandwidth.device.type != "cpu" or like.device.type == "cpu":
            return bandwidth.detach().to(like.device, like.dtype).reshape(()), 0.0
        bandwidth = float(bandwidth)
    return None, float(bandwidth)


def _operands(x, y, weights, x_centres, y_centres, h_tensor, h):
    """The leading arguments of B9's entry points."""
    strides = [*x.stride(), *y.stride(), *(weights.stride() if weights is not None else (0, 0))]
    return (int(x.dtype == torch.float64), x.data_ptr(), y.data_ptr(),
            None if weights is None else weights.data_ptr(), *strides, x_centres.data_ptr(),
            y_centres.data_ptr(), None if h_tensor is None else h_tensor.data_ptr(), h)


def _image_call(library, x, y, weights, x_centres, y_centres, bandwidth, plan: KdePlan,
                stream) -> Tensor:
    """B9's forward through ``library`` on ``stream``: the ``(S, H, W)``
    images of checked operands under ``plan``."""
    S, N = x.shape
    H, W = y_centres.shape[0], x_centres.shape[0]
    out = x.new_empty((S, H, W))
    parts = x.new_empty((S, plan.splits, H, W)) if plan.splits > 1 else None
    h_tensor, h = _bandwidth(bandwidth, x)
    code = library.lynx_kde_image(
        *_operands(x, y, weights, x_centres, y_centres, h_tensor, h), S, N, H, W, *plan,
        None if parts is None else parts.data_ptr(), out.data_ptr(), stream)
    check(library, code, "kde_image")
    return out


def _grad_call(library, x, y, weights, x_centres, y_centres, bandwidth, grad: Tensor,
               need_x: bool, need_y: bool, need_w: bool, stream):
    """B9's backward through ``library`` on ``stream``: ``(gx, gy, gw)`` for
    the images' cotangent ``grad`` (contiguous ``(S, H, W)``), None where not
    wanted."""
    S, N = x.shape
    H, W = y_centres.shape[0], x_centres.shape[0]
    if grad.shape != (S, H, W) or grad.dtype != x.dtype or not grad.is_contiguous():
        raise ValueError(f"kde_sums: B9's backward takes a contiguous {x.dtype} cotangent of"
                         f" shape {(S, H, W)}, got {grad.dtype} {tuple(grad.shape)}")
    gx, gy = (x.new_empty((S, N)) if need else None for need in (need_x, need_y))
    gw = x.new_empty((S, N)) if need_w and weights is not None else None
    h_tensor, h = _bandwidth(bandwidth, x)
    code = library.lynx_kde_grad(
        *_operands(x, y, weights, x_centres, y_centres, h_tensor, h), grad.data_ptr(), S, N, H,
        W, *(None if g is None else g.data_ptr() for g in (gx, gy, gw)), stream)
    check(library, code, "kde_grad")
    return gx, gy, gw


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _KdeKernel(torch.autograd.Function):
    """Kernel B9 (see the module's note) on CUDA ``(S, N)`` particles."""

    @staticmethod
    def forward(ctx, x, y, weights, x_centres, y_centres, bandwidth):
        _check_operands(x, y, weights, x_centres, y_centres)
        if x.device.type != "cuda":
            raise ValueError(f"kde_sums: B9 runs on CUDA tensors, got {x.device}")
        ctx.save_for_backward(x, y, weights, x_centres, y_centres)
        ctx.bandwidth = bandwidth
        plan = kde_plan(*x.shape, y_centres.shape[0], x_centres.shape[0], _sm_count(x.device),
                        x.dtype)
        library = kde_library()
        with torch.cuda.device(x.device), profiling.span("kernel.kde"):
            raw = _image_call(library, x, y, weights, x_centres, y_centres, bandwidth, plan,
                              torch.cuda.current_stream(x.device).cuda_stream)
        kde_sums.launches += 1 + (plan.splits > 1)
        return raw

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, y, weights, x_centres, y_centres = ctx.saved_tensors
        need_x, need_y, need_w = ctx.needs_input_grad[:3]
        grad = grad.contiguous()
        library = kde_library()
        with torch.cuda.device(x.device), profiling.span("kernel.kde_bwd"):
            grads = _grad_call(library, x, y, weights, x_centres, y_centres, ctx.bandwidth, grad,
                               need_x, need_y, need_w,
                               torch.cuda.current_stream(x.device).cuda_stream)
        kde_sums.launches += 1
        return (*grads, None, None, None)


def kde_sums(x: Tensor, y: Tensor, weights: Optional[Tensor], x_centres: Tensor,
             y_centres: Tensor, bandwidth: Union[float, Tensor], block: int = None) -> Tensor:
    """``(..., H, W)`` unnormalised KDE images (see the module's note) of the
    particles at ``x``, ``y`` ``(..., N)`` with ``weights`` (broadcast to
    ``x``; None for 1), on the pixels' centres ``x_centres`` ``(W,)`` and
    ``y_centres`` ``(H,)``, with bandwidth ``bandwidth`` (a number or a 0-d
    tensor), differentiable in ``x``, ``y`` and ``weights``.  CUDA tensors
    launch kernel B9; CPU tensors take the blocked route in blocks of
    ``block`` (default :data:`BLOCK`) particles."""
    batch, n = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, n)
    y = torch.broadcast_to(y, (*batch, n)).reshape(-1, n)
    if weights is not None:
        weights = torch.broadcast_to(weights, (*batch, n)).reshape(-1, n)
    if x.device.type == "cpu":
        raw = _BlockedSums.apply(x, y, weights, x_centres, y_centres, bandwidth, block or BLOCK)
    else:
        raw = _KdeKernel.apply(x, y, weights, x_centres, y_centres, bandwidth)
    return raw.reshape(*batch, *raw.shape[-2:])


kde_sums.blocks = 0
kde_sums.launches = 0


def normalised(raw: Tensor) -> Tensor:
    """Each ``(H, W)`` image over its sum plus :data:`NORM_EPS`."""
    return raw / (raw.sum(dim=(-2, -1), keepdim=True) + NORM_EPS)


__all__ = ["BLOCK", "KdePlan", "kde_plan", "kde_sums", "kde_sums_reference", "normalised"]
