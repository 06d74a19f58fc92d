"""Weighted 2-D histogram for diagnostic screens (counterpart of
``lynx_tpu.ops.histogram``).

Two routes give the same image:

* :func:`weighted_histogram_2d`, the plain scatter: uniform-bin index
  arithmetic plus one ``index_add_`` into the full image, with an overflow
  slot that absorbs out-of-range particles.  It runs for CPU tensors.
* :func:`windowed_histogram_2d`, for CUDA tensors: each batch row is binned
  into a small window placed at the row's lowest live bin, by the
  hand-written CUDA kernel B1 (``csrc/window_histogram.cu``, wrapper
  :func:`window_histogram`), and the window is then placed into the full
  image.  When any live particle lands outside the window the read falls
  back to the exact scatter, and :func:`histogram_fallback_count` counts it.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import torch

from lynx_tpu_torch._build import check, load_library

Tensor = torch.Tensor


def _bin_index(v: Tensor, lo, hi, n: int) -> Tuple[Tensor, Tensor]:
    """Uniform-bin index + in-range mask for one axis.

    Shared by the scatter, the windowed prologue and :func:`window_fits`,
    and evaluated in the JAX package's operation order: these must stay
    bit-identical or the audit stops predicting the routing.  Bounds that
    are tensors are promoted with ``v`` the way JAX promotes them."""
    bounds = [b for b in (lo, hi) if isinstance(b, Tensor)]
    if bounds:
        dtype = v.dtype
        for b in bounds:
            dtype = torch.promote_types(dtype, b.dtype)
        v = v.to(dtype)
        lo, hi = (b.to(dtype) if isinstance(b, Tensor) else b for b in (lo, hi))
    scaled = (v - lo) / (hi - lo) * n
    idx = torch.clamp(torch.floor(scaled), 0, n - 1).to(torch.int32)
    return idx, (v >= lo) & (v <= hi)


def _window_origin(idx: Tensor, live: Tensor, n: int, win: int) -> Tensor:
    """Per-batch-row window origin: the minimum live bin index, clipped so
    that the window stays inside the image."""
    lowest = torch.where(live, idx, n).amin(dim=-1)
    return torch.clamp(lowest, 0, max(n - win, 0))


def weighted_histogram_2d(
    x: Tensor,
    y: Tensor,
    weights: Tensor,
    x_range: Tuple,
    y_range: Tuple,
    bins: Tuple[int, int],
) -> Tensor:
    """Histogram of shape ``(..., bins_x, bins_y)`` over the last dim of x/y.

    Bin edges follow ``numpy.histogram2d`` with uniform edges: values on
    interior edges fall into the right bin; the last bin is closed.

    :param x, y: ``(..., N)`` coordinates.
    :param weights: per-particle weights broadcastable to ``(..., N)``.
    :param x_range, y_range: (lo, hi) scalars.
    :param bins: (nx, ny) bin counts.
    :return: ``(..., nx, ny)`` weighted histogram in the weights' dtype.
    """
    nx, ny = int(bins[0]), int(bins[1])
    ix, vx = _bin_index(x, x_range[0], x_range[1], nx)
    iy, vy = _bin_index(y, y_range[0], y_range[1], ny)
    valid = vx & vy
    size = nx * ny + 1  # + the overflow slot
    flat = torch.where(valid, ix.to(torch.int64) * ny + iy, nx * ny)

    batch_shape = flat.shape[:-1]
    n = flat.shape[-1]
    flat = flat.reshape(-1, n)
    rows = flat.shape[0]
    flat = flat + torch.arange(rows, device=flat.device)[:, None] * size
    w = torch.broadcast_to(weights, (*batch_shape, n)).reshape(-1)
    out = torch.zeros(rows * size, dtype=w.dtype, device=w.device)
    out = out.index_add(0, flat.reshape(-1), w)
    return out.view(rows, size)[:, : nx * ny].reshape(*batch_shape, nx, ny)


# -- Fallback instrumentation -----------------------------------------------

#: Count of windowed reads that fell back to the exact scatter in this
#: process: the fallback is a performance cliff unless counted.
_FALLBACK_STATE = {"count": 0}
_log = logging.getLogger(__name__)


def histogram_fallback_count() -> int:
    """How many windowed-histogram reads fell back to the scatter path in
    this process."""
    return _FALLBACK_STATE["count"]


def reset_histogram_fallback_count() -> None:
    _FALLBACK_STATE["count"] = 0


def _note_fallback() -> None:
    _FALLBACK_STATE["count"] += 1
    count = _FALLBACK_STATE["count"]
    if count & (count - 1) == 0:  # log at 1, 2, 4, 8, ...
        _log.info(
            "windowed screen histogram fell back to the exact scatter path"
            " (spot larger than the window; occurrence %d in this process)."
            " Consider Screen.derive_histogram_window for the working point,"
            " or a larger Screen.histogram_window.",
            count,
        )


#: Default window side in pixels.  Pass a per-axis ``(win_x, win_y)`` matched
#: to the beam spot instead where the spot is not square.
WINDOW = 512


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def _joint_batch(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """x and y broadcast to their joint batch shape (batch dims may arrive
    on either)."""
    batch_shape = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    return (
        torch.broadcast_to(x, (*batch_shape, x.shape[-1])),
        torch.broadcast_to(y, (*batch_shape, y.shape[-1])),
    )


def _window_shape(window, nx: int, ny: int) -> Tuple[int, int]:
    """The window in bins, rounded up as the JAX package rounds it (8 in x,
    128 in y) so that both take the fallback for the same beams."""
    if isinstance(window, (int, float)):
        window_x = window_y = int(window)
    else:
        window_x, window_y = int(window[0]), int(window[1])
    return (
        min(_round_up(window_x, 8), _round_up(nx, 8)),
        min(_round_up(window_y, 128), _round_up(ny, 128)),
    )


def window_fits(
    x: Tensor,
    y: Tensor,
    weights: Tensor,
    x_range,
    y_range,
    bins: Tuple[int, int],
    window,
    per_row: bool = True,
) -> Tensor:
    """Audit of the windowed routing decision: True where a read takes the
    windowed kernel, False where it takes the scatter.

    False has two causes: a live particle lands outside the origin-tracked
    window (the counted fallback), or the rounded window covers the whole
    image, where the scatter is taken unconditionally.  ``per_row=False``
    reduces over the batch, which is the decision one call makes."""
    nx, ny = int(bins[0]), int(bins[1])
    window = _window_shape(window, nx, ny)
    x, y = _joint_batch(x, y)
    if window[0] >= nx and window[1] >= ny:
        fits = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    else:
        ranges = (x_range[0], x_range[1], y_range[0], y_range[1])
        fits = window_prologue(x, y, weights, ranges, (nx, ny), window)[-1]
        fits = fits.reshape(x.shape[:-1])
    return fits if per_row else torch.all(fits)


# -- Kernel B1: the windowed histogram ---------------------------------------


def window_histogram_reference(
    lx: Tensor, ly: Tensor, weights: Optional[Tensor], win_x: int, win_y: int
) -> Tensor:
    """Plain PyTorch version of kernel B1: ``(B, win_x, win_y)`` histograms
    of the local indices ``lx``, ``ly`` (``(B, N)``, -1 = masked).

    Count mode (``weights is None``) returns int32 counts; weighted mode
    sums the weights in their own dtype."""
    B = lx.shape[0]
    inside = (lx >= 0) & (ly >= 0) & (lx < win_x) & (ly < win_y)
    rows = torch.arange(B, device=lx.device)[:, None]
    overflow = B * win_x * win_y
    flat = torch.where(inside, (rows * win_x + lx) * win_y + ly, overflow)
    if weights is None:
        values = torch.ones(lx.shape, dtype=torch.int32, device=lx.device)
    else:
        values = torch.broadcast_to(weights, lx.shape)
    out = torch.zeros(overflow + 1, dtype=values.dtype, device=lx.device)
    out.index_put_((flat.reshape(-1),), values.reshape(-1), accumulate=True)
    return out[:overflow].view(B, win_x, win_y)


#: C signature of B1's entry point: lx, ly, weights, out (pointers), batch,
#: n (64-bit), win_x, win_y, stream.
_B1_SIGNATURE = {
    "lynx_window_histogram": (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    )
}


def window_histogram_library() -> ctypes.CDLL:
    """Kernel B1's library, built with nvcc at first use."""
    return load_library("window_histogram", _B1_SIGNATURE)


def _window_histogram_cuda(
    lx: Tensor, ly: Tensor, weights: Optional[Tensor], win_x: int, win_y: int
) -> Tensor:
    """Launch kernel B1 on the current stream (no synchronisation)."""
    operands = [lx, ly] + ([weights] if weights is not None else [])
    for t in operands:
        if not t.is_cuda or t.device != lx.device:
            raise ValueError("window_histogram: operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("window_histogram: operands must be contiguous")
    if lx.ndim != 2 or ly.shape != lx.shape:
        raise ValueError(f"window_histogram: lx, ly must be (B, N), got {lx.shape}, {ly.shape}")
    if lx.dtype != torch.int32 or ly.dtype != torch.int32:
        raise ValueError("window_histogram: lx, ly must be int32")
    if weights is not None and (weights.dtype != torch.float32 or weights.shape != lx.shape):
        raise ValueError("window_histogram: weights must be float32 of the shape of lx")
    if win_x <= 0 or win_y <= 0:
        raise ValueError(f"window_histogram: bad window ({win_x}, {win_y})")

    library = window_histogram_library()
    B, N = lx.shape
    out = torch.zeros(
        (B, win_x, win_y),
        dtype=torch.int32 if weights is None else torch.float32,
        device=lx.device,
    )
    with torch.cuda.device(lx.device):
        stream = torch.cuda.current_stream(lx.device).cuda_stream
        code = library.lynx_window_histogram(
            lx.data_ptr(),
            ly.data_ptr(),
            None if weights is None else weights.data_ptr(),
            out.data_ptr(),
            B,
            N,
            win_x,
            win_y,
            stream,
        )
    check(library, code, "window_histogram")
    window_histogram.launches += 1
    return out


def window_histogram(
    lx: Tensor, ly: Tensor, weights: Optional[Tensor], win_x: int, win_y: int
) -> Tensor:
    """Kernel B1: ``(B, win_x, win_y)`` histograms of in-window local bin
    indices (``(B, N)`` int32, -1 = masked), int32 counts when ``weights``
    is None, else float32 sums of ``(B, N)`` float32 weights.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, :func:`window_histogram_reference`.
    ``window_histogram.launches`` counts kernel launches."""
    if lx.device.type == "cpu":
        return window_histogram_reference(lx, ly, weights, win_x, win_y)
    return _window_histogram_cuda(lx, ly, weights, win_x, win_y)


window_histogram.launches = 0


def _place(wins: Tensor, ox: Tensor, oy: Tensor, nx: int, ny: int) -> Tensor:
    """Place each row's window into a zero ``(B, nx, ny)`` image at its
    origin, in one indexed write (no host round trip)."""
    B, wx, wy = wins.shape
    device = wins.device
    out = torch.zeros((B, nx, ny), dtype=wins.dtype, device=device)
    rows = ox[:, None] + torch.arange(wx, device=device)
    cols = oy[:, None] + torch.arange(wy, device=device)
    batch = torch.arange(B, device=device)[:, None, None]
    out[batch, rows[:, :, None], cols[:, None, :]] = wins
    return out


def window_prologue(x, y, weights, ranges, bins, window):
    """The windowed read's prologue: ``(lx, ly, ox, oy, fits)`` with
    ``lx``, ``ly`` the ``(B, N)`` int32 local bin indices that kernel B1
    takes (-1 = dead, out of range or out of window), ``ox``, ``oy`` the
    ``(B,)`` window origins and ``fits`` the ``(B,)`` bool rows whose live
    particles all lie inside the row's window.  ``x`` and ``y`` share their
    batch shape, which flattens to B."""
    (x_lo, x_hi, y_lo, y_hi), (nx, ny), (win_x, win_y) = ranges, bins, window
    ix, vx = _bin_index(x, x_lo, x_hi, nx)
    iy, vy = _bin_index(y, y_lo, y_hi, ny)
    live = vx & vy & (torch.broadcast_to(weights, ix.shape) != 0)

    ox = _window_origin(ix, live, nx, win_x)
    oy = _window_origin(iy, live, ny, win_y)
    lx = ix - ox[..., None]
    ly = iy - oy[..., None]
    in_window = (lx >= 0) & (lx < win_x) & (ly >= 0) & (ly < win_y)
    fits = ~torch.any(live & ~in_window, dim=-1).reshape(-1)
    masked = live & in_window
    n = lx.shape[-1]
    lx = torch.where(masked, lx, -1).reshape(-1, n).contiguous()
    ly = torch.where(masked, ly, -1).reshape(-1, n).contiguous()
    return lx, ly, ox.reshape(-1), oy.reshape(-1), fits


def _windowed_forward(x, y, weights, ranges, bins, window, binary_weights):
    (x_lo, x_hi, y_lo, y_hi), (nx, ny), (win_x, win_y) = ranges, bins, window
    lx, ly, ox, oy, fits = window_prologue(x, y, weights, ranges, bins, window)
    # One decision for the whole batch, as JAX's lax.cond makes it.  Unlike
    # lax.cond this reads the flag on the host: one sync per read.
    if not bool(fits.all()):
        _note_fallback()
        return weighted_histogram_2d(x, y, weights, (x_lo, x_hi), (y_lo, y_hi), bins)

    batch_shape, n = x.shape[:-1], x.shape[-1]
    w_b = torch.broadcast_to(weights, x.shape)
    kernel_weights = None
    if not binary_weights:
        kernel_weights = w_b.reshape(-1, n)
        if kernel_weights.is_cuda:  # the kernel sums float32 weights
            kernel_weights = kernel_weights.to(torch.float32)
        kernel_weights = kernel_weights.contiguous()
    wins = window_histogram(lx, ly, kernel_weights, win_x, win_y).to(w_b.dtype)
    # Rounding can push the window past the image edge on an axis it fully
    # covers (origin 0 there): crop before placing.
    wins = wins[:, : min(win_x, nx), : min(win_y, ny)]
    return _place(wins, ox, oy, nx, ny).reshape(*batch_shape, nx, ny)


class _WindowedHistogram(torch.autograd.Function):
    """The windowed histogram with its weight-only VJP.

    The image is linear in the weights (positions only move mass between
    bins, a piecewise-constant effect), so the cotangent of the weights is
    the image cotangent gathered at each particle's bin; x and y get none."""

    @staticmethod
    def forward(ctx, x, y, weights, ranges, bins, window, binary_weights):
        ctx.save_for_backward(x, y)
        ctx.ranges, ctx.bins, ctx.weights_meta = ranges, bins, (weights.shape, weights.dtype)
        return _windowed_forward(x, y, weights, ranges, bins, window, binary_weights)

    @staticmethod
    def backward(ctx, d_out):
        if not ctx.needs_input_grad[2]:
            return None, None, None, None, None, None, None
        x, y = ctx.saved_tensors
        x_lo, x_hi, y_lo, y_hi = ctx.ranges
        nx, ny = ctx.bins
        ix, vx = _bin_index(x, x_lo, x_hi, nx)
        iy, vy = _bin_index(y, y_lo, y_hi, ny)
        valid = vx & vy
        flat = torch.where(valid, ix.to(torch.int64) * ny + iy, 0)
        d_flat = d_out.reshape(*d_out.shape[:-2], nx * ny)
        d_flat = torch.broadcast_to(d_flat, (*ix.shape[:-1], nx * ny))
        gathered = torch.gather(d_flat, -1, flat)
        d_w = torch.where(valid, gathered, 0.0)
        shape, dtype = ctx.weights_meta
        return None, None, d_w.sum_to_size(shape).to(dtype), None, None, None, None


def windowed_histogram_2d(
    x: Tensor,
    y: Tensor,
    weights: Tensor,
    x_range: Tuple,
    y_range: Tuple,
    bins: Tuple[int, int],
    window=WINDOW,
    binary_weights: bool = False,
) -> Tensor:
    """Drop-in replacement for :func:`weighted_histogram_2d` (same result)
    through kernel B1 when every live particle fits a ``window``-sized box
    around the spot, and through the scatter otherwise.

    :param window: box size in pixels, an int or a per-axis
        ``(win_x, win_y)``; rounded up to 8 in x and 128 in y.
    :param binary_weights: promise that every weight is exactly 0 or 1:
        the kernel then counts (int32, exact) and reads no weights.
    """
    nx, ny = int(bins[0]), int(bins[1])
    win_x, win_y = _window_shape(window, nx, ny)
    if win_x >= nx and win_y >= ny:  # windowing buys nothing
        return weighted_histogram_2d(x, y, weights, x_range, y_range, bins)
    x, y = _joint_batch(x, y)
    ranges = (x_range[0], x_range[1], y_range[0], y_range[1])
    return _WindowedHistogram.apply(
        x, y, weights, ranges, (nx, ny), (win_x, win_y), binary_weights
    )


#: Histogram route for screen readings: ``None`` = by device (the windowed
#: kernel for CUDA tensors, the scatter for CPU tensors); ``True``/``False``
#: force the windowed/scatter route (tests, A/B timing).
SCREEN_WINDOWED_PATH = None


def screen_histogram_2d(
    x: Tensor,
    y: Tensor,
    weights: Tensor,
    x_range: Tuple,
    y_range: Tuple,
    bins: Tuple[int, int],
    window=None,
    binary_weights: bool = False,
) -> Tensor:
    """The screen-reading histogram, routed by the device of ``x``."""
    use_windowed = SCREEN_WINDOWED_PATH
    if use_windowed is None:
        use_windowed = x.is_cuda
    if use_windowed:
        return windowed_histogram_2d(
            x, y, weights, x_range, y_range, bins,
            window=WINDOW if window is None else window,
            binary_weights=binary_weights,
        )
    return weighted_histogram_2d(x, y, weights, x_range, y_range, bins)
