"""Weighted 2-D histogram for diagnostic screens (counterpart of
``lynx_tpu.ops.histogram``).

Two routes give the same image:

* :func:`weighted_histogram_2d`, the plain scatter: uniform-bin index
  arithmetic plus one ``index_add_`` into the full image, with an overflow
  slot that absorbs out-of-range particles.  It runs for CPU tensors.
* :func:`windowed_histogram_2d`, for CUDA tensors: each batch row is binned
  into a small window placed at the row's lowest live bin.  On the card
  the whole read, from the coordinates to the placed image, is the
  hand-written CUDA kernel B1 (``csrc/window_histogram.cu``, wrapper
  :func:`windowed_read`, plain version :func:`windowed_read_reference`).
  When any live particle lands outside the window the read falls back to
  the exact scatter, and :func:`histogram_fallback_count` counts it.
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


# -- Kernel B1: the windowed read ---------------------------------------------


def window_histogram_reference(
    lx: Tensor, ly: Tensor, weights: Optional[Tensor], win_x: int, win_y: int
) -> Tensor:
    """Plain PyTorch version of kernel B1's (lx, ly) count core: ``(B,
    win_x, win_y)`` histograms of the local indices ``lx``, ``ly`` (``(B,
    N)``, -1 = masked).

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


#: C signatures of B1's entry points: the (lx, ly) count core (lx, ly,
#: weights, out, batch, n, win_x, win_y, stream) and the fused read (x, y,
#: w, strides[6], bound pointers[4], bound steps[4], bound values[6],
#: divide[2], image, tail, bins, batch, n, nx, ny, win_x, win_y, t_double,
#: w_double, weighted, stream).
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_B1_SIGNATURE = {
    "lynx_window_histogram": (_I, [_P] * 4 + [_L] * 2 + [_I] * 2 + [_P]),
    "lynx_windowed_read": (
        _I,
        [_P] * 3
        + [ctypes.POINTER(_L), ctypes.POINTER(_P), ctypes.POINTER(_L),
           ctypes.POINTER(ctypes.c_double), ctypes.POINTER(_I)]
        + [_P] * 3 + [_L, _L] + [_I] * 7 + [_P],
    ),
}


def window_histogram_library() -> ctypes.CDLL:
    """Kernel B1's library, built with nvcc at first use."""
    return load_library("window_histogram", _B1_SIGNATURE)


def _window_histogram_cuda(
    lx: Tensor, ly: Tensor, weights: Optional[Tensor], win_x: int, win_y: int
) -> Tensor:
    """Launch B1's count core on the current stream (no synchronisation)."""
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
    """Kernel B1's (lx, ly) count core: ``(B, win_x, win_y)`` histograms of
    in-window local bin indices (``(B, N)`` int32, -1 = masked), int32
    counts when ``weights`` is None, else float32 sums of ``(B, N)``
    float32 weights.  The screen read takes :func:`windowed_read`; this
    core is the yardstick of the count-histogram A/B and of the read's
    timing.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, :func:`window_histogram_reference`.
    ``window_histogram.launches`` counts the launches of every B1 kernel,
    the fused read's included."""
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
    ``lx``, ``ly`` the ``(B, N)`` int32 local bin indices that the count
    core takes (-1 = dead, out of range or out of window), ``ox``, ``oy``
    the ``(B,)`` window origins and ``fits`` the ``(B,)`` bool rows whose
    live particles all lie inside the row's window.  ``x`` and ``y`` share
    their batch shape, which flattens to B."""
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


def windowed_read_reference(x, y, weights, ranges, bins, window, binary_weights):
    """Plain PyTorch version of kernel B1's fused read:
    ``(image, ox, oy, fits)``.

    :func:`window_prologue`, then :func:`window_histogram_reference` (int32
    counts when ``binary_weights``, else the weights' sums in their dtype)
    and :func:`_place`: the ``(*batch, nx, ny)`` image in the weights'
    dtype, holding each row's window at its origin (rounding can push the
    window past the image's edge on an axis it fully covers, origin 0
    there: the window is cropped).  A live particle outside its row's window
    is left out of the image, and its row's ``fits`` is False.  ``x`` and
    ``y`` share their batch shape; ``ox``, ``oy`` (int32) and ``fits`` are
    ``(B,)``; ``window`` is already rounded (:func:`_window_shape`)."""
    (nx, ny), (win_x, win_y) = bins, window
    lx, ly, ox, oy, fits = window_prologue(x, y, weights, ranges, bins, window)
    batch_shape, n = x.shape[:-1], x.shape[-1]
    w_b = torch.broadcast_to(weights, x.shape)
    summed = None if binary_weights else w_b.reshape(-1, n)
    wins = window_histogram_reference(lx, ly, summed, win_x, win_y).to(w_b.dtype)
    wins = wins[:, : min(win_x, nx), : min(win_y, ny)]
    image = _place(wins, ox, oy, nx, ny).reshape(*batch_shape, nx, ny)
    return image, ox, oy, fits


_MAX_BINS = 32767  # the packed bins keep 15 bits an axis
_EXACT_FLOAT_COUNTS = 1 << 24  # float32 counts stay exact below 2^24 a cell
#: Kernel launches of one fused read: the packed bins, then the count.
READ_LAUNCHES = 2


def _read_launch(library, x, y, weights, ranges, bins, window, binary_weights, stream):
    """Marshal one fused read for ``library``'s entry point and call it:
    ``(code, image, ox, oy, misfit)``.  A tensor bound on ``x``'s device is
    read from its memory; any other bound is passed as a host value.  No
    device checks: the caller's."""
    (nx, ny), (win_x, win_y) = (int(b) for b in bins), window
    batch_shape, n = x.shape[:-1], x.shape[-1]
    weights = torch.broadcast_to(weights, x.shape)
    if y.shape != x.shape:
        raise ValueError(f"windowed_read: x and y must share their shape, got {x.shape}, {y.shape}")
    if max(nx, ny) > _MAX_BINS or min(nx, ny) < 1:
        raise ValueError(f"windowed_read: bins {bins} outside 1..{_MAX_BINS}")
    if weights.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"windowed_read: weights must be float32 or float64, got {weights.dtype}")
    # The compute type, promoted with tensor bounds as _bin_index promotes.
    dtype = x.dtype
    for bound in ranges:
        if isinstance(bound, Tensor):
            dtype = torch.promote_types(dtype, bound.dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"windowed_read: coordinates must be float32 or float64, got {dtype}")
    if binary_weights and weights.dtype == torch.float32 and n >= _EXACT_FLOAT_COUNTS:
        raise ValueError("windowed_read: float32 counts are exact below 2^24 particles a row")
    x2, y2 = (t.to(dtype).reshape(-1, n) for t in (x, y))  # views where x, y are the dtype
    w2 = weights.reshape(-1, n)
    B = x2.shape[0]

    def in_memory(bound):
        return isinstance(bound, Tensor) and bound.device == x.device

    bounds = []  # (tensor or None, step, host value) of lo_x, hi_x, lo_y, hi_y
    for bound in ranges:
        if in_memory(bound):
            flat = bound.to(dtype).reshape(-1).contiguous()
            if flat.numel() not in (1, B):
                raise ValueError(f"windowed_read: a range bound of {flat.numel()} values, B={B}")
            bounds.append((flat, 0 if flat.numel() == 1 else 1, 0.0))
        else:
            bounds.append((None, 0, float(bound)))
    spans = []  # (divide on the card, host span) of each axis
    for lo, hi in (ranges[:2], ranges[2:]):
        # _bin_index's span: one formed from a bound in device memory is a
        # device tensor, divided by; a host one (Python numbers, CPU
        # tensors) becomes PyTorch's product by its reciprocal, rounded in
        # the compute type.
        if in_memory(lo) or in_memory(hi):
            spans.append((1, 0.0))
        else:
            lo, hi = (b.to(dtype) if isinstance(b, Tensor) else b for b in (lo, hi))
            spans.append((0, float(hi - lo)))
    pointers = (_P * 4)(*(None if t is None else t.data_ptr() for t, _, _ in bounds))
    steps = (_L * 4)(*(step for _, step, _ in bounds))
    values = (ctypes.c_double * 6)(bounds[0][2], bounds[1][2], spans[0][1],
                                   bounds[2][2], bounds[3][2], spans[1][1])
    divide = (_I * 2)(spans[0][0], spans[1][0])
    strides = (_L * 6)(*x2.stride(), *y2.stride(), *w2.stride())

    # One zeroed buffer: the image, then the tail (int32 tops and origins,
    # 4 B of them, then B misfit bytes), in the weights' dtype.
    cells = B * nx * ny
    item = weights.element_size()
    buffer = torch.zeros(cells + -(-17 * B // item) + 1, dtype=weights.dtype, device=x.device)
    image = buffer[:cells].view(B, nx, ny)
    tail = buffer[cells:].view(torch.uint8)
    tail_ints = tail[: 16 * B].view(torch.int32)
    misfit = tail[16 * B: 17 * B].view(torch.bool)
    workspace = torch.empty((B, n), dtype=torch.int32, device=x.device)  # the packed bins
    code = library.lynx_windowed_read(
        x2.data_ptr(), y2.data_ptr(), w2.data_ptr(), strides, pointers, steps, values, divide,
        image.data_ptr(), tail.data_ptr(), workspace.data_ptr(), B, n, nx, ny, win_x, win_y,
        int(dtype == torch.float64), int(weights.dtype == torch.float64),
        int(not binary_weights), stream,
    )
    image = image.reshape(*batch_shape, nx, ny)
    return code, image, tail_ints[2 * B: 3 * B], tail_ints[3 * B:], misfit


def _windowed_read_cuda(x, y, weights, ranges, bins, window, binary_weights):
    """Launch kernel B1's fused read on the current stream (no
    synchronisation): ``(image, ox, oy, misfit)``, ``misfit`` the ``(B,)``
    bool rows that do not fit their window.  The image and the small tail
    that carries the origins and misfits come from one ``torch.zeros``."""
    weights = torch.broadcast_to(weights, x.shape)
    on_card = [b for b in ranges if isinstance(b, Tensor) and b.is_cuda]
    for t in [x, y, weights, *on_card]:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("windowed_read: x, y, weights and ranges must share one CUDA device")
    library = window_histogram_library()
    with torch.cuda.device(x.device):
        code, image, ox, oy, misfit = _read_launch(
            library, x, y, weights, ranges, bins, window, binary_weights,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(library, code, "windowed_read")
    window_histogram.launches += READ_LAUNCHES
    return image, ox, oy, misfit


def windowed_read(x, y, weights, ranges, bins, window, binary_weights):
    """Kernel B1, the fused windowed read: ``(image, ox, oy, fits)`` as
    :func:`windowed_read_reference` gives them, from the coordinates (as
    ``(*batch, N)`` views with their strides: no copy), the weights and the
    ranges (0-d tensors as the screen passes them, one-a-row tensors, or
    Python numbers), in two launches.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  ``window_histogram.launches`` counts B1's launches."""
    if not x.is_cuda:
        return windowed_read_reference(x, y, weights, ranges, bins, window, binary_weights)
    image, ox, oy, misfit = _windowed_read_cuda(
        x, y, weights, ranges, bins, window, binary_weights
    )
    return image, ox, oy, ~misfit


def _windowed_forward(x, y, weights, ranges, bins, window, binary_weights):
    (x_lo, x_hi, y_lo, y_hi) = ranges
    if x.is_cuda:
        image, _, _, misfit = _windowed_read_cuda(x, y, weights, ranges, bins, window,
                                                  binary_weights)
        fits = not bool(misfit.any())
    else:
        image, _, _, fits = windowed_read_reference(x, y, weights, ranges, bins, window,
                                                    binary_weights)
        fits = bool(fits.all())
    # One decision for the whole batch, as JAX's lax.cond makes it.  Unlike
    # lax.cond this reads the flag on the host: one sync per read.
    if not fits:
        _note_fallback()
        return weighted_histogram_2d(x, y, weights, (x_lo, x_hi), (y_lo, y_hi), bins)
    return image


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
