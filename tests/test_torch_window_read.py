"""The plain version of kernel B1's fused windowed read
(``windowed_read_reference``: prologue, count core and placement in one
call) against the JAX package's windowed read.

The same coordinates (numpy, seeded) go through both packages.  JAX's
read is taken apart as ``windowed_matmul_histogram_2d`` composes it: its
prologue (``_bin_index``, ``_window_origin``), its Pallas kernel
(``_window_matmul_hist``, in interpret mode) and the placement, so that a
spot that falls back is compared too (the window-only image, and ``fits``
False for its row); where every row fits, the image is also held against
the public ``windowed_matmul_histogram_2d``.  Weighted mode uses dyadic
weights, which JAX's float32 kernel sums exactly, so every comparison is
exact: the image, the origins and ``fits``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lynx_tpu.ops.histogram as jax_hist
import lynx_tpu_torch.ops.histogram as torch_hist

BINS = (306, 255)  # an eighth-resolution ARES screen
RANGES = (-4.3e-3, 4.3e-3, -2.5e-3, 2.5e-3)
WINDOW = (64, 128)
N = 3000


@pytest.fixture
def interpreted_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def spot(B, dtype, sigma_px, seed):
    """B rows of a Gaussian spot, each row's centre moved; a tenth of the
    particles dead (weight 0) and three out of range; dyadic weights."""
    rng = np.random.default_rng(seed)
    lo_x, hi_x, lo_y, hi_y = RANGES
    px, py = (hi_x - lo_x) / BINS[0], (hi_y - lo_y) / BINS[1]
    cx = 150.0 + 30.0 * np.arange(B)[:, None]
    cy = 120.0 - 25.0 * np.arange(B)[:, None]
    x = lo_x + px * (cx + sigma_px * rng.normal(size=(B, N)))
    y = lo_y + py * (cy + sigma_px * rng.normal(size=(B, N)))
    x[:, :3] = 2 * hi_x
    w = rng.integers(1, 16, (B, N)) / 8.0 * (rng.uniform(size=(B, N)) > 0.1)
    return x.astype(dtype), y.astype(dtype), w.astype(dtype)


def jax_read(x, y, w, ranges, binary):
    """JAX's windowed read, branch by branch: ``(image, ox, oy, fits)``."""
    (nx, ny), (win_x, win_y) = BINS, torch_hist._window_shape(WINDOW, *BINS)
    x_lo, x_hi, y_lo, y_hi = ranges
    ix, vx = jax_hist._bin_index(x, x_lo, x_hi, nx)
    iy, vy = jax_hist._bin_index(y, y_lo, y_hi, ny)
    live = vx & vy & (w != 0)
    ox = jax_hist._window_origin(ix, live, nx, win_x)
    oy = jax_hist._window_origin(iy, live, ny, win_y)
    lx, ly = ix - ox[:, None], iy - oy[:, None]
    inside = (lx >= 0) & (lx < win_x) & (ly >= 0) & (ly < win_y)
    fits = ~jnp.any(live & ~inside, axis=-1)
    lx = jnp.where(live & inside, lx, -1)
    ly = jnp.where(live & inside, ly, -1)
    wins = np.asarray(jax_hist._window_matmul_hist(
        lx, ly, w, win_x, win_y, w.dtype, False, binary))
    image = np.zeros((x.shape[0], nx, ny), dtype=np.asarray(w).dtype)
    for b, (ox_b, oy_b) in enumerate(zip(np.asarray(ox), np.asarray(oy))):
        image[b, ox_b: ox_b + win_x, oy_b: oy_b + win_y] = wins[b, : nx - ox_b, : ny - oy_b]
    return image, np.asarray(ox), np.asarray(oy), np.asarray(fits)


def ranges_for(kind, dtype):
    if kind == "floats":
        return RANGES, RANGES
    torch_dtype = torch.float32 if dtype == np.float32 else torch.float64
    return (tuple(jnp.asarray(v, dtype=dtype) for v in RANGES),
            tuple(torch.tensor(v, dtype=torch_dtype) for v in RANGES))


def check(x, y, w, kind, binary):
    jax_ranges, torch_ranges = ranges_for(kind, x.dtype)
    jx, jy, jw = (jnp.asarray(a) for a in (x, y, w))
    tx, ty, tw = (torch.from_numpy(a) for a in (x, y, w))
    expected = jax_read(jx, jy, jw, jax_ranges, binary)
    window = torch_hist._window_shape(WINDOW, *BINS)
    image, ox, oy, fits = torch_hist.windowed_read_reference(
        tx, ty, tw, torch_ranges, BINS, window, binary)
    assert ox.dtype == oy.dtype == torch.int32 and fits.dtype == torch.bool
    np.testing.assert_array_equal(ox.numpy(), expected[1])
    np.testing.assert_array_equal(oy.numpy(), expected[2])
    np.testing.assert_array_equal(fits.numpy(), expected[3])
    assert image.dtype == tw.dtype
    np.testing.assert_array_equal(image.numpy(), expected[0])
    return image, fits, (jx, jy, jw, jax_ranges)


@pytest.mark.parametrize("kind", ["0-d", "floats"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("binary", [True, False], ids=["count", "weighted"])
def test_windowed_read_reference_matches_jax(interpreted_pallas, binary, dtype, B, kind):
    """Every row fits: the image, origins and fits equal JAX's, and the
    image equals JAX's public windowed read."""
    x, y, w = spot(B, dtype, 6.0, seed=B + 10 * binary)
    if binary:
        w = (w != 0).astype(dtype)
    image, fits, (jx, jy, jw, jax_ranges) = check(x, y, w, kind, binary)
    assert bool(fits.all())
    public = jax_hist.windowed_matmul_histogram_2d(
        jx, jy, jw, jax_ranges[:2], jax_ranges[2:], BINS, window=WINDOW,
        binary_weights=binary)
    np.testing.assert_array_equal(image.numpy(), np.asarray(public))
    if binary:
        assert int(image.sum()) == int((w[:, 3:] != 0).sum())


@pytest.mark.parametrize("binary", [True, False], ids=["count", "weighted"])
def test_spot_that_falls_back(interpreted_pallas, binary):
    """Row 1's spot is wider than the window: its fits is False as JAX's,
    and the image holds what the window caught, as JAX's kernel branch;
    row 0 fits."""
    x, y, w = spot(2, np.float64, 6.0, seed=4)
    centre = np.median(x[1, 3:])
    x[1, 3:] = centre + (x[1, 3:] - centre) * 8.0  # row 1's spot 8x as wide
    _, fits, _ = check(x, y, w, "0-d", binary)
    assert fits.tolist() == [True, False]


def test_windowed_read_takes_the_plain_version_on_the_cpu():
    """On CPU tensors kernel B1's wrapper is its plain version and launches
    nothing; its CUDA route raises on them, it never computes."""
    x, y, w = (torch.from_numpy(a) for a in spot(2, np.float64, 6.0, seed=1))
    ranges = tuple(torch.tensor(v, dtype=torch.float64) for v in RANGES)
    window = torch_hist._window_shape(WINDOW, *BINS)
    launches = torch_hist.window_histogram.launches
    read = torch_hist.windowed_read(x, y, w, ranges, BINS, window, False)
    reference = torch_hist.windowed_read_reference(x, y, w, ranges, BINS, window, False)
    assert torch_hist.window_histogram.launches == launches
    for got, want in zip(read, reference):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        torch_hist._windowed_read_cuda(x, y, w, ranges, BINS, window, False)
