"""Parity of the PyTorch port's screen histogram with the JAX package.

The same float64 coordinates (numpy, seeded) go through both packages.  The
JAX windowed path reaches its Pallas kernel, which runs here in interpret
mode, as ``tests/test_windowed_histogram.py`` runs it; the port's windowed
path runs kernel B1's plain version on the CPU.  Count mode must match
exactly; weighted mode to 1e-12 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lynx_tpu.ops.histogram as jax_hist
import lynx_tpu_torch.ops.histogram as torch_hist

BINS = (612, 510)  # quarter-resolution ARES screen
RANGES = ((-4.3e-3, 4.3e-3), (-2.5e-3, 2.5e-3))
N = 5_000


@pytest.fixture
def interpreted_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def spot(rng, n, sigma_px, center, batch=()):
    """Gaussian spot in physical coordinates; sigma and center in pixels."""
    (x_lo, x_hi), (y_lo, y_hi) = RANGES
    px, py = (x_hi - x_lo) / BINS[0], (y_hi - y_lo) / BINS[1]
    x = x_lo + px * (np.asarray(center[0])[..., None] + sigma_px * rng.normal(size=(*batch, n)))
    y = y_lo + py * (np.asarray(center[1])[..., None] + sigma_px * rng.normal(size=(*batch, n)))
    return x, y


def jax_ranges():
    return tuple((jnp.float64(lo), jnp.float64(hi)) for lo, hi in RANGES)


def torch_ranges():
    return tuple(
        (torch.tensor(lo, dtype=torch.float64), torch.tensor(hi, dtype=torch.float64))
        for lo, hi in RANGES
    )


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


def assert_close(actual, expected, rtol=1e-12):
    actual, expected = actual.detach().numpy(), np.asarray(expected)
    assert actual.shape == expected.shape
    scale = max(float(np.max(np.abs(expected))), 1e-300)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_bin_index_is_bit_identical(rng):
    """The fallback audit relies on identical bin indices in both packages."""
    v = np.concatenate([rng.uniform(-5e-3, 5e-3, 1000), [-4.3e-3, 4.3e-3, 0.0, 1.0]])
    (jv,), (tv,) = both(v)
    for lo, hi, n in ((-4.3e-3, 4.3e-3, 612), (-2.5e-3, 2.5e-3, 510)):
        j_idx, j_ok = jax_hist._bin_index(jv, jnp.float64(lo), jnp.float64(hi), n)
        t_idx, t_ok = torch_hist._bin_index(
            tv, torch.tensor(lo, dtype=torch.float64), torch.tensor(hi, dtype=torch.float64), n
        )
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
        live = t_ok & (tv != 0)
        np.testing.assert_array_equal(
            torch_hist._window_origin(t_idx, live, n, 128).numpy(),
            np.asarray(jax_hist._window_origin(j_idx, jnp.asarray(live.numpy()), n, 128)),
        )


@pytest.mark.parametrize("weighted", [False, True])
def test_scatter_matches_jax(rng, weighted):
    x, y = spot(rng, N, 60.0, (300.0, 250.0))
    w = rng.uniform(0.0, 2.0, N) if weighted else np.ones(N)
    (jx, jy, jw), (tx, ty, tw) = both(x, y, w)
    expected = jax_hist.weighted_histogram_2d(jx, jy, jw, *jax_ranges(), BINS)
    actual = torch_hist.weighted_histogram_2d(tx, ty, tw, *torch_ranges(), BINS)
    if weighted:
        assert_close(actual, expected)
    else:
        np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_windowed_count_mode_matches_jax(rng, interpreted_pallas, batch):
    """Count mode (0/1 weights, the flagship's): exactly equal to JAX's
    windowed kernel and to its scatter, with distinct origins per row."""
    centers = (np.array([300.0, 120.0, 500.0])[: batch[0]] if batch else 300.0,
               np.array([250.0, 60.0, 400.0])[: batch[0]] if batch else 250.0)
    x, y = spot(rng, N, 15.0, centers, batch)
    w = (rng.uniform(size=(*batch, N)) > 0.1).astype(np.float64)  # dead particles
    (jx, jy, jw), (tx, ty, tw) = both(x, y, w)
    window = (128, 256)
    expected = jax_hist.windowed_matmul_histogram_2d(
        jx, jy, jw, *jax_ranges(), BINS, window=window, binary_weights=True
    )
    scatter = jax_hist.weighted_histogram_2d(jx, jy, jw, *jax_ranges(), BINS)
    torch_hist.reset_histogram_fallback_count()
    actual = torch_hist.windowed_histogram_2d(
        tx, ty, tw, *torch_ranges(), BINS, window=window, binary_weights=True
    )
    assert torch_hist.histogram_fallback_count() == 0
    assert actual.shape == (*batch, *BINS)
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))
    np.testing.assert_array_equal(actual.numpy(), np.asarray(scatter))


def test_windowed_weighted_mode_matches_jax(rng, interpreted_pallas):
    """Weighted mode.  JAX's windowed kernel sums in float32 (bf16x3 parts),
    so it is held here on dyadic weights, which f32 sums exactly; general
    float64 weights are held against JAX's scatter, whose semantics the
    windowed path shares."""
    x, y = spot(rng, N, 15.0, (300.0, 250.0))
    dyadic = rng.integers(1, 16, N) / 8.0
    general = rng.uniform(0.0, 2.0, N)
    for w, reference in (
        (dyadic, jax_hist.windowed_matmul_histogram_2d),
        (general, jax_hist.weighted_histogram_2d),
    ):
        (jx, jy, jw), (tx, ty, tw) = both(x, y, w)
        kwargs = {"window": (128, 256)} if reference is not jax_hist.weighted_histogram_2d else {}
        expected = reference(jx, jy, jw, *jax_ranges(), BINS, **kwargs)
        actual = torch_hist.windowed_histogram_2d(tx, ty, tw, *torch_ranges(), BINS, window=(128, 256))
        assert_close(actual, expected)


def test_oversize_spot_falls_back_and_window_fits_agrees(rng, interpreted_pallas):
    x, y = spot(rng, N, 80.0, (300.0, 250.0))  # spot far larger than the window
    w = np.ones(N)
    (jx, jy, jw), (tx, ty, tw) = both(x, y, w)
    window = (64, 128)
    j_fits = jax_hist.window_fits(jx, jy, jw, *jax_ranges(), BINS, window)
    t_fits = torch_hist.window_fits(tx, ty, tw, *torch_ranges(), BINS, window)
    assert not bool(t_fits) and bool(t_fits) == bool(j_fits)
    torch_hist.reset_histogram_fallback_count()
    actual = torch_hist.windowed_histogram_2d(tx, ty, tw, *torch_ranges(), BINS, window=window)
    assert torch_hist.histogram_fallback_count() == 1
    expected = jax_hist.windowed_matmul_histogram_2d(jx, jy, jw, *jax_ranges(), BINS, window=window)
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))


def test_window_fits_per_row_matches_jax(rng):
    x, y = spot(rng, N, 15.0, (np.array([300.0, 300.0]), np.array([250.0, 250.0])), (2,))
    x[1, :10] += 0.4 * (RANGES[0][1] - RANGES[0][0])  # row 1 overflows its window
    (jx, jy, jw), (tx, ty, tw) = both(x, y, np.ones((2, N)))
    for per_row in (True, False):
        j_fits = jax_hist.window_fits(jx, jy, jw, *jax_ranges(), BINS, (128, 256), per_row)
        t_fits = torch_hist.window_fits(tx, ty, tw, *torch_ranges(), BINS, (128, 256), per_row)
        np.testing.assert_array_equal(t_fits.numpy(), np.asarray(j_fits))
    # A window that covers the whole image never takes the windowed path.
    assert not bool(torch_hist.window_fits(tx, ty, tw, *torch_ranges(), BINS, BINS, False))


@pytest.mark.parametrize("oversize", [False, True])
def test_weight_vjp_matches_jax(rng, interpreted_pallas, oversize):
    """The weight cotangent against ``jax.vjp`` of the windowed histogram, on
    the kernel route and on the fallback route."""
    x, y = spot(rng, N, 80.0 if oversize else 15.0, (300.0, 250.0))
    x[:5] = 1.0  # out of range: no cotangent
    w = rng.uniform(0.5, 1.5, N)
    cotangent = rng.normal(size=BINS)
    (jx, jy, jw, jc), (tx, ty, tw, tc) = both(x, y, w, cotangent)
    window = (128, 256)

    _, vjp = jax.vjp(
        lambda w_: jax_hist.windowed_matmul_histogram_2d(jx, jy, w_, *jax_ranges(), BINS, window=window),
        jw,
    )
    (expected,) = vjp(jc)
    tw.requires_grad_(True)
    image = torch_hist.windowed_histogram_2d(tx, ty, tw, *torch_ranges(), BINS, window=window)
    (actual,) = torch.autograd.grad(image, tw, tc)
    assert_close(actual, expected)
    assert torch.all(actual[:5] == 0)


def test_weight_vjp_unbroadcasts_to_the_weights_shape(rng):
    x, y = spot(rng, N, 15.0, (np.array([300.0, 200.0]), np.array([250.0, 100.0])), (2,))
    _, (tx, ty) = both(x, y)
    w = torch.ones(N, dtype=torch.float64, requires_grad=True)  # shared by both rows
    image = torch_hist.windowed_histogram_2d(tx, ty, w, *torch_ranges(), BINS, window=(128, 256))
    (grad,) = torch.autograd.grad(image.sum(), w)
    assert grad.shape == (N,)
    np.testing.assert_array_equal(grad.numpy(), np.full(N, 2.0))


def test_window_histogram_reference_edge_cases():
    """B1's plain version against a plain loop: indices at 0 and win - 1,
    masked (-1) and out-of-window entries, an all-masked row."""
    win_x, win_y = 16, 128
    lx = torch.tensor([[0, win_x - 1, 0, win_x - 1, -1, 3, win_x, 2],
                       [-1, -1, -1, -1, -1, -1, -1, -1]], dtype=torch.int32)
    ly = torch.tensor([[0, 0, win_y - 1, win_y - 1, 4, -1, 1, win_y],
                       [0, 1, 2, 3, 4, 5, 6, 7]], dtype=torch.int32)
    weights = torch.arange(16, dtype=torch.float64).reshape(2, 8) / 4
    expected_counts = np.zeros((2, win_x, win_y), dtype=np.int32)
    expected_sums = np.zeros((2, win_x, win_y))
    for b in range(2):
        for i in range(8):
            x, y = int(lx[b, i]), int(ly[b, i])
            if 0 <= x < win_x and 0 <= y < win_y:
                expected_counts[b, x, y] += 1
                expected_sums[b, x, y] += float(weights[b, i])
    counts = torch_hist.window_histogram_reference(lx, ly, None, win_x, win_y)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), expected_counts)
    np.testing.assert_array_equal(
        torch_hist.window_histogram_reference(lx, ly, weights, win_x, win_y).numpy(), expected_sums
    )


def test_window_histogram_uses_the_plain_version_on_cpu_tensors():
    lx = torch.zeros((1, 10), dtype=torch.int32)
    before = torch_hist.window_histogram.launches
    out = torch_hist.window_histogram(lx, lx, None, 8, 128)
    assert torch_hist.window_histogram.launches == before  # no kernel launched
    assert int(out[0, 0, 0]) == 10


def test_kernel_launcher_refuses_cpu_tensors():
    """The CUDA route launches the kernel or raises: it never computes."""
    lx = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        torch_hist._window_histogram_cuda(lx, lx, None, 8, 128)


def test_screen_histogram_routes_by_device(rng, monkeypatch):
    x, y = spot(rng, N, 15.0, (300.0, 250.0))
    _, (tx, ty, tw) = both(x, y, np.ones(N))
    calls = []
    real = torch_hist.window_histogram_reference
    monkeypatch.setattr(
        torch_hist, "window_histogram_reference", lambda *a: calls.append(1) or real(*a)
    )
    scatter = torch_hist.screen_histogram_2d(tx, ty, tw, *torch_ranges(), BINS, window=(128, 256))
    assert not calls  # CPU tensors take the plain scatter
    monkeypatch.setattr(torch_hist, "SCREEN_WINDOWED_PATH", True)
    windowed = torch_hist.screen_histogram_2d(
        tx, ty, tw, *torch_ranges(), BINS, window=(128, 256), binary_weights=True
    )
    assert calls
    assert torch.equal(windowed, scatter)
