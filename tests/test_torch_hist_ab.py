"""Kernel B7's plain version, the count-histogram A/B's reference, against
the JAX package's two TPU kernels (``benchmarks/hist_ab.py``: ``kernel``
and ``kernel_twolevel`` from ``make_kernel``), run through
``pl.pallas_call(..., interpret=True)`` on the CPU at a small window.

Indices come from numpy with a seed and include -1 pads and indices past
the window in both axes: the TPU kernels' one-hot compares drop such a pair
(dropped, not clipped), and so does the port.  Counts are equal exactly.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lynx_tpu_torch.benchmarks import hist_ab

REPO = Path(__file__).resolve().parent.parent
WIN = (16, 128)
TILE_N = 2048


@pytest.fixture(scope="module")
def jax_hist_ab():
    spec = importlib.util.spec_from_file_location("jax_hist_ab", REPO / "benchmarks" / "hist_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def indices(n, seed=0):
    """Indices in [-1, win + 4) on each axis, -1 pads to a multiple of TILE_N
    in the JAX kernels' layout."""
    rng = np.random.default_rng(seed)
    lx = rng.integers(-1, WIN[0] + 4, n).astype(np.int32)
    ly = rng.integers(-1, WIN[1] + 4, n).astype(np.int32)
    return lx, ly


def jax_counts(jax_hist_ab, lx, ly, twolevel):
    n_tiles = -(-lx.shape[0] // TILE_N)
    pad = n_tiles * TILE_N - lx.shape[0]
    lx = np.pad(lx, (0, pad), constant_values=-1)
    ly = np.pad(ly, (0, pad), constant_values=-1)
    kernel = jax_hist_ab.make_kernel(*WIN, TILE_N, jnp.int32, True, halves=2, twolevel=twolevel)
    vec = pl.BlockSpec((TILE_N,), lambda b, i: (b * n_tiles + i,))
    out = pl.pallas_call(
        kernel, grid=(1, n_tiles), in_specs=[vec, vec],
        out_specs=pl.BlockSpec((1, *WIN), lambda b, i: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, *WIN), jnp.int32), interpret=True,
    )(jnp.asarray(lx), jnp.asarray(ly))
    return np.asarray(out)


@pytest.mark.parametrize("twolevel", [False, True], ids=["kernel", "kernel_twolevel"])
@pytest.mark.parametrize("n", [2048, 5000])
def test_plain_version_equals_the_tpu_kernels(jax_hist_ab, twolevel, n):
    lx, ly = indices(n, seed=n)
    expected = jax_counts(jax_hist_ab, lx, ly, twolevel)
    actual = hist_ab.hist_ab_reference(torch.from_numpy(lx), torch.from_numpy(ly), *WIN)
    assert actual.dtype == torch.int32 and tuple(actual.shape) == (1, *WIN)
    np.testing.assert_array_equal(actual.numpy(), expected)
    # Pairs outside the window are dropped: fewer than the particles counted.
    inside = (lx >= 0) & (lx < WIN[0]) & (ly >= 0) & (ly < WIN[1])
    assert int(actual.sum()) == int(inside.sum()) < n


@pytest.mark.parametrize("name", list(hist_ab.VARIANTS))
def test_wrappers_take_the_plain_version_on_the_cpu(name):
    """On CPU tensors every variant's wrapper is the plain version and
    launches nothing."""
    lx, ly = (torch.from_numpy(a) for a in indices(3000))
    wrapper, knob = hist_ab.VARIANTS[name]
    launches = wrapper.launches
    counts = wrapper(lx, ly, *WIN, **knob)
    assert torch.equal(counts, hist_ab.hist_ab_reference(lx, ly, *WIN))
    assert wrapper.launches == launches


def test_workload_is_the_seeded_flagship_spot():
    lx, ly = hist_ab.workload(10_000, (952, 256), seed=3, device="cpu")
    again = hist_ab.workload(10_000, (952, 256), seed=3, device="cpu")
    assert torch.equal(lx, again[0]) and torch.equal(ly, again[1])
    assert lx.dtype == ly.dtype == torch.int32
    assert int(lx.min()) >= 0 and int(lx.max()) <= 951 and int(ly.max()) <= 255
    assert abs(float(lx.float().mean()) - 476) < 5 and abs(float(lx.float().std()) - 119) < 5
    assert int(hist_ab.hist_ab_reference(lx, ly, 952, 256).sum()) == 10_000


def test_harness_refuses_to_run_without_a_card():
    with pytest.raises(SystemExit, match="CUDA"):
        hist_ab.main(["--particles", "100"])


def test_harness_runs_every_variant_and_yardstick(monkeypatch):
    """The harness's control flow on the CPU, its timers stubbed (they need
    the card): every variant checked against the plain version, one JSON
    record each and one per yardstick (B1's count mode, torch.bincount)."""
    monkeypatch.setattr(hist_ab.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(hist_ab, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    monkeypatch.setattr(hist_ab, "device_ms", lambda fn, iters, kernel=None: (fn(), 2.0, 0.5)[1:])
    workload = hist_ab.workload
    monkeypatch.setattr(hist_ab, "workload",
                        lambda particles, win: workload(particles, win, device="cpu"))
    records = hist_ab.main(["--particles", "500", "--win", "16,128",
                            "--variants", "onehot_c256,twolevel_b56"])
    assert [r["variant"] for r in records] == [
        "onehot_c256", "twolevel_b56", "B1 window_histogram", "torch.bincount"]
    assert all(r["win"] == [16, 128] and r["particles"] == 500 for r in records)
    assert [r["device_ms"] for r in records] == [0.5, 0.5, 0.5, 2.0]
