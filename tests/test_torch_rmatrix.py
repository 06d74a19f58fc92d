"""Parity of the PyTorch port's transfer maps with the JAX package.

The same float64 inputs, made with numpy from a seed, go through
``lynx_tpu`` and ``lynx_tpu_torch``; element maps and map folding must agree
to 1e-12 relative (both evaluate one formula in the same operation order;
only libm's last bit may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
from lynx_tpu.ops import folding as jax_folding
from lynx_tpu.ops import rmatrix as jax_rmatrix
from lynx_tpu_torch.ops import folding as torch_folding
from lynx_tpu_torch.ops import rmatrix as torch_rmatrix

RTOL = 1e-12
B = 6


def assert_close(actual, expected, rtol=RTOL):
    """Relative agreement, with zero entries held to rtol * max |expected|."""
    actual = np.asarray(actual.detach().cpu() if isinstance(actual, torch.Tensor) else actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape
    scale = max(float(np.nanmax(np.abs(expected))), 1e-300)  # E = 0 gives NaN cells
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


def both(array):
    """The same numpy array as a JAX array and as a torch tensor."""
    return jnp.asarray(array), torch.from_numpy(np.array(array))


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_drift_map(rng):
    (jl, tl), (je, te) = both(rng.uniform(0.0, 2.0, B)), both(rng.uniform(1e6, 1e9, B))
    expected = lt.Drift(jl, dtype=jnp.float64).transfer_map(je)
    actual = ltt.Drift(tl, dtype=torch.float64).transfer_map(te)
    assert_close(actual, expected)


@pytest.mark.parametrize("k1_kind", ["focusing", "defocusing", "zero", "tiny"])
def test_quadrupole_map(rng, k1_kind):
    k1 = {
        "focusing": rng.uniform(0.5, 20.0, B),
        "defocusing": -rng.uniform(0.5, 20.0, B),
        "zero": np.zeros(B),
        "tiny": rng.uniform(-1e-4, 1e-4, B),  # small-argument series branch
    }[k1_kind]
    fields = dict(
        length=rng.uniform(0.05, 0.5, B),
        k1=k1,
        misalignment=rng.normal(0.0, 1e-4, (B, 2)),
        tilt=rng.uniform(-np.pi, np.pi, B),
    )
    energy = rng.uniform(1e6, 1e9, B)
    expected = lt.Quadrupole(
        **{k: jnp.asarray(v) for k, v in fields.items()}, dtype=jnp.float64
    ).transfer_map(jnp.asarray(energy))
    actual = ltt.Quadrupole(
        **{k: torch.from_numpy(v) for k, v in fields.items()}, dtype=torch.float64
    ).transfer_map(torch.from_numpy(energy))
    assert_close(actual, expected)


@pytest.mark.parametrize("name", ["HorizontalCorrector", "VerticalCorrector"])
def test_corrector_map(rng, name):
    length, angle, energy = (rng.uniform(0.01, 0.3, B), rng.normal(0, 1e-3, B),
                             rng.uniform(1e6, 1e9, B))
    expected = getattr(lt, name)(
        jnp.asarray(length), jnp.asarray(angle), dtype=jnp.float64
    ).transfer_map(jnp.asarray(energy))
    actual = getattr(ltt, name)(
        torch.from_numpy(length), torch.from_numpy(angle), dtype=torch.float64
    ).transfer_map(torch.from_numpy(energy))
    assert_close(actual, expected)


def test_marker_and_inactive_screen_maps(rng):
    je, te = both(rng.uniform(1e6, 1e9, B))
    assert_close(ltt.Marker(device="cpu").transfer_map(te), lt.Marker().transfer_map(je))
    screen_j = lt.Screen(misalignment=jnp.zeros((B, 2)), dtype=jnp.float64)
    screen_t = ltt.Screen(misalignment=torch.zeros((B, 2)), dtype=torch.float64)
    assert_close(screen_t.transfer_map(te), screen_j.transfer_map(je))


def test_base_rmatrix_with_curvature(rng):
    """hx != 0 exercises the dispersion and r56 terms; E = 0 the guards."""
    args = [rng.uniform(0.1, 1.0, B), rng.normal(0, 5, B), rng.uniform(-2, 2, B),
            rng.uniform(-1, 1, B), np.concatenate([[0.0], rng.uniform(1e6, 1e9, B - 1)])]
    expected = jax_rmatrix.base_rmatrix(*[jnp.asarray(a) for a in args])
    actual = torch_rmatrix.base_rmatrix(*[torch.from_numpy(a) for a in args])
    assert_close(actual, expected)


def test_rotation_and_misalignment_matrices(rng):
    ja, ta = both(rng.uniform(-np.pi, np.pi, B))
    assert_close(torch_rmatrix.rotation_matrix(ta), jax_rmatrix.rotation_matrix(ja))
    jm, tm = both(rng.normal(0, 1e-3, (B, 2)))
    for a, e in zip(torch_rmatrix.misalignment_matrix(tm), jax_rmatrix.misalignment_matrix(jm)):
        assert_close(a, e)


@pytest.mark.parametrize("length", [1, 2, 5, 13])
def test_fold_transfer_maps(rng, length):
    maps = np.eye(7) + 0.3 * rng.normal(size=(length, B, 7, 7))
    jm, tm = both(maps)
    assert_close(torch_folding.fold_transfer_maps(tm), jax_folding.fold_transfer_maps(jm))


def test_fold_rejects_unstacked_maps():
    with pytest.raises(ValueError):
        torch_folding.fold_transfer_maps(torch.eye(7))


def test_k1_gradient_at_zero_matches_jax(rng):
    """The additive k1 perturbation keeps d/dk1 flowing at k1 = 0."""
    length, energy = 0.122, 1.073e8

    def jax_loss(k1):
        return jnp.sum(jax_rmatrix.base_rmatrix(
            jnp.asarray([length]), k1, jnp.zeros(1), energy=jnp.asarray([energy])
        ) ** 2)

    expected = jax.grad(jax_loss)(jnp.zeros(1))
    k1 = torch.zeros(1, dtype=torch.float64, requires_grad=True)
    loss = torch.sum(torch_rmatrix.base_rmatrix(
        torch.tensor([length], dtype=torch.float64), k1, torch.zeros(1, dtype=torch.float64),
        energy=torch.tensor([energy], dtype=torch.float64),
    ) ** 2)
    (actual,) = torch.autograd.grad(loss, k1)
    assert np.all(np.isfinite(actual.numpy())) and float(actual.abs()) > 0
    assert_close(actual, expected, rtol=1e-9)
