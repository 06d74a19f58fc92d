"""Parity of the PyTorch port's beams with the JAX package.

Moments of the same float64 particles (numpy, seeded) must agree to 1e-12
relative.  ``from_parameters`` draws from different generators in the two
packages, so there only the sample moments are compared, within sampling
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt

RTOL = 1e-12
STATS = ("mu_x", "mu_xp", "mu_y", "mu_yp", "mu_s", "mu_p",
         "sigma_x", "sigma_xp", "sigma_y", "sigma_yp", "sigma_s", "sigma_p",
         "sigma_xxp", "sigma_yyp")


def assert_close(actual, expected, rtol=RTOL):
    actual = actual.detach().cpu().numpy() if isinstance(actual, torch.Tensor) else actual
    expected = np.asarray(expected)
    assert np.shape(actual) == expected.shape
    scale = max(float(np.max(np.abs(expected))), 1e-300)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


def particles(rng, shape, n):
    scales = np.array([1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3])
    p = np.ones((*shape, n, 7))
    p[..., :6] = rng.normal(0.0, 1.0, (*shape, n, 6)) * scales + rng.normal(0, 1e-5, 6)
    return p


@pytest.mark.parametrize("survival_kind", ["none", "binary", "fractional"])
def test_particle_beam_moments(survival_kind):
    rng = np.random.default_rng(3)
    p = particles(rng, (2,), 2000)
    charges = rng.uniform(0, 1e-15, (2, 2000))
    survival = {
        "none": None,
        "binary": (rng.uniform(size=(2, 2000)) > 0.3).astype(np.float64),
        "fractional": rng.uniform(size=(2, 2000)),
    }[survival_kind]
    energy = np.array([1e8, 2e8])
    jb = lt.ParticleBeam(jnp.asarray(p), jnp.asarray(energy), jnp.asarray(charges),
                         survival=None if survival is None else jnp.asarray(survival))
    tb = ltt.ParticleBeam(torch.from_numpy(p), torch.from_numpy(energy),
                          torch.from_numpy(charges),
                          survival=None if survival is None else torch.from_numpy(survival))
    for stat in STATS:
        assert_close(getattr(tb, stat), getattr(jb, stat))
    assert_close(tb.num_particles_survived, jb.num_particles_survived)
    assert_close(tb.total_charge, jb.total_charge)
    assert_close(tb.xs, jb.xs)
    assert_close(tb.ys, jb.ys)
    assert tb.num_particles == jb.num_particles == 2000


def test_particle_beam_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ltt.ParticleBeam(torch.zeros(10, 6), torch.tensor([1e8]))


def test_parameter_beam_from_parameters_matches_jax():
    kwargs = dict(mu_x=[1e-4], mu_xp=[-2e-5], mu_y=[3e-5], mu_yp=[1e-6],
                  sigma_x=[1.75e-4], sigma_xp=[2e-5], sigma_y=[1.5e-4], sigma_yp=[3e-5],
                  sigma_s=[8e-6], sigma_p=[2e-3], cor_x=[1e-10], cor_y=[-2e-10],
                  cor_s=[1e-9], energy=[1.073e8], total_charge=[1e-12])
    jb = lt.ParameterBeam.from_parameters(
        **{k: jnp.asarray(v) for k, v in kwargs.items()}, dtype=jnp.float64
    )
    tb = ltt.ParameterBeam.from_parameters(
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in kwargs.items()},
        dtype=torch.float64,
    )
    assert_close(tb._mu, jb._mu)
    assert_close(tb._cov, jb._cov)
    for stat in STATS:
        assert_close(getattr(tb, stat), getattr(jb, stat))
    assert_close(tb.energy, jb.energy)
    assert_close(tb.total_charge, jb.total_charge)


def test_parameter_beam_defaults_and_broadcast_match_jax():
    jb = lt.ParameterBeam.from_parameters(dtype=jnp.float64).broadcast((3,))
    tb = ltt.ParameterBeam.from_parameters(dtype=torch.float64).broadcast((3,))
    assert_close(tb._cov, jb._cov)
    assert_close(tb._mu, jb._mu)
    assert_close(tb.sigma_x, jb.sigma_x)


def test_particle_beam_from_parameters_sample_moments():
    """Sample moments of the port's Gaussian beam against the requested
    parameters and against JAX's sample, within sampling tolerance: at
    N = 100k a sample sigma is within 5/sqrt(2N) ~ 1.1% of its parameter."""
    n = 100_000
    params = dict(mu_x=[2e-4], mu_yp=[-1e-5], sigma_x=[1.75e-4], sigma_y=[1.2e-4],
                  sigma_xp=[2e-5], sigma_yp=[3e-5], sigma_s=[8e-6], sigma_p=[2e-3],
                  cor_x=[1e-9], energy=[1.073e8], total_charge=[1e-12])
    tb = ltt.ParticleBeam.from_parameters(
        num_particles=n, generator=torch.Generator().manual_seed(0), dtype=torch.float64,
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()},
    )
    jb = lt.ParticleBeam.from_parameters(
        num_particles=n, key=jax.random.PRNGKey(0), dtype=jnp.float64,
        **{k: jnp.asarray(v) for k, v in params.items()},
    )
    assert tb.particles.shape == (1, n, 7)
    assert torch.all(tb.particles[..., 6] == 1.0)
    tol = 5 / np.sqrt(2 * n)
    for stat in ("sigma_x", "sigma_xp", "sigma_y", "sigma_yp", "sigma_s", "sigma_p"):
        expected = params[stat][0]
        assert abs(float(getattr(tb, stat)[0]) / expected - 1) < tol, stat
        assert abs(float(getattr(tb, stat)[0]) / float(getattr(jb, stat)[0]) - 1) < 2 * tol
    assert abs(float(tb.mu_x[0]) - 2e-4) < 5 * 1.75e-4 / np.sqrt(n)
    assert abs(float(tb.mu_yp[0]) + 1e-5) < 5 * 3e-5 / np.sqrt(n)
    # cor_x = <x x'>: correlation coefficient 1e-9 / (1.75e-4 * 2e-5) ~ 0.29.
    rho = float(tb.sigma_xxp[0]) / (1.75e-4 * 2e-5)
    assert abs(rho - 1e-9 / (1.75e-4 * 2e-5)) < 5 / np.sqrt(n)
    assert float(tb.total_charge[0]) == pytest.approx(1e-12, rel=1e-12)
    assert tb.survival is None


def test_from_parameters_is_reproducible_from_a_seeded_generator():
    a = ltt.ParticleBeam.from_parameters(num_particles=100, generator=torch.Generator().manual_seed(5))
    b = ltt.ParticleBeam.from_parameters(num_particles=100, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.particles, b.particles)
    assert a.particles.dtype == torch.float32


def test_particle_beam_to_and_broadcast():
    beam = ltt.ParticleBeam(torch.ones(1, 5, 7), torch.tensor([1e8]),
                            survival=torch.ones(1, 5))
    wide = beam.broadcast((4,))
    assert wide.particles.shape == (4, 5, 7) and wide.survival.shape == (4, 5)
    doubled = beam.to(dtype=torch.float64)
    assert doubled.particles.dtype == doubled.energy.dtype == doubled.survival.dtype == torch.float64
