"""The beams' user-facing API, JAX package against PyTorch port.

Twiss and emittance diagnostics, ``parameters``, the relativistic factors,
``transformed_to``, ``make_linspaced``, ``from_twiss``, ``from_astra`` (the
repository's ASTRA file) and ``from_ocelot`` (a duck-typed particle array)
take the same numpy inputs in both packages and agree to 1e-12 relative in
float64 (atol scaled by the largest entry); ``from_astra`` in float32 is
equal exactly (both read through float64 and round once).  The gradients of
the emittance and beta at AREABSCR1's plane with respect to AREAMQZM1's k1
agree with ``jax.grad`` to 1e-10.  The port's sampled constructors draw
from a ``torch.Generator``, so their draws are held by statistics, and
their deterministic part exactly against ``from_parameters``.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu.functional as jax_functional
import lynx_tpu_torch as ltt
from lynx_tpu.models import ares_ea_segment as jax_ares_ea_segment
from lynx_tpu_torch import functional
from lynx_tpu_torch.models import ares as torch_ares

RTOL = 1e-12
GRAD_RTOL = 1e-10
ASTRA_BEAM = Path(__file__).parent / "resources" / "ACHIP_EA1_2021.1351.001"
TWISS = ("emittance_x", "emittance_y", "normalized_emittance_x", "normalized_emittance_y",
         "beta_x", "beta_y", "alpha_x", "alpha_y", "relativistic_gamma", "relativistic_beta")
PARAMETERS = ("mu_x", "mu_xp", "mu_y", "mu_yp", "sigma_x", "sigma_xp", "sigma_y", "sigma_yp",
              "sigma_s", "sigma_p", "energy")


def assert_close(actual, expected, rtol=RTOL):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    scale = max(float(np.max(np.abs(expected))), 1e-300)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


def assert_same_statistics(torch_beam, jax_beam, names=TWISS + PARAMETERS, rtol=RTOL):
    for name in names:
        assert_close(getattr(torch_beam, name), getattr(jax_beam, name), rtol)


def correlated_particles(rng, shape, n):
    """(..., n, 7) particles with x-x' and y-y' correlations."""
    p = np.ones((*shape, n, 7))
    z = rng.normal(size=(*shape, n, 6))
    p[..., 0] = 1.75e-4 * z[..., 0] + 1e-5
    p[..., 1] = 2e-5 * (0.6 * z[..., 0] + 0.8 * z[..., 1])
    p[..., 2] = 1.5e-4 * z[..., 2] - 2e-5
    p[..., 3] = 3e-5 * (-0.4 * z[..., 2] + 0.9 * z[..., 3])
    p[..., 4] = 8e-6 * z[..., 4]
    p[..., 5] = 2e-3 * z[..., 5]
    return p


def particle_pair(survival_kind="none", shape=(2,), n=3000, seed=0):
    rng = np.random.default_rng(seed)
    p = correlated_particles(rng, shape, n)
    charges = rng.uniform(0, 1e-15, (*shape, n))
    energy = np.linspace(1e8, 2e8, int(np.prod(shape))).reshape(shape)
    survival = {
        "none": None,
        "binary": (rng.uniform(size=(*shape, n)) > 0.3).astype(np.float64),
    }[survival_kind]
    jax_beam = lt.ParticleBeam(jnp.asarray(p), jnp.asarray(energy), jnp.asarray(charges),
                               survival=None if survival is None else jnp.asarray(survival))
    torch_beam = ltt.ParticleBeam(
        torch.from_numpy(p), torch.from_numpy(energy), torch.from_numpy(charges),
        survival=None if survival is None else torch.from_numpy(survival),
    )
    return jax_beam, torch_beam


COR_PARAMETERS = dict(mu_x=[1e-4, -2e-4], mu_xp=[-2e-5, 1e-5], mu_y=[3e-5, 0.0],
                      mu_yp=[1e-6, 2e-6], sigma_x=[1.75e-4, 2e-4], sigma_xp=[2e-5, 3e-5],
                      sigma_y=[1.5e-4, 1e-4], sigma_yp=[3e-5, 1e-5], sigma_s=[8e-6, 1e-5],
                      sigma_p=[2e-3, 1e-3], cor_x=[1e-9, -2e-9], cor_y=[-2e-10, 5e-10],
                      cor_s=[1e-9, 0.0], energy=[1.073e8, 2e8], total_charge=[1e-12, 2e-12])


def parameter_pair(**kwargs):
    kwargs = kwargs or COR_PARAMETERS
    jax_beam = lt.ParameterBeam.from_parameters(
        **{k: jnp.asarray(v) for k, v in kwargs.items()}, dtype=jnp.float64
    )
    torch_beam = ltt.ParameterBeam.from_parameters(
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in kwargs.items()},
        dtype=torch.float64, device="cpu",
    )
    return jax_beam, torch_beam


# -- Twiss and emittance ------------------------------------------------------


@pytest.mark.parametrize("survival_kind", ["none", "binary"])
def test_particle_beam_twiss_matches_jax(survival_kind):
    jax_beam, torch_beam = particle_pair(survival_kind)
    assert_same_statistics(torch_beam, jax_beam)
    assert set(torch_beam.parameters) == set(jax_beam.parameters) == set(PARAMETERS)
    for name, value in torch_beam.parameters.items():
        assert_close(value, jax_beam.parameters[name])


def test_parameter_beam_twiss_matches_jax():
    jax_beam, torch_beam = parameter_pair()
    assert_same_statistics(torch_beam, jax_beam)


def test_degenerate_beams_like_jax():
    """A beam at rest (the relativistic guards) and beams whose x-x' area
    vanishes (fully correlated, and no x' at all: the emittance's clamp at
    the dtype's tiny) give the same values in both packages."""
    kwargs = dict(sigma_x=[1e-4, 1e-4, 1e-4], sigma_xp=[2e-5, 2e-5, 0.0],
                  cor_x=[0.0, 2e-9, 0.0], energy=[0.0, 1e8, 1e8])
    jax_beam, torch_beam = parameter_pair(**kwargs)
    assert_same_statistics(torch_beam, jax_beam)
    assert float(torch_beam.relativistic_beta[0]) == 1.0
    n = 4
    particles = np.ones((1, n, 7))
    particles[..., :6] = 0.0
    jax_beam = lt.ParticleBeam(jnp.asarray(particles), jnp.asarray([1e8]))
    torch_beam = ltt.ParticleBeam(torch.from_numpy(particles), torch.tensor([1e8]))
    for name in ("emittance_x", "emittance_y"):
        assert float(getattr(torch_beam, name)[0]) == float(getattr(jax_beam, name)[0]) == (
            np.sqrt(np.finfo(np.float64).tiny))


# -- constructors --------------------------------------------------------------


TWISS_INPUTS = dict(beta_x=[5.91, 8.0], alpha_x=[3.55, -1.2], emittance_x=[3.494e-9, 1e-9],
                    beta_y=[5.91, 2.5], alpha_y=[3.55, 0.4], emittance_y=[3.497e-9, 2e-9],
                    sigma_s=[8e-6, 1e-5], sigma_p=[2e-3, 1e-3], cor_s=[1e-9, 0.0],
                    energy=[6e6, 1.073e8], total_charge=[1e-12, 0.0])


@pytest.mark.parametrize("inputs", ["given", "defaults"])
def test_parameter_beam_from_twiss_matches_jax(inputs):
    kwargs = TWISS_INPUTS if inputs == "given" else {}
    jax_beam = lt.ParameterBeam.from_twiss(
        **{k: jnp.asarray(v) for k, v in kwargs.items()}, dtype=jnp.float64
    )
    torch_beam = ltt.ParameterBeam.from_twiss(
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in kwargs.items()},
        dtype=torch.float64, device="cpu",
    )
    assert_close(torch_beam._mu, jax_beam._mu)
    assert_close(torch_beam._cov, jax_beam._cov)
    assert_same_statistics(torch_beam, jax_beam)
    if inputs == "given":
        assert_close(torch_beam.beta_x, TWISS_INPUTS["beta_x"], 1e-9)
        assert_close(torch_beam.alpha_y, TWISS_INPUTS["alpha_y"], 1e-9)


def test_particle_beam_from_twiss_is_from_parameters_of_its_moments():
    """The sigmas and correlations of ``from_twiss``, exactly: the same
    generator's draws through ``from_parameters`` give the same particles."""
    kwargs = {k: torch.tensor(v, dtype=torch.float64) for k, v in TWISS_INPUTS.items()}
    beam = ltt.ParticleBeam.from_twiss(
        num_particles=500, **kwargs, generator=torch.Generator().manual_seed(5),
        dtype=torch.float64,
    )
    ex, ey = kwargs["emittance_x"], kwargs["emittance_y"]
    bx, by, ax, ay = kwargs["beta_x"], kwargs["beta_y"], kwargs["alpha_x"], kwargs["alpha_y"]
    expected = ltt.ParticleBeam.from_parameters(
        num_particles=500,
        sigma_x=torch.sqrt(bx * ex), sigma_xp=torch.sqrt(ex * (1 + ax**2) / bx),
        sigma_y=torch.sqrt(by * ey), sigma_yp=torch.sqrt(ey * (1 + ay**2) / by),
        cor_x=-ex * ax, cor_y=-ey * ay, sigma_s=kwargs["sigma_s"], sigma_p=kwargs["sigma_p"],
        cor_s=kwargs["cor_s"], energy=kwargs["energy"], total_charge=kwargs["total_charge"],
        generator=torch.Generator().manual_seed(5), dtype=torch.float64, device="cpu",
    )
    assert torch.equal(beam.particles, expected.particles)
    assert torch.equal(beam.particle_charges, expected.particle_charges)
    assert beam.particles.device.type == "cpu"  # the generator's device
    default = ltt.ParticleBeam.from_twiss(
        num_particles=10, generator=torch.Generator().manual_seed(0)
    )
    assert default.particles.shape == (1, 10, 7)
    # beta = eps = 0: only the Cholesky factor's regularisation (sqrt(tiny)).
    assert float(default.particles[..., :4].abs().max()) < 1e-18


def test_particle_beam_from_twiss_statistics():
    """1e6 particles reproduce the Twiss inputs (JAX's default N)."""
    beam = ltt.ParticleBeam.from_twiss(
        beta_x=torch.tensor([5.91]), alpha_x=torch.tensor([3.55]),
        emittance_x=torch.tensor([3.494e-9]), beta_y=torch.tensor([2.5]),
        alpha_y=torch.tensor([-0.4]), emittance_y=torch.tensor([2e-9]),
        energy=torch.tensor([6e6]), generator=torch.Generator().manual_seed(42),
        dtype=torch.float64,
    )
    assert beam.num_particles == 1_000_000
    for name, value in (("beta_x", 5.91), ("alpha_x", 3.55), ("emittance_x", 3.494e-9),
                        ("beta_y", 2.5), ("alpha_y", -0.4), ("emittance_y", 2e-9)):
        np.testing.assert_allclose(float(getattr(beam, name)[0]), value, rtol=1e-2)


def test_uniform_3d_ellipsoid_bounds_and_statistics():
    """The bounds and statistics of the JAX package's own test
    (``tests/test_beams.py``): every particle inside the ellipsoid, each
    axis' sigma radius / sqrt(5) within 2e-2."""
    beam = ltt.ParticleBeam.uniform_3d_ellipsoid(
        num_particles=50_000, radius_x=torch.tensor([2e-3]), radius_y=torch.tensor([1e-3]),
        radius_s=torch.tensor([3e-3]), generator=torch.Generator().manual_seed(0),
    )
    xs, ys, ss = (getattr(beam, n)[0].numpy().astype(np.float64) for n in ("xs", "ys", "ss"))
    r2 = xs**2 / 2e-3**2 + ys**2 / 1e-3**2 + ss**2 / 3e-3**2
    assert r2.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(xs.std(), 2e-3 / np.sqrt(5), rtol=2e-2)
    np.testing.assert_allclose(ys.std(), 1e-3 / np.sqrt(5), rtol=2e-2)
    np.testing.assert_allclose(ss.std(), 3e-3 / np.sqrt(5), rtol=2e-2)
    # The momenta: an uncorrelated Gaussian of the from_parameters defaults.
    np.testing.assert_allclose(float(beam.sigma_xp[0]), 2e-7, rtol=2e-2)
    assert torch.equal(beam.particles[..., 6], torch.ones(1, 50_000))
    again = ltt.ParticleBeam.uniform_3d_ellipsoid(
        num_particles=100, generator=torch.Generator().manual_seed(3))
    assert again.particles.shape == (1, 100, 7) and bool(again.xs.abs().max() <= 1e-3)


def test_make_linspaced_matches_jax():
    kwargs = dict(mu_x=[1e-4, 0.0], sigma_x=[2e-5, 1e-5], mu_yp=[3e-6, -1e-6],
                  sigma_s=[1e-6, 2e-6], sigma_p=[1e-3, 0.0], energy=[1e8, 2e8],
                  total_charge=[1e-12, 3e-12])
    jax_beam = lt.ParticleBeam.make_linspaced(
        num_particles=11, **{k: jnp.asarray(v) for k, v in kwargs.items()}, dtype=jnp.float64
    )
    torch_beam = ltt.ParticleBeam.make_linspaced(
        num_particles=11, **{k: torch.tensor(v, dtype=torch.float64) for k, v in kwargs.items()},
        dtype=torch.float64, device="cpu",
    )
    assert_close(torch_beam.particles, jax_beam.particles)
    assert_close(torch_beam.particle_charges, jax_beam.particle_charges)
    assert_close(torch_beam.energy, jax_beam.energy)
    default = ltt.ParticleBeam.make_linspaced(device="cpu")
    assert_close(default.particles, lt.ParticleBeam.make_linspaced().particles, 1e-6)
    assert len(default) == 10


@pytest.mark.parametrize("beam_type", ["particle", "parameter"])
def test_from_astra_matches_jax(beam_type):
    jax_cls, torch_cls = {"particle": (lt.ParticleBeam, ltt.ParticleBeam),
                          "parameter": (lt.ParameterBeam, ltt.ParameterBeam)}[beam_type]
    fields = {"particle": ("particles", "energy", "particle_charges"),
              "parameter": ("_mu", "_cov", "energy", "total_charge")}[beam_type]
    jax64 = jax_cls.from_astra(str(ASTRA_BEAM), dtype=jnp.float64)
    torch64 = torch_cls.from_astra(str(ASTRA_BEAM), dtype=torch.float64, device="cpu")
    for field in fields:
        assert_close(getattr(torch64, field), getattr(jax64, field))
    assert_same_statistics(torch64, jax64)
    # Float32: both cast the float64 host arrays once, so equal exactly.
    jax32 = jax_cls.from_astra(str(ASTRA_BEAM))
    torch32 = torch_cls.from_astra(str(ASTRA_BEAM), device="cpu")
    for field in fields:
        value = getattr(torch32, field)
        assert value.dtype == torch.float32
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(jax32, field)))
    assert float(torch64.energy[0]) == pytest.approx(107_315_902.44394557, rel=1e-12)


def test_from_ocelot_matches_jax():
    """A duck-typed Ocelot ParticleArray (``rparticles`` (6, N), ``E`` in
    GeV, ``q_array``), both beam types."""
    rng = np.random.default_rng(11)
    parray = SimpleNamespace(
        rparticles=correlated_particles(rng, (), 2000)[:, :6].T.copy(),
        E=0.1073, q_array=rng.uniform(0, 1e-15, 2000),
    )
    for jax_cls, torch_cls in ((lt.ParticleBeam, ltt.ParticleBeam),
                               (lt.ParameterBeam, ltt.ParameterBeam)):
        jax_beam = jax_cls.from_ocelot(parray, dtype=jnp.float64)
        torch_beam = torch_cls.from_ocelot(parray, dtype=torch.float64, device="cpu")
        assert_same_statistics(torch_beam, jax_beam)
        assert_close(torch_beam.total_charge, jax_beam.total_charge)


# -- transforms and the rest of the API ------------------------------------------


TRANSFORMS = [
    dict(mu_x=[1e-4, -1e-4], mu_y=[-1e-4, 2e-4]),
    dict(sigma_x=[3e-4, 1e-4], sigma_yp=[5e-5, 1e-5], sigma_p=[1e-3, 4e-3]),
    dict(energy=[2e8, 3e8], total_charge=[5e-12, 1e-12], mu_xp=[1e-6, 0.0]),
]


@pytest.mark.parametrize("index", range(len(TRANSFORMS)))
@pytest.mark.parametrize("survival_kind", ["none", "binary"])
def test_particle_beam_transformed_to_matches_jax(index, survival_kind):
    jax_beam, torch_beam = particle_pair(survival_kind)
    kwargs = TRANSFORMS[index]
    expected = jax_beam.transformed_to(**{k: jnp.asarray(v) for k, v in kwargs.items()})
    actual = torch_beam.transformed_to(
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in kwargs.items()}
    )
    assert_close(actual.particles, expected.particles)
    assert_close(actual.particle_charges, expected.particle_charges)
    assert_close(actual.energy, expected.energy)
    assert actual.survival is torch_beam.survival
    assert_same_statistics(actual, expected)


@pytest.mark.parametrize("index", range(len(TRANSFORMS)))
def test_parameter_beam_transformed_to_matches_jax(index):
    """Both packages rebuild from the parameters, so the x-x', y-y' and s-p
    correlations are dropped (pinned here)."""
    jax_beam, torch_beam = parameter_pair()
    kwargs = TRANSFORMS[index]
    expected = jax_beam.transformed_to(**{k: jnp.asarray(v) for k, v in kwargs.items()})
    actual = torch_beam.transformed_to(
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in kwargs.items()}
    )
    assert actual._mu.dtype == torch.float64 and actual._mu.device.type == "cpu"
    assert_close(actual._mu, expected._mu)
    assert_close(actual._cov, expected._cov)
    assert float(actual.sigma_xxp.abs().max()) == 0.0


def test_coordinate_setters_len_and_repr():
    jax_beam, torch_beam = particle_pair()
    for index, name in enumerate(("xs", "xps", "ys", "yps", "ss", "ps")):
        value = np.full((2, 3000), 1e-6 * (index + 1))
        setattr(jax_beam, name, jnp.asarray(value))
        setattr(torch_beam, name, torch.from_numpy(value))
    assert_close(torch_beam.particles, jax_beam.particles)
    assert len(torch_beam) == len(jax_beam) == 3000
    for beam in (torch_beam, parameter_pair()[1]):
        text = repr(beam)
        assert text.startswith(type(beam).__name__) and "emittance" not in text
        assert all(f"{name}=" in text for name in PARAMETERS)
    assert repr(torch_beam).startswith("ParticleBeam(n=3000,")


def test_coordinate_setter_keeps_the_gradient():
    values = torch.tensor([1e-4, 2e-4, -1e-4], dtype=torch.float64, requires_grad=True)
    beam = ltt.ParticleBeam(torch.ones(1, 3, 7, dtype=torch.float64), torch.tensor([1e8]))
    beam.xs = values
    (grad,) = torch.autograd.grad(beam.mu_x.sum(), values)
    assert torch.allclose(grad, torch.full((3,), 1 / 3, dtype=torch.float64))


def test_seed_seeds_the_default_generators():
    ltt.seed(123)
    first = ltt.ParticleBeam.from_parameters(num_particles=50, device="cpu")
    ltt.seed(123)
    second = ltt.ParticleBeam.from_parameters(num_particles=50, device="cpu")
    third = ltt.ParticleBeam.from_parameters(num_particles=50, device="cpu")
    assert torch.equal(first.particles, second.particles)
    assert not torch.equal(second.particles, third.particles)
    explicit = ltt.ParticleBeam.from_parameters(
        num_particles=50, generator=torch.Generator().manual_seed(7))
    ltt.seed(123)
    again = ltt.ParticleBeam.from_parameters(
        num_particles=50, generator=torch.Generator().manual_seed(7))
    assert torch.equal(explicit.particles, again.particles)


# -- gradients at the flagship screen ----------------------------------------------


def test_twiss_gradient_at_the_flagship_screen_matches_jax():
    """d(emittance_x)/dk1 and d(beta_x)/dk1 of AREAMQZM1 at AREABSCR1's
    plane (screen inactive), a ParameterBeam from_twiss through the EA
    subcell at the flagship point, float64, against ``jax.grad``."""
    twiss = dict(beta_x=5.91, alpha_x=3.55, emittance_x=3.494e-9, beta_y=5.91, alpha_y=3.55,
                 emittance_y=3.497e-9, energy=1.073e8, sigma_s=8e-6, sigma_p=2e-3)
    k1 = np.array([torch_ares.FLAGSHIP_K1["AREAMQZM1"]])

    reference = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a,
        jax_ares_ea_segment(),
    )
    reference.AREABSCR1.is_active = False
    for name, value in torch_ares.FLAGSHIP_K1.items():
        getattr(reference, name).k1 = jnp.asarray([value], dtype=jnp.float64)
    jax_beam = lt.ParameterBeam.from_twiss(
        **{k: jnp.asarray([v]) for k, v in twiss.items()}, dtype=jnp.float64)

    def jax_value(quantity):
        def value(k):
            segment = jax.tree_util.tree_map(lambda a: a, reference)
            segment.AREAMQZM1.k1 = k
            outgoing, _ = jax_functional.track(segment, jax_beam)
            return getattr(outgoing, quantity)[0]
        return value

    segment = torch_ares.ares_ea_segment(dtype=torch.float64, device="cpu")
    segment.AREABSCR1.is_active = False
    for name, value in torch_ares.FLAGSHIP_K1.items():
        getattr(segment, name).k1 = torch.tensor([value], dtype=torch.float64)
    torch_beam = ltt.ParameterBeam.from_twiss(
        **{k: torch.tensor([v], dtype=torch.float64) for k, v in twiss.items()},
        dtype=torch.float64, device="cpu",
    )
    for quantity in ("emittance_x", "beta_x"):
        k = torch.tensor(k1, dtype=torch.float64, requires_grad=True)
        segment.AREAMQZM1.k1 = k
        outgoing, _ = functional.track(segment, torch_beam)
        value = getattr(outgoing, quantity)[0]
        (grad,) = torch.autograd.grad(value, k)
        expected_value, expected_grad = jax.value_and_grad(jax_value(quantity))(jnp.asarray(k1))
        assert_close(value, expected_value)
        # Held on the value's own scale per unit k1: the EA subcell is
        # uncoupled, so the emittance is invariant and its derivative is
        # rounding noise in both packages.
        np.testing.assert_allclose(grad.numpy(), np.asarray(expected_grad), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * abs(float(value.detach())) / abs(k1[0]))
    assert abs(float(grad[0])) * abs(k1[0]) > 1e-3 * float(value.detach())  # beta_x moves
