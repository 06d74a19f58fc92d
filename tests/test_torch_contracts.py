"""The JAX suite's behavioural contracts on the PyTorch port, on the CPU:
``tests/test_moment_sufficiency.py``, ``test_differentiable.py``,
``test_split.py``, ``test_speed_optimizations.py``, ``test_screen.py``,
``test_window_autosize.py``, ``test_misc.py``, ``test_routing.py``,
``test_jit.py`` and ``test_traced_reading_warning.py``, at their
parameters and tolerances.

Beams sampled in the JAX tests from a ``jax.random`` key are sampled here
from a seeded ``torch.Generator`` (the contracts hold statistics of the
distribution, or compare two routes on one draw).  The JAX-only mechanisms
have counterparts: a platform argument and JAX's tracing become the
tensor's device and the routing overrides; "re-tuning does not recompile"
becomes "re-tuning builds no new kernel library and no new tape"; a traced
track's warning has no counterpart (the port always tracks eagerly and
stores readings).  Contracts the port's other tests already hold are
listed in ROADMAP.md's contract table, not repeated here.  The gradients of
``test_differentiable.py`` are also held, in float64, to ``jax.grad`` of the
same lattices (carried over with ``from_jax_arrays``) at 1e-10.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import lynx_tpu as lt
import lynx_tpu.functional as jax_functional
import lynx_tpu_torch as ltt
from lynx_tpu.models import ares_ea_segment as jax_ares_ea_segment
from lynx_tpu_torch import _build, functional
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.accelerator import segment as segment_module
from lynx_tpu_torch.converters import latticejson
from lynx_tpu_torch.envs import make_env
from lynx_tpu_torch.models import ares, ares_ea_segment, fodo_cell, fodo_lattice
from lynx_tpu_torch.ops import fused_track as ft
from lynx_tpu_torch.ops import histogram as hist

F64 = torch.float64


def t(*values, dtype=torch.float32):
    return torch.tensor(values, dtype=dtype)


def t64(*values):
    return torch.tensor(values, dtype=F64)


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def routes(monkeypatch):
    """Restore every routing knob a test sets."""
    for module, name in ((segment_module, "FUSED_SWEEP_PATH"),
                         (segment_module, "PARTICLE_SWEEP_PATH"),
                         (segment_module, "PALLAS_SWEEP_THRESHOLD"),
                         (ft, "PARTICLE_MOMENT_SWEEP_PATH"), (ft, "PACKED_MOMENT_SWEEP"),
                         (hist, "SCREEN_WINDOWED_PATH")):
        monkeypatch.setattr(module, name, getattr(module, name))
    return monkeypatch


# -- the API's small gaps --------------------------------------------------------


def test_plain_to_feature_and_the_base_beam_constructors():
    """``latticejson.plain_to_feature`` and the base ``Beam``'s classmethod
    stubs behave as the JAX package's."""
    assert latticejson.plain_to_feature("rectangular") == "rectangular"
    assert latticejson.plain_to_feature(True) is True
    value = latticejson.plain_to_feature([0.5, 1.5], device="cpu")
    assert isinstance(value, torch.Tensor) and value.tolist() == [0.5, 1.5]
    assert latticejson.feature_to_plain(value) == [0.5, 1.5]
    for name, args in (("from_parameters", ()), ("from_twiss", ()), ("from_ocelot", (None,)),
                       ("from_astra", ("beam.ini",))):
        with pytest.raises(NotImplementedError):
            getattr(ltt.Beam, name)(*args)
    assert ltt.ParameterBeam.from_parameters(device="cpu").energy.shape == (1,)


# -- moment sufficiency (test_moment_sufficiency.py) ------------------------------

STAT_NAMES = ["mu_x", "sigma_x", "mu_xp", "sigma_xp", "mu_y", "sigma_y", "mu_yp", "sigma_yp",
              "mu_s", "sigma_s", "mu_p", "sigma_p"]


def sampled_beam(seed=0, n=2000, dtype=F64, survival=False):
    beam = ltt.ParticleBeam.from_parameters(
        num_particles=n, mu_x=t(3e-5), mu_yp=t(-1e-5), sigma_x=t(1.75e-4), sigma_y=t(1.75e-4),
        sigma_p=t(2e-3), energy=t(1.073e8), generator=gen(seed), dtype=dtype)
    if survival:
        weights = (torch.rand((1, n), generator=gen(seed + 1)) > 0.25).to(dtype)
        beam = ltt.ParticleBeam(beam.particles, beam.energy,
                                particle_charges=beam.particle_charges, survival=weights)
    return beam


def assert_stats(actual, expected, names=STAT_NAMES, **tolerances):
    for name in names:
        np.testing.assert_allclose(getattr(actual, name).detach().numpy(),
                                   getattr(expected, name).detach().numpy(), err_msg=name,
                                   **tolerances)


@pytest.mark.parametrize("survival", [False, True])
def test_as_parameter_beam_matches_sample_stats(survival):
    beam = sampled_beam(survival=survival)
    moments = beam.as_parameter_beam()
    assert_stats(moments, beam, rtol=1e-12)
    np.testing.assert_allclose(moments.total_charge.numpy(), beam.total_charge.numpy())
    assert float(moments._mu[0, 6]) == 1.0
    assert torch.all(moments._cov[0, 6, :] == 0)


@pytest.mark.parametrize("survival", [False, True])
def test_moment_path_is_exact_through_linear_lattice(survival):
    segment = ltt.Segment([
        ltt.Drift(length=t64(0.2)),
        ltt.Quadrupole(length=t64(0.12), k1=t64(6.0), tilt=t64(0.1)),
        ltt.HorizontalCorrector(length=t64(0.02), angle=t64(2e-3)),
        ltt.Dipole(length=t64(0.3), angle=t64(0.05)),
        ltt.Solenoid(length=t64(0.15), k=t64(2.0)),
        ltt.Drift(length=t64(0.5)),
    ])
    beam = sampled_beam(survival=survival)
    assert ltt.moment_sufficient(segment, beam)
    particles, _ = functional.track(segment, beam)
    moments, _ = functional.track(segment, beam.as_parameter_beam())
    assert_stats(moments, particles, rtol=1e-10, atol=1e-18)


@pytest.mark.parametrize("seed", range(5))
def test_moment_path_exactness_fuzz(seed):
    """Random linear lattices (the JAX test's numpy draws), float64."""
    rng = np.random.default_rng(seed)
    elements = []
    for _ in range(rng.integers(3, 9)):
        kind = rng.integers(0, 6)
        if kind == 0:
            elements.append(ltt.Drift(t64(rng.uniform(0.05, 1.0)), dtype=F64))
        elif kind == 1:
            elements.append(ltt.Quadrupole(t64(rng.uniform(0.05, 0.3)), k1=t64(rng.uniform(-20, 20)),
                                           tilt=t64(rng.uniform(-0.3, 0.3)), dtype=F64))
        elif kind == 2:
            elements.append(ltt.Dipole(t64(rng.uniform(0.1, 0.5)),
                                       angle=t64(rng.uniform(-0.1, 0.1)),
                                       e1=t64(rng.uniform(-0.05, 0.05)), dtype=F64))
        elif kind == 3:
            elements.append(ltt.Solenoid(t64(rng.uniform(0.1, 0.4)), k=t64(rng.uniform(0.0, 5.0)),
                                         dtype=F64))
        elif kind == 4:
            cls = ltt.HorizontalCorrector if rng.integers(0, 2) else ltt.VerticalCorrector
            elements.append(cls(t64(rng.uniform(0.01, 0.1)), angle=t64(rng.uniform(-3e-3, 3e-3)),
                                dtype=F64))
        else:
            elements.append(ltt.Marker(device="cpu"))
    segment = ltt.Segment(elements)
    beam = sampled_beam(seed=100 + seed, n=1500, survival=bool(seed % 2))
    assert ltt.moment_sufficient(segment, beam)
    particles, _ = functional.track(segment, beam)
    moments, _ = functional.track(segment, beam.as_parameter_beam())
    assert_stats(moments, particles, rtol=1e-9, atol=1e-17)


def test_moment_sufficient_rejects_per_particle_elements():
    beam = sampled_beam()
    drift = ltt.Drift(length=t64(0.2))
    aperture = ltt.Aperture(x_max=t(1e-4), y_max=t(1e-4), is_active=True)
    cavity = ltt.Cavity(length=t(1.0), voltage=t(1e6), frequency=t(1.3e9))
    assert ltt.moment_sufficient(ltt.Segment([drift]), beam)
    assert not ltt.moment_sufficient(ltt.Segment([drift, aperture]), beam)
    assert not ltt.moment_sufficient(ltt.Segment([drift, ltt.Screen(is_active=True,
                                                                    device="cpu")]), beam)
    assert not ltt.moment_sufficient(ltt.Segment([drift, cavity]), beam)
    assert ltt.moment_sufficient(ltt.Segment([drift, ltt.Screen(is_active=False, device="cpu")]),
                                 beam)
    assert not ltt.moment_sufficient(ltt.Segment([drift]), beam.as_parameter_beam())


def env_magnets(seed, B, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 5))).to(dtype)


def test_env_auto_routes_to_moments_and_matches_particles():
    env = make_env(dtype=F64, device="cpu")
    beam = sampled_beam(n=4000)
    magnets = env_magnets(7, 5, F64)
    auto = env.batched_particle_beam_parameters(magnets, beam)
    moments = env.batched_particle_beam_parameters(magnets, beam, method="moments")
    particles = env.batched_particle_beam_parameters(magnets, beam, method="particles")
    assert torch.equal(auto, moments)
    np.testing.assert_allclose(moments.numpy(), particles.numpy(), rtol=1e-9, atol=1e-15)


def test_env_moment_route_f32():
    """The moment route in float32 against pushing the particles (JAX runs
    it under jit; the port has no tracing)."""
    env = make_env(device="cpu")
    beam = sampled_beam(n=4000, dtype=torch.float32)
    magnets = env_magnets(9, 8, torch.float32)
    np.testing.assert_allclose(
        env.batched_particle_beam_parameters(magnets, beam).numpy(),
        env.batched_particle_beam_parameters(magnets, beam, method="particles").numpy(),
        rtol=3e-3, atol=1e-9)


def test_moment_route_is_differentiable():
    env = make_env(device="cpu")
    beam = sampled_beam(n=1000, dtype=torch.float32)
    magnets = torch.zeros((4, env.num_actions), requires_grad=True)
    out = env.batched_particle_beam_parameters(magnets, beam)
    (grads,) = torch.autograd.grad(torch.sum(out[:, 1] ** 2 + out[:, 3] ** 2), magnets)
    assert bool(torch.isfinite(grads).all()) and float(grads.abs().max()) > 0.0


# -- differentiability (test_differentiable.py) -------------------------------------
# Each test keeps the JAX test's own check (float32: finite, non-zero) and
# holds the port's gradient in float64 against ``jax.grad`` of the same
# lattice, carried over with ``from_jax_arrays``, on the same particles.

GRAD_PARITY_RTOL = 1e-10


def diff_beam(dtype=torch.float32):
    return ltt.ParticleBeam.from_parameters(
        num_particles=5_000, sigma_x=t(1.75e-4), sigma_y=t(1.75e-4), sigma_xp=t(2e-5),
        sigma_yp=t(2e-5), energy=t(1e8), generator=gen(0), dtype=dtype)


def jax_beam_of(beam):
    """The JAX package's ParticleBeam of the port's ``beam`` (same numbers)."""
    return lt.ParticleBeam(jnp.asarray(beam.particles.detach().numpy()),
                           jnp.asarray(beam.energy.detach().numpy()),
                           particle_charges=jnp.asarray(beam.particle_charges.numpy()))


def jax64(*values):
    return jnp.asarray(values, dtype=jnp.float64)


def tuned(element, field):
    """The port ``element``'s ``field`` made a leaf that requires grad."""
    value = getattr(element, field).detach().clone().requires_grad_(True)
    setattr(element, field, value)
    return value


def assert_finite_nonzero(grad, nonzero=True):
    assert bool(torch.isfinite(grad).all())
    if nonzero:
        assert float(grad.abs().max()) > 0


def assert_matches_jax(grad, expected):
    expected = np.asarray(expected)
    assert grad.dtype == torch.float64 and expected.dtype == np.float64
    assert grad.shape == expected.shape and float(np.abs(expected).max()) > 0
    np.testing.assert_allclose(grad.detach().numpy(), expected, rtol=GRAD_PARITY_RTOL,
                               atol=GRAD_PARITY_RTOL * float(np.abs(expected).max()))


def dqd(k1):
    return lt.Segment([lt.Drift(length=jax64(0.5), dtype=jnp.float64),
                       lt.Quadrupole(length=jax64(0.2), k1=k1, dtype=jnp.float64),
                       lt.Drift(length=jax64(0.5), dtype=jnp.float64)])


def test_grad_through_dqd_wrt_k1():
    beam = diff_beam()
    k1 = t(4.2).requires_grad_(True)
    segment = ltt.Segment([ltt.Drift(length=t(0.5)), ltt.Quadrupole(length=t(0.2), k1=k1),
                           ltt.Drift(length=t(0.5))])
    (g,) = torch.autograd.grad(torch.sum(segment.track(beam).sigma_x ** 2), k1)
    assert_finite_nonzero(g)

    beam64 = diff_beam(F64)
    jax_beam = jax_beam_of(beam64)
    expected = jax.grad(lambda k: jnp.sum(dqd(k).track(jax_beam).sigma_x ** 2))(jax64(4.2))
    ours = latticejson.from_jax_arrays(dqd(jax64(4.2)), device="cpu")
    k1 = tuned(ours.elements[1], "k1")
    (g,) = torch.autograd.grad(torch.sum(ours.track(beam64).sigma_x ** 2), k1)
    assert_matches_jax(g, expected)


def segment_with_corrector(array, lattice, **dtype):
    return lattice.Segment([
        lattice.Drift(length=array(0.5), name="d1", **dtype),
        lattice.Quadrupole(length=array(0.2), k1=array(4.2), name="q1", **dtype),
        lattice.HorizontalCorrector(length=array(0.1), angle=array(1e-4), name="hc", **dtype),
        lattice.Drift(length=array(0.5), name="d2", **dtype),
    ], name="seg")


def test_grad_wrt_segment_parameters():
    """Gradients with respect to the segment's own fields (JAX: a
    segment-shaped pytree gradient)."""
    beam = diff_beam()
    segment = segment_with_corrector(t, ltt)
    segment.q1.k1 = segment.q1.k1.clone().requires_grad_(True)
    segment.hc.angle = segment.hc.angle.clone().requires_grad_(True)
    out, _ = functional.track(segment, beam)
    g_k1, g_angle = torch.autograd.grad(torch.sum(out.sigma_x ** 2) + torch.sum(out.mu_x ** 2),
                                        [segment.q1.k1, segment.hc.angle])
    assert_finite_nonzero(g_k1)
    assert_finite_nonzero(g_angle)

    beam64 = diff_beam(F64)
    jax_beam = jax_beam_of(beam64)

    def jax_loss(segment):
        out, _ = jax_functional.track(segment, jax_beam)
        return jnp.sum(out.sigma_x ** 2) + jnp.sum(out.mu_x ** 2)

    reference = segment_with_corrector(jax64, lt, dtype=jnp.float64)
    expected = jax.grad(jax_loss)(reference)
    ours = latticejson.from_jax_arrays(reference, device="cpu")
    fields = [tuned(ours.q1, "k1"), tuned(ours.hc, "angle")]
    out, _ = functional.track(ours, beam64)
    g_k1, g_angle = torch.autograd.grad(torch.sum(out.sigma_x ** 2) + torch.sum(out.mu_x ** 2),
                                        fields)
    assert_matches_jax(g_k1, expected.q1.k1)
    assert_matches_jax(g_angle, expected.hc.angle)


def test_grad_wrt_incoming_beam():
    segment = ltt.Segment([ltt.Drift(length=t(0.5)), ltt.Quadrupole(length=t(0.2), k1=t(4.2))])
    beam = diff_beam()
    particles = beam.particles.clone().requires_grad_(True)
    moved = ltt.ParticleBeam(particles, beam.energy, particle_charges=beam.particle_charges)
    (g,) = torch.autograd.grad(torch.sum(segment.track(moved).sigma_x ** 2), particles)
    assert g.shape == beam.particles.shape
    assert_finite_nonzero(g)

    beam64 = diff_beam(F64)
    jax_beam = jax_beam_of(beam64)
    reference = lt.Segment([lt.Drift(length=jax64(0.5), dtype=jnp.float64),
                            lt.Quadrupole(length=jax64(0.2), k1=jax64(4.2), dtype=jnp.float64)])

    def jax_loss(particles):
        moved = lt.ParticleBeam(particles, jax_beam.energy,
                                particle_charges=jax_beam.particle_charges)
        return jnp.sum(reference.track(moved).sigma_x ** 2)

    expected = jax.grad(jax_loss)(jax_beam.particles)
    particles = beam64.particles.clone().requires_grad_(True)
    moved = ltt.ParticleBeam(particles, beam64.energy, particle_charges=beam64.particle_charges)
    ours = latticejson.from_jax_arrays(reference, device="cpu")
    (g,) = torch.autograd.grad(torch.sum(ours.track(moved).sigma_x ** 2), particles)
    assert_matches_jax(g, expected)


def test_grad_through_ares_ea():
    segment = ares_ea_segment(device="cpu")
    segment.AREAMQZM1.k1 = segment.AREAMQZM1.k1.clone().requires_grad_(True)
    out, _ = functional.track(segment, diff_beam())
    assert out is not None  # the screen is inactive
    (g,) = torch.autograd.grad(torch.sum(out.sigma_x ** 2), segment.AREAMQZM1.k1)
    assert_finite_nonzero(g)

    # In float64 against jax.grad at the flagship point: at the subcell's
    # default k1 = 0 d/dk1 is rounding-limited in both packages (ROADMAP
    # section C).
    beam64 = diff_beam(F64)
    jax_beam = jax_beam_of(beam64)
    reference = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a,
        jax_ares_ea_segment())
    for name, value in ares.FLAGSHIP_K1.items():
        getattr(reference, name).k1 = jax64(value)

    def jax_loss(segment):
        out, _ = jax_functional.track(segment, jax_beam)
        return jnp.sum(out.sigma_x ** 2)

    expected = jax.grad(jax_loss)(reference).AREAMQZM1.k1
    ours = latticejson.from_jax_arrays(reference, device="cpu")
    k1 = tuned(ours.AREAMQZM1, "k1")
    out, _ = functional.track(ours, beam64)
    (g,) = torch.autograd.grad(torch.sum(out.sigma_x ** 2), k1)
    assert_matches_jax(g, expected)


def test_grad_through_cavity():
    beam = ltt.ParameterBeam.from_parameters(sigma_x=t(1e-4), energy=t(6e6), device="cpu")
    voltage = t(0.01815975e9).requires_grad_(True)
    cavity = ltt.Cavity(length=t(1.0377), voltage=voltage, frequency=t(1.3e9), phase=t(0.0))
    (g,) = torch.autograd.grad(torch.sum(cavity.track(beam).sigma_x ** 2) * 1e12, voltage)
    assert_finite_nonzero(g)

    jax_beam = lt.ParameterBeam.from_parameters(sigma_x=jax64(1e-4), energy=jax64(6e6),
                                                dtype=jnp.float64)

    def cavity_of(voltage):
        return lt.Cavity(length=jax64(1.0377), voltage=voltage, frequency=jax64(1.3e9),
                         phase=jax64(0.0), dtype=jnp.float64)

    expected = jax.grad(lambda v: jnp.sum(cavity_of(v).track(jax_beam).sigma_x ** 2) * 1e12)(
        jax64(0.01815975e9))
    ours = latticejson.from_jax_arrays(cavity_of(jax64(0.01815975e9)), device="cpu")
    voltage = tuned(ours, "voltage")
    beam64 = ltt.ParameterBeam.from_parameters(sigma_x=t64(1e-4), energy=t64(6e6), dtype=F64,
                                               device="cpu")
    (g,) = torch.autograd.grad(torch.sum(ours.track(beam64).sigma_x ** 2) * 1e12, voltage)
    assert_matches_jax(g, expected)


def test_grad_through_screen_image_route():
    beam = diff_beam()
    k1 = t(4.2).requires_grad_(True)
    segment = ltt.Segment([ltt.Quadrupole(length=t(0.2), k1=k1, name="q"),
                           ltt.Drift(length=t(0.5))])
    out, _ = functional.track(segment, beam)
    (g,) = torch.autograd.grad(torch.sum(out.sigma_x ** 2) * 1e8, k1)
    assert_finite_nonzero(g, nonzero=False)

    beam64 = diff_beam(F64)
    jax_beam = jax_beam_of(beam64)

    def reference(k1):
        return lt.Segment([lt.Quadrupole(length=jax64(0.2), k1=k1, name="q", dtype=jnp.float64),
                           lt.Drift(length=jax64(0.5), dtype=jnp.float64)])

    def jax_loss(k1):
        out, _ = jax_functional.track(reference(k1), jax_beam)
        return jnp.sum(out.sigma_x ** 2) * 1e8

    expected = jax.grad(jax_loss)(jax64(4.2))
    ours = latticejson.from_jax_arrays(reference(jax64(4.2)), device="cpu")
    k1 = tuned(ours.q, "k1")
    out, _ = functional.track(ours, beam64)
    (g,) = torch.autograd.grad(torch.sum(out.sigma_x ** 2) * 1e8, k1)
    assert_matches_jax(g, expected)


# -- splitting (test_split.py) ------------------------------------------------------


def split_beam():
    return ltt.ParticleBeam.from_parameters(num_particles=5_000, sigma_x=t(1.75e-4),
                                            sigma_xp=t(2e-5), energy=t(1e8), generator=gen(0))


def assert_particles(actual, expected, rtol=1e-4, atol=1e-9):
    np.testing.assert_allclose(actual.particles.detach().numpy(),
                               expected.particles.detach().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("element", [
    lambda: ltt.Drift(length=t(1.0)),
    lambda: ltt.Quadrupole(length=t(0.6), k1=t(4.2)),
], ids=["drift", "quadrupole"])
def test_split_end_state_equals_unsplit(element):
    element, beam = element(), split_beam()
    split_segment = ltt.Segment(element.split(resolution=0.13))
    assert_particles(split_segment.track(beam), element.track(beam))
    np.testing.assert_allclose(float(split_segment.length.reshape(-1)[0]),
                               float(element.length.reshape(-1)[0]), rtol=1e-6)


@pytest.mark.parametrize("cls", [ltt.HorizontalCorrector, ltt.VerticalCorrector],
                         ids=["hcor", "vcor"])
def test_corrector_split_distributes_kick(cls):
    element, beam = cls(length=t(0.4), angle=t(1e-4)), split_beam()
    unsplit = element.track(beam)
    pieces = element.split(resolution=0.13)
    np.testing.assert_allclose(sum(float(p.angle[0]) for p in pieces), 1e-4, rtol=1e-6)
    split_out = ltt.Segment(pieces).track(beam)
    for name in ("mu_xp", "mu_yp"):
        np.testing.assert_allclose(getattr(split_out, name).numpy(), getattr(unsplit, name).numpy(),
                                   rtol=1e-5, atol=1e-12)
    assert abs(float(split_out.mu_x[0]) - float(unsplit.mu_x[0])) < 1e-4 * 0.4
    assert abs(float(split_out.mu_y[0]) - float(unsplit.mu_y[0])) < 1e-4 * 0.4


def test_unsplittable_elements_return_self():
    element = ltt.Dipole(length=t(0.0), angle=t(0.01))
    assert element.split(resolution=0.1) == [element]


def test_segment_split_concatenates():
    segment = ltt.Segment([ltt.Drift(length=t(0.5)), ltt.Quadrupole(length=t(0.2), k1=t(4.2))])
    splits = segment.split(resolution=0.1)
    assert len(splits) == 5 + 2
    np.testing.assert_allclose(sum(float(s.length.reshape(-1)[0]) for s in splits), 0.7,
                               rtol=1e-6)


def test_dipole_split_end_state_equals_unsplit():
    element = ltt.Dipole(length=t(0.8), angle=t(0.12), e1=t(0.03), e2=t(-0.02), tilt=t(0.1),
                         fringe_integral=t(0.45), gap=t(0.02))
    pieces = element.split(resolution=0.13)
    assert len(pieces) == 7
    beam = split_beam()
    assert_particles(ltt.Segment(pieces).track(beam), element.track(beam))


def test_rbend_split_end_state_equals_unsplit():
    element = ltt.RBend(length=t(0.6), angle=t(0.08), fringe_integral=t(0.3), gap=t(0.02))
    beam = split_beam()
    assert_particles(ltt.Segment(element.split(resolution=0.1)).track(beam), element.track(beam))


@pytest.mark.parametrize("element", [
    lambda: ltt.Solenoid(length=t(0.5), k=t(3.0), misalignment=torch.tensor([[1e-4, -2e-4]])),
    lambda: ltt.Undulator(length=t(0.5)),
], ids=["solenoid", "undulator"])
def test_exactly_composing_splits(element):
    element, beam = element(), split_beam()
    pieces = element.split(resolution=0.12)
    assert len(pieces) == 5
    assert_particles(ltt.Segment(pieces).track(beam), element.track(beam))


def test_cavity_split_converges_to_unsplit():
    element = ltt.Cavity(length=t(1.0), voltage=t(2e7), phase=t(-15.0), frequency=t(1.3e9))
    beam = split_beam()
    unsplit = element.track(beam)

    def max_err(resolution):
        out = ltt.Segment(element.split(resolution)).track(beam)
        return float((out.particles - unsplit.particles).abs().max())

    np.testing.assert_allclose(sum(float(p.voltage[0]) for p in element.split(0.25)), 2e7,
                               rtol=1e-6)
    assert max_err(0.5) < 1e-7
    assert max_err(0.125) < 1e-7


@pytest.mark.parametrize("resolution", [0.2, 0.05, 0.01])
def test_cavity_split_error_budget_at_plot_resolutions(resolution):
    """The sliced Bmad-golden cavity stays within 1e-5 of the single map,
    relative to each coordinate's scale; energies agree to 1e-12."""
    cavity = ltt.Cavity(length=t64(1.0377), voltage=t64(1.815975e7), phase=t64(0.0),
                        frequency=t64(1.3e9), dtype=F64)
    beam = ltt.ParticleBeam.from_parameters(num_particles=10, sigma_x=t(2e-4), sigma_p=t(2e-3),
                                            energy=t(6e6), generator=gen(0), dtype=F64)
    unsplit = cavity.track(beam)
    out = ltt.Segment(cavity.split(resolution)).track(beam)
    reference = unsplit.particles.numpy()
    scale = np.abs(reference).max(axis=(0, 1))
    deviation = np.abs(out.particles.numpy() - reference) / scale
    assert deviation.max() < 1e-5, deviation.max()
    np.testing.assert_allclose(out.energy.numpy(), unsplit.energy.numpy(), rtol=1e-12)


# -- the optimisation passes (test_speed_optimizations.py) ---------------------------

OPT_STATS = ("mu_x", "mu_xp", "mu_y", "mu_yp", "sigma_x", "sigma_xp", "sigma_y", "sigma_yp",
             "sigma_s", "sigma_p", "energy")


def opt_segment():
    return ltt.Segment([
        ltt.Drift(length=t(0.6), name="d1"),
        ltt.Marker(name="m1", device="cpu"),
        ltt.Quadrupole(length=t(0.2), k1=t(4.2), name="q1"),
        ltt.Drift(length=t(0.4), name="d2"),
        ltt.HorizontalCorrector(length=t(0.1), angle=t(2e-4), name="hc1"),
        ltt.Drift(length=t(0.3), name="d3"),
        ltt.Quadrupole(length=t(0.2), k1=t(0.0), name="q2"),
        ltt.Marker(name="m2", device="cpu"),
    ], name="seg")


def opt_beam():
    return ltt.ParameterBeam.from_parameters(sigma_x=t(1.75e-4), sigma_p=t(2e-3), energy=t(1e8),
                                             device="cpu")


@pytest.mark.parametrize("batch", [None, 10], ids=["unbatched", "broadcast"])
def test_merged_transfer_maps_preserve_stats(batch):
    segment, beam = opt_segment(), opt_beam()
    if batch:
        segment, beam = segment.broadcast((batch,)), beam.broadcast((batch,))
    merged = segment.transfer_maps_merged(incoming_beam=beam)
    assert_stats(merged.track(beam), segment.track(beam), OPT_STATS, rtol=1e-5, atol=1e-10)


def test_merged_segment_has_single_element():
    merged = opt_segment().transfer_maps_merged(incoming_beam=opt_beam())
    assert len(merged.elements) == 1 and isinstance(merged.elements[0], ltt.CustomTransferMap)


def test_merged_with_except_for_keeps_element_live():
    merged = opt_segment().transfer_maps_merged(incoming_beam=opt_beam(), except_for=["q1"])
    assert "q1" in [el.name for el in merged.elements] and len(merged.elements) == 3
    before = merged.track(opt_beam())
    merged.q1.k1 = t(-4.2)
    assert not np.allclose(before.sigma_x.numpy(), merged.track(opt_beam()).sigma_x.numpy())


def test_without_inactive_markers():
    segment = opt_segment()
    no_markers = segment.without_inactive_markers()
    assert not any(isinstance(el, ltt.Marker) for el in no_markers.elements)
    np.testing.assert_allclose(segment.track(opt_beam()).sigma_x.numpy(),
                               no_markers.track(opt_beam()).sigma_x.numpy(), rtol=1e-6)
    names = [el.name for el in segment.without_inactive_markers(except_for=["m2"]).elements]
    assert "m2" in names and "m1" not in names


def test_inactive_elements_as_drifts():
    segment = opt_segment()
    as_drifts = segment.inactive_elements_as_drifts()
    assert isinstance(as_drifts.q2, ltt.Drift) and isinstance(as_drifts.q1, ltt.Quadrupole)
    np.testing.assert_allclose(segment.track(opt_beam()).sigma_x.numpy(),
                               as_drifts.track(opt_beam()).sigma_x.numpy(), rtol=1e-5)
    assert isinstance(segment.inactive_elements_as_drifts(except_for=["q2"]).q2, ltt.Quadrupole)


def test_without_inactive_zero_length_elements():
    names = [el.name for el in opt_segment().without_inactive_zero_length_elements().elements]
    assert "m1" not in names and "m2" not in names and "d1" in names and "q1" in names


def test_merged_tracks_batched_energy_through_cavity():
    """Merging downstream of a cavity with per-entry voltages uses each
    entry's own entrance energy."""
    segment = ltt.Segment([
        ltt.Drift(length=t(0.3), name="d0"),
        ltt.Cavity(length=t(1.0, 1.0), voltage=t(0.0, 5e7), phase=t(0.0, 0.0),
                   frequency=t(1.3e9, 1.3e9), name="cav"),
        ltt.Drift(length=t(0.5), name="d1"),
        ltt.Quadrupole(length=t(0.2), k1=t(4.2), name="q1"),
        ltt.Drift(length=t(0.5), name="d2"),
    ], name="seg_cav").broadcast((2,))
    beam = opt_beam().broadcast((2,))
    merged = segment.transfer_maps_merged(incoming_beam=beam)
    assert_stats(merged.track(beam), segment.track(beam), OPT_STATS, rtol=1e-5, atol=1e-10)
    downstream = [el for el in merged.elements if isinstance(el, ltt.CustomTransferMap)][-1]
    tm = downstream._transfer_map.numpy()
    assert tm.shape[0] == 2 and not np.allclose(tm[0], tm[1])


# -- screens (test_screen.py) ---------------------------------------------------------


def screen_segment(name="my_screen"):
    return ltt.Segment([
        ltt.Drift(length=t(1.0)),
        ltt.Screen(resolution=(100, 100), pixel_size=t(1e-5, 1e-5), is_active=True, name=name),
    ])


@pytest.mark.parametrize("beam_type", [ltt.ParticleBeam, ltt.ParameterBeam],
                         ids=["particle", "parameter"])
def test_reading_shows_beam(astra_beam_path, beam_type):
    segment = screen_segment()
    beam = beam_type.from_astra(astra_beam_path, device="cpu")
    assert segment.my_screen.reading.shape == (1, 100, 100)
    assert torch.all(segment.my_screen.reading == 0.0)
    segment.track(beam)
    reading = segment.my_screen.reading
    assert isinstance(reading, torch.Tensor) and reading.shape == (1, 100, 100)
    assert bool(torch.all(reading >= 0.0)) and bool(torch.any(reading > 0.0))


def test_reading_shows_beam_ares(astra_beam_path):
    segment = ares_ea_segment(device="cpu")
    segment.AREABSCR1.resolution = (2448, 2040)
    segment.AREABSCR1.pixel_size = t(3.3198e-6, 2.4469e-6)
    segment.AREABSCR1.binning = 1
    segment.AREABSCR1.is_active = True
    assert segment.AREABSCR1.reading.shape == (1, 2040, 2448)
    assert torch.all(segment.AREABSCR1.reading == 0.0)
    segment.track(ltt.ParticleBeam.from_astra(astra_beam_path, device="cpu"))
    reading = segment.AREABSCR1.reading
    assert reading.shape == (1, 2040, 2448)
    assert bool(torch.all(reading >= 0.0)) and bool(torch.any(reading > 0.0))


def test_screen_binning_shrinks_image():
    screen = ltt.Screen(resolution=(128, 64), pixel_size=t(1e-5, 1e-5), binning=2, is_active=True)
    assert screen.effective_resolution == (64, 32)
    assert screen.reading.shape == (1, 32, 64)


def test_screen_histogram_conserves_particles():
    screen = ltt.Screen(resolution=(64, 64), pixel_size=t(1e-4, 1e-4), is_active=True)
    beam = ltt.ParticleBeam.from_parameters(num_particles=5000, sigma_x=t(1e-4), sigma_y=t(1e-4),
                                            generator=gen(0))
    assert ltt.Segment([screen]).track(beam) is ltt.Beam.empty
    assert np.isclose(float(screen.reading.sum()), 5000.0)


def test_screen_weighted_by_survival():
    segment = ltt.Segment([
        ltt.Aperture(x_max=t(5e-5), y_max=t(1.0), name="ap"),
        ltt.Screen(resolution=(64, 64), pixel_size=t(1e-4, 1e-4), is_active=True, name="scr"),
    ])
    beam = ltt.ParticleBeam.from_parameters(num_particles=5000, sigma_x=t(1e-4), sigma_y=t(1e-4),
                                            generator=gen(0))
    segment.track(beam)
    assert 0 < float(segment.scr.reading.sum()) < 5000


def test_parameter_and_particle_images_agree_on_orientation():
    screen = ltt.Screen(resolution=(64, 48), pixel_size=t(2e-5, 2e-5), is_active=True, name="s")
    kwargs = dict(mu_x=t(3e-4), mu_y=t(2e-4), sigma_x=t(5e-5), sigma_y=t(5e-5), energy=t(1e8))
    particle = ltt.ParticleBeam.from_parameters(num_particles=200_000, generator=gen(0), **kwargs)
    parameter = ltt.ParameterBeam.from_parameters(**kwargs, device="cpu")
    segment = ltt.Segment([screen])
    segment.track(particle)
    particle_image = screen.reading[0].numpy()
    screen.set_read_beam(None)
    segment.track(parameter)
    parameter_image = screen.reading[0].numpy()
    assert particle_image.shape == parameter_image.shape == (48, 64)
    peak_particle = np.unravel_index(np.argmax(particle_image), particle_image.shape)
    peak_parameter = np.unravel_index(np.argmax(parameter_image), parameter_image.shape)
    assert abs(peak_particle[0] - peak_parameter[0]) <= 1
    assert abs(peak_particle[1] - peak_parameter[1]) <= 1
    assert peak_particle[1] > 32 and peak_particle[0] < 24


def test_misaligned_screen_shifts_both_beam_types_identically():
    def center_of_mass(image):
        h, w = image.shape
        total = image.sum()
        return np.array([(image.sum(axis=1) * np.arange(h)).sum() / total,
                         (image.sum(axis=0) * np.arange(w)).sum() / total])

    kwargs = dict(sigma_x=t(5e-5), sigma_y=t(5e-5), energy=t(1e8))
    beams = {"particle": ltt.ParticleBeam.from_parameters(num_particles=500_000, generator=gen(2),
                                                          **kwargs),
             "parameter": ltt.ParameterBeam.from_parameters(**kwargs, device="cpu")}
    shifts = {}
    for label, beam in beams.items():
        images = {}
        for mis in [(0.0, 0.0), (2e-4, -1e-4)]:
            screen = ltt.Screen(resolution=(64, 48), pixel_size=t(2e-5, 2e-5),
                                misalignment=torch.tensor([mis]), is_active=True, name="s")
            ltt.Segment([screen]).track(beam)
            images[mis] = screen.reading[0].numpy()
        shifts[label] = center_of_mass(images[(2e-4, -1e-4)]) - center_of_mass(images[(0.0, 0.0)])
    np.testing.assert_allclose(shifts["particle"], shifts["parameter"], atol=0.25)
    assert shifts["parameter"][1] < -1 and shifts["parameter"][0] < -1


def test_broadcast_preserves_histogram_window():
    screen = ltt.Screen(resolution=(2448, 2040), pixel_size=t(3.5488e-6, 2.5003e-6),
                        is_active=True, name="s")
    screen.histogram_window = (256, 1024)
    assert screen.broadcast((8,)).histogram_window == (256, 1024)


# -- the histogram window (test_window_autosize.py) -------------------------------------


@pytest.fixture
def fallbacks():
    hist.reset_histogram_fallback_count()
    yield
    hist.reset_histogram_fallback_count()


def test_ares_ea_window_is_derived_not_hardcoded():
    window = ares_ea_segment(device="cpu").AREABSCR1.histogram_window
    assert window is not None and window != (256, 1024)
    assert ares_ea_segment(histogram_window=(64, 64),
                           device="cpu").AREABSCR1.histogram_window == (64, 64)
    assert ares_ea_segment(histogram_window=None, device="cpu").AREABSCR1.histogram_window is None


def test_derived_window_contains_the_flagship_spot():
    """The flagship beam (100k particles at the working point) lands inside
    the derived window with a 5% margin, and the routing audit agrees."""
    segment, beam = chip_smoke.flagship(torch, ares, ltt.ParticleBeam, 1, "cpu", seed=0)
    window = segment.AREABSCR1.histogram_window
    pixel = segment.AREABSCR1.pixel_size.numpy()
    segment.AREABSCR1.is_active = False
    out, _ = functional.track(segment, beam)
    xs, ys = out.xs.numpy(), out.ys.numpy()
    extent_x, extent_y = (xs.max() - xs.min()) / pixel[0], (ys.max() - ys.min()) / pixel[1]
    assert extent_x * 1.05 < window[0] and extent_y * 1.05 < window[1], (extent_x, extent_y)
    half_w, half_h = 2448 * pixel[0] / 2, 2040 * pixel[1] / 2
    fits = hist.window_fits(-out.ys, out.xs, torch.ones_like(out.xs), (-half_h, half_h),
                            (-half_w, half_w), (2040, 2448), (window[1], window[0]))
    assert bool(fits.all())


def test_derive_histogram_window_math():
    screen = ltt.Screen(resolution=(1000, 800), pixel_size=t(1e-5, 2e-5))
    beam = ltt.ParameterBeam.from_parameters(sigma_x=t(1e-3), sigma_y=t(1e-3), energy=t(1e8),
                                             device="cpu")
    wx, wy = screen.derive_histogram_window(beam, k_sigma=4.0)
    assert 800 <= wx <= 801 and 400 <= wy <= 401
    wide = ltt.ParameterBeam.from_parameters(sigma_x=t(1.0), sigma_y=t(1.0), energy=t(1e8),
                                             device="cpu")
    assert screen.derive_histogram_window(wide) == (1000, 800)


def spot(spread, n=512, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=n) * spread).float(),
            torch.from_numpy(rng.normal(size=n) * spread).float())


@pytest.mark.parametrize("windowed", [True, None], ids=["forced", "by device"])
def test_fallback_counter_counts_only_oversize_spots(fallbacks, windowed, routes):
    """A spot inside the window takes the windowed read; one past it falls
    back to the scatter, is counted once, and equals the scatter's image.
    Forced, the CPU runs B1's plain version; by device the screen read
    routes CPU tensors to the scatter before any window is tried."""
    routes.setattr(hist, "SCREEN_WINDOWED_PATH", windowed)
    ranges = ((-1.0, 1.0), (-1.0, 1.0))
    for spread, counted in ((0.01, 0), (0.9, 1)):
        x, y = spot(spread)
        image = hist.screen_histogram_2d(x, y, torch.ones(512), *ranges, (64, 256), window=(8, 128))
        assert hist.histogram_fallback_count() == (counted if windowed else 0)
        scatter = hist.weighted_histogram_2d(x, y, torch.ones(512), *ranges, (64, 256))
        assert torch.equal(image, scatter)


def test_window_fits_full_window_early_exit():
    x, y = t(0.1, 0.9), t(0.2, 0.8)
    fits = hist.window_fits(x, y, torch.ones(2), (0.0, 1.0), (0.0, 1.0), (64, 128), (64, 128))
    assert not bool(fits.any())
    assert not bool(hist.window_fits(x, y, torch.ones(2), (0.0, 1.0), (0.0, 1.0), (64, 128),
                                     (64, 128), per_row=False))


def test_window_fits_ignores_dead_particles():
    fits = hist.window_fits(t(0.5, 0.99), t(0.5, 0.99), t(1.0, 0.0), (0.0, 1.0), (0.0, 1.0),
                            (1024, 1024), (8, 128))
    assert bool(fits.all())


# -- equality, seeds, reprs (test_misc.py) ------------------------------------------------


def test_explicit_generator_overrides_the_seed():
    ltt.seed(123)
    a = ltt.ParticleBeam.from_parameters(num_particles=50, sigma_x=t(1e-4), generator=gen(7))
    ltt.seed(321)
    b = ltt.ParticleBeam.from_parameters(num_particles=50, sigma_x=t(1e-4), generator=gen(7))
    assert torch.equal(a.particles, b.particles)


def test_reprs_do_not_crash():
    elements = [
        ltt.Drift(t(0.5)), ltt.Quadrupole(t(0.2)), ltt.Dipole(t(0.3)), ltt.Cavity(t(1.0)),
        ltt.Screen(device="cpu"), ltt.BPM(device="cpu"), ltt.Marker(device="cpu"),
        ltt.Aperture(device="cpu"), ltt.Solenoid(t(0.2)), ltt.Undulator(t(0.3)),
        ltt.HorizontalCorrector(t(0.1)), ltt.VerticalCorrector(t(0.1)),
    ]
    assert repr(ltt.Segment(elements))
    assert all(repr(element) for element in elements)
    assert repr(ltt.ParticleBeam.from_parameters(num_particles=10, device="cpu"))
    assert repr(ltt.ParameterBeam.from_parameters(device="cpu"))


def test_segment_duplicate_names_return_list():
    segment = ltt.Segment([ltt.Drift(t(0.1), name="d"), ltt.Drift(t(0.2), name="d")])
    assert isinstance(segment.d, list) and len(segment.d) == 2


def test_beam_parameters_dict():
    params = ltt.ParameterBeam.from_parameters(sigma_x=t(1e-4), device="cpu").parameters
    assert set(params) >= {"mu_x", "mu_xp", "mu_y", "mu_yp", "sigma_x", "sigma_xp", "sigma_y",
                           "sigma_yp", "sigma_s", "sigma_p", "energy"}


def test_fodo_lattice_model():
    assert len(fodo_lattice(device="cpu").elements) == 1058
    small = fodo_lattice(num_cells=3, with_steerers=False, device="cpu")
    assert len(small.elements) == 21
    assert isinstance(fodo_cell(device="cpu"), ltt.Segment)
    beam = ltt.ParameterBeam.from_parameters(sigma_x=t(1e-4), energy=t(1e8), device="cpu")
    merged = small.transfer_maps_merged(incoming_beam=beam)
    np.testing.assert_allclose(merged.track(beam).sigma_x.numpy(),
                               small.track(beam).sigma_x.numpy(), rtol=1e-6)


# -- routing (test_routing.py): the tensor's device and the overrides ------------------------


def sweep_workload(B):
    segment = ltt.Segment([ltt.Drift(torch.full((B,), 0.3)),
                           ltt.Quadrupole(torch.full((B,), 0.12), k1=torch.linspace(-5, 5, B)),
                           ltt.Drift(torch.full((B,), 0.5))])
    beam = ltt.ParameterBeam.from_parameters(sigma_x=torch.full((B,), 1.75e-4),
                                             energy=torch.full((B,), 1e8), device="cpu")
    return segment, beam


def spy(routes, module, name):
    calls = []
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    routes.setattr(module, name, wrapper)
    return calls


def test_sweep_routes_follow_the_device_and_the_override(routes):
    """CPU tensors take the dense route by default, even past the sweep's
    threshold; the override forces the fused sweep (its plain version on the
    CPU), through ``Segment.track`` and ``functional.track`` alike, and the
    two agree (test_routing's tolerances)."""
    B = segment_module.PALLAS_SWEEP_THRESHOLD
    segment, beam = sweep_workload(B)
    calls = spy(routes, ft, "_table_reference_sweep")
    default = segment.track(beam)
    default_functional, _ = functional.track(segment, beam)
    assert not calls
    routes.setattr(segment_module, "FUSED_SWEEP_PATH", True)
    forced = segment.track(beam)
    forced_functional, _ = functional.track(segment, beam)
    assert len(calls) == 2
    for a, b in ((forced, default), (forced_functional, default_functional)):
        np.testing.assert_allclose(a._mu.numpy(), b._mu.numpy(), rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(a._cov.numpy(), b._cov.numpy(), rtol=2e-3, atol=1e-14)


def test_particle_routes_follow_the_device_and_the_override(routes):
    """The per-setting push and the particle moment sweep's kernel route:
    neither for CPU tensors by default, both under their overrides, each
    equal to the default route."""
    B = 16
    beam = ltt.ParticleBeam.from_parameters(num_particles=500, sigma_x=t(1.75e-4), energy=t(1e8),
                                            generator=gen(0))
    elements = [ltt.Drift(t(0.3)), ltt.Quadrupole(t(0.12), k1=torch.linspace(-5, 5, B))]
    segment = ltt.Segment(elements)
    push = spy(routes, ft, "particle_apply_reference")
    tiled = beam.broadcast((B,))
    default = segment.track(tiled)
    assert not push
    routes.setattr(segment_module, "PARTICLE_SWEEP_PATH", True)
    np.testing.assert_allclose(segment.track(tiled).particles.numpy(),
                               default.particles.numpy(), rtol=1e-5, atol=1e-9)
    assert len(push) == 1

    entries, scalars = torch_fused.particle_moment_plan(
        elements, beam.energy, lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)))
    particles, weights = beam.particles[0], torch.ones(500)
    walk = spy(routes, ft, "particle_moment_sweep")
    plain = ft.sweep_particle_moments(entries, scalars, particles, weights)
    assert not walk
    routes.setattr(ft, "PARTICLE_MOMENT_SWEEP_PATH", True)
    routes.setattr(ft, "PACKED_MOMENT_SWEEP", False)
    kernel_route = ft.sweep_particle_moments(entries, scalars, particles, weights)
    assert len(walk) == 1
    for a, b in zip(kernel_route, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-9)


# -- re-tuning rebuilds nothing (test_jit.py) ---------------------------------------------


def jit_segment():
    return ltt.Segment([ltt.Drift(length=t(0.5), name="d1"),
                        ltt.Quadrupole(length=t(0.2), k1=t(4.2), name="q1"),
                        ltt.Drift(length=t(0.5), name="d2")], name="seg")


def jit_beam():
    return ltt.ParticleBeam.from_parameters(num_particles=1000, sigma_x=t(1e-4), energy=t(1e8),
                                            generator=gen(0))


def plan_structure(segment, B):
    plan = torch_fused.plan_run([torch_fused.element_map_builder(el) for el in segment.elements],
                                t(1e8), lambda x: torch.broadcast_to(x, (B,)).reshape(B))
    return tuple((kind, meta, len(values)) for kind, meta, values in plan)


def test_retuning_builds_no_new_library_or_tape():
    """Re-tuning a magnet keeps the plan's entries and its tape (one tape a
    plan structure, cached), and no kernel library depends on a value (the
    build is keyed by the sources); a structural change plans anew."""
    B = 8
    segment = jit_segment().broadcast((B,))
    libraries = {name: _build._target(name) for name in chip_smoke.KERNEL_LIBRARIES}
    entries = plan_structure(segment, B)
    tape = ft._tape(entries, "cpu")
    tapes = len(ft._TAPES)
    segment.q1.k1 = torch.linspace(-1.0, 1.0, B)
    assert plan_structure(segment, B) == entries
    assert ft._tape(plan_structure(segment, B), "cpu") is tape and len(ft._TAPES) == tapes
    assert {name: _build._target(name) for name in chip_smoke.KERNEL_LIBRARIES} == libraries
    bigger = ltt.Segment(list(segment.elements) + [ltt.Quadrupole(t(0.1), k1=torch.ones(B))])
    assert plan_structure(bigger, B) != entries


def test_functional_track_diagnostics_outputs():
    segment = ltt.Segment([
        ltt.Drift(length=t(0.5)),
        ltt.BPM(is_active=True, name="bpm1", device="cpu"),
        ltt.Aperture(x_max=t(1e-4), y_max=t(1e-4), name="ap1"),
        ltt.Screen(resolution=(32, 32), pixel_size=t(1e-5, 1e-5), is_active=True, name="scr1"),
    ])
    out, diagnostics = functional.track(segment, jit_beam())
    assert out is None
    assert set(diagnostics) == {"bpm1", "ap1", "scr1"}
    assert diagnostics["scr1"].shape == (1, 32, 32) and diagnostics["ap1"].shape == (1, 1000)
    assert bool(torch.isfinite(diagnostics["bpm1"]).all())


def test_value_and_gradient_compose():
    segment = jit_segment()
    segment.q1.k1 = segment.q1.k1.clone().requires_grad_(True)
    out, _ = functional.track(segment, jit_beam())
    value = torch.sum(out.sigma_x ** 2)
    (grad,) = torch.autograd.grad(value, segment.q1.k1)
    assert np.isfinite(float(value.detach())) and bool(torch.isfinite(grad).all())


# -- readings of an eager track (test_traced_reading_warning.py) --------------------------------


def reading_segment(active=True):
    return ltt.Segment([
        ltt.Drift(length=t(0.3)),
        ltt.BPM(name="B1", is_active=active, device="cpu"),
        ltt.Screen(name="S1", is_active=active, resolution=(64, 48), pixel_size=t(1e-4, 1e-4)),
    ])


def reading_beam():
    return ltt.ParticleBeam.from_parameters(num_particles=200, sigma_x=t(2e-4), sigma_y=t(2e-4),
                                            energy=t(1e8), generator=gen(0))


def test_eager_track_stores_reading_without_warning():
    segment = reading_segment()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        segment.track(reading_beam())
    assert float(segment.S1.reading.sum()) > 0.0
    assert bool(torch.isfinite(segment.B1.reading).all())


def test_functional_track_returns_the_readings():
    _, diagnostics = functional.track(reading_segment(), reading_beam())
    assert float(diagnostics["S1"].sum()) > 0.0
    assert bool(torch.isfinite(diagnostics["B1"]).all())


def test_inactive_elements_do_not_warn():
    beam = reading_beam()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = reading_segment(active=False).track(beam)
    assert out is not ltt.Beam.empty and out.particles.shape == beam.particles.shape
