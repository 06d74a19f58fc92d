"""The PyTorch port held to the repo's authorities that do not depend on the
JAX code, at the JAX suite's parameters and tolerances, on the CPU:

* the generator-exponential oracle (``tests/oracles/generator_oracle.py``:
  matrix exponentials of the equations of motion's generators, scipy,
  float64), through tracked particle clouds, as
  ``tests/test_oracle_tracking.py`` holds the JAX package;
* the closed-form map entries of ``tests/test_physics_oracles.py``;
* the symplectic form and the cavity's two implementations
  (``tests/test_symplecticity.py``);
* the pinned ``tests/resources/golden_tracking.npz``
  (``tests/test_golden_tracking.py``);
* the Bmad/Tao cavity golden point and the cavity's physics invariants
  (``tests/test_cavity.py``), and the Monte-Carlo adjudication of the
  cavity's ParameterBeam covariance
  (``tests/test_cavity_covariance_adjudication.py``).

Constants and beams are imported from those modules where they are plain
data; the elements and beams are the port's, built from the same numbers.
Sampled beams come from a seeded ``torch.Generator`` where the JAX tests
take a ``jax.random`` key: the statistics the tests hold are those of the
distribution, not of one draw.
"""

import math

import numpy as np
import pytest
import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch.constants import ELECTRON_MASS_EV
from lynx_tpu_torch.models import ares_ea_segment
from oracles import generator_oracle as go
from tests.test_cavity import BMAD_OUT, TWISS_IN
from tests.test_cavity_covariance_adjudication import _reference_style_longitudinal
from tests.test_golden_tracking import GOLDEN
from tests.test_symplecticity import ENERGIES, J_FORM

F64 = torch.float64
ENERGY = 1.073e8  # eV, test_oracle_tracking's working point
N = 4096  # test_oracle_tracking's cloud


def t(*values, dtype=F64):
    """A CPU tensor of ``values`` (float64 unless ``dtype`` says otherwise)."""
    return torch.tensor(values, dtype=dtype)


# -- the generator-exponential oracle (test_oracle_tracking.py) ---------------


def particle_beam(P):
    return ltt.ParticleBeam(
        particles=torch.from_numpy(np.asarray(P, np.float64)),
        energy=t(ENERGY),
        particle_charges=torch.full((1, P.shape[-2]), 1e-15, dtype=F64),
    )


def track_ours(element, P):
    return element.track(particle_beam(P[None])).particles[0].numpy()


def assert_clouds_match(ours, oracle, atol=1e-12):
    np.testing.assert_allclose(ours, oracle, rtol=1e-9, atol=atol)


@pytest.fixture(scope="module")
def cloud():
    return go.sample_cloud(N, seed=42)


# name -> (the port's element, the oracle's maps), test_oracle_tracking's
# parameters case by case.
ORACLE_CASES = {
    "dipole f64": lambda: (
        ltt.Dipole(length=t(0.6), angle=t(0.2), dtype=F64),
        [go.dipole_map(0.6, 0.2, ENERGY)]),
    "dipole with fringe": lambda: (
        ltt.Dipole(length=t(0.6), angle=t(0.2), fringe_integral=t(0.5), gap=t(0.03), dtype=F64),
        [go.dipole_map(0.6, 0.2, ENERGY, fringe_integral=0.5, gap=0.03)]),
    "dipole fringe, tilt, asymmetric edges": lambda: (
        ltt.Dipole(length=t(0.6), angle=t(0.2), e1=t(0.07), e2=t(-0.03), tilt=t(0.3),
                   fringe_integral=t(0.5), fringe_integral_exit=t(0.2), gap=t(0.03), dtype=F64),
        [go.dipole_map(0.6, 0.2, ENERGY, e1=0.07, e2=-0.03, tilt=0.3, fringe_integral=0.5,
                       fringe_integral_exit=0.2, gap=0.03)]),
    # RBend == sector bend with e1/e2 += angle / 2, once.
    "rbend": lambda: (
        ltt.RBend(length=t(0.6), angle=t(0.2), e1=t(0.01), e2=t(0.02), dtype=F64),
        [go.rbend_map(0.6, 0.2, ENERGY, e1=0.01, e2=0.02)]),
    "zero-length dipole thin kick": lambda: (
        ltt.Dipole(length=t(0.0), angle=t(3e-3), dtype=F64),
        [go.dipole_map(0.0, 3e-3, ENERGY)]),
    "tilted quadrupole": lambda: (
        ltt.Quadrupole(length=t(0.23), k1=t(5.0), tilt=t(0.79), dtype=F64),
        [go.quadrupole_map(0.23, 5.0, ENERGY, tilt=0.79)]),
    "misaligned quadrupole": lambda: (
        ltt.Quadrupole(length=t(0.23), k1=t(-4.0), misalignment=torch.tensor([[3e-4, -2e-4]],
                                                                               dtype=F64),
                       dtype=F64),
        [go.quadrupole_map(0.23, -4.0, ENERGY, misalignment=(3e-4, -2e-4))]),
    "solenoid": lambda: (
        ltt.Solenoid(length=t(0.7), k=t(3.0), dtype=F64),
        [go.solenoid_map(0.7, 3.0, ENERGY)]),
    "misaligned solenoid": lambda: (
        ltt.Solenoid(length=t(0.7), k=t(3.0), misalignment=torch.tensor([[1e-4, 2e-4]], dtype=F64),
                     dtype=F64),
        [go.solenoid_map(0.7, 3.0, ENERGY, misalignment=(1e-4, 2e-4))]),
    "correctors": lambda: (
        ltt.Segment([ltt.HorizontalCorrector(length=t(0.12), angle=t(2e-3), dtype=F64),
                     ltt.VerticalCorrector(length=t(0.12), angle=t(-1e-3), dtype=F64)]),
        [go.corrector_map(0.12, 2e-3, ENERGY, horizontal=True),
         go.corrector_map(0.12, -1e-3, ENERGY, horizontal=False)]),
    "undulator": lambda: (
        ltt.Undulator(length=t(0.9), dtype=F64),
        [go.undulator_map(0.9, ENERGY)]),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_tracked_cloud_matches_the_generator_oracle(cloud, case):
    element, maps = ORACLE_CASES[case]()
    assert_clouds_match(track_ours(element, cloud), go.track_cloud(maps, cloud))


def aperture(shape, x_max=1e-3, y_max=7e-4):
    return ltt.Aperture(x_max=t(x_max), y_max=t(y_max), shape=shape, is_active=True, dtype=F64)


@pytest.mark.parametrize("shape", ["rectangular", "elliptical"])
def test_aperture_survivor_counts(cloud, shape):
    out = aperture(shape).track(particle_beam(cloud[None]))
    expected_mask = go.aperture_survivors(cloud, 1e-3, 7e-4, shape)
    assert int(out.num_particles_survived[0]) == int(expected_mask.sum())
    # Weighted moments equal the moments of the independent cull.
    survivors = cloud[expected_mask]
    np.testing.assert_allclose(float(out.mu_x[0]), survivors[:, 0].mean(), rtol=1e-9)
    np.testing.assert_allclose(float(out.sigma_x[0]), survivors[:, 0].std(ddof=1), rtol=1e-9)


def test_aperture_then_tracking_moments(cloud):
    segment = ltt.Segment([aperture("rectangular"), ltt.Drift(length=t(2.0), dtype=F64)])
    out = segment.track(particle_beam(cloud[None]))
    mask = go.aperture_survivors(cloud, 1e-3, 7e-4, "rectangular")
    oracle = go.track_cloud([go.drift_map(2.0, ENERGY)], cloud[mask])
    np.testing.assert_allclose(float(out.mu_x[0]), oracle[:, 0].mean(), rtol=1e-9)
    np.testing.assert_allclose(float(out.sigma_x[0]), oracle[:, 0].std(ddof=1), rtol=1e-9)


def oracle_map_for(element):
    """The oracle's map of one of the EA subcell's elements, from its
    parameters (test_oracle_tracking's ``_oracle_map_for``)."""

    def val(x):
        return float(x.reshape(-1)[0])

    name = type(element).__name__
    if name == "Drift":
        return go.drift_map(val(element.length), ENERGY)
    if name == "Quadrupole":
        return go.quadrupole_map(val(element.length), val(element.k1), ENERGY,
                                 tilt=val(element.tilt),
                                 misalignment=tuple(element.misalignment.reshape(-1)[:2].tolist()))
    if name in ("HorizontalCorrector", "VerticalCorrector"):
        return go.corrector_map(val(element.length), val(element.angle), ENERGY,
                                horizontal=name == "HorizontalCorrector")
    if name in ("Marker", "BPM", "Screen"):
        return np.eye(7)
    if name == "Undulator":
        return go.undulator_map(val(element.length), ENERGY)
    raise NotImplementedError(name)


def test_ares_ea_end_to_end(cloud):
    """The EA subcell with tuned magnets against the oracle's composed maps."""
    segment = ares_ea_segment(dtype=F64, device="cpu")
    segment.AREABSCR1.is_active = False
    segment.AREAMQZM1.k1 = t(4.5)
    segment.AREAMQZM2.k1 = t(-7.0)
    segment.AREAMQZM3.k1 = t(2.2)
    segment.AREAMCVM1.angle = t(1.2e-3)
    segment.AREAMCHM1.angle = t(-0.8e-3)
    out = segment.track(particle_beam(cloud[None]))
    oracle = go.track_cloud([oracle_map_for(el) for el in segment.flattened().elements], cloud)
    assert_clouds_match(out.particles[0].numpy(), oracle, atol=1e-11)


def test_parameter_beam_moments_vs_oracle():
    """mu' = R mu and Sigma' = R Sigma R^T through a dipole-drift-quad chain,
    R from the oracle's maps."""
    beam = ltt.ParameterBeam.from_parameters(
        mu_x=t(1e-4), mu_xp=t(-2e-5), sigma_x=t(2e-4), sigma_y=t(1.5e-4), sigma_p=t(2e-3),
        energy=t(ENERGY), dtype=F64, device="cpu")
    segment = ltt.Segment([
        ltt.Dipole(length=t(0.4), angle=t(0.15), dtype=F64),
        ltt.Drift(length=t(0.5), dtype=F64),
        ltt.Quadrupole(length=t(0.23), k1=t(5.0), dtype=F64),
    ])
    out = segment.track(beam)
    R = np.eye(7)
    for m in (go.dipole_map(0.4, 0.15, ENERGY), go.drift_map(0.5, ENERGY),
              go.quadrupole_map(0.23, 5.0, ENERGY)):
        R = m @ R
    mu, cov = beam._mu[0].numpy(), beam._cov[0].numpy()
    np.testing.assert_allclose(out._mu[0].numpy(), R @ mu, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(out._cov[0].numpy(), R @ cov @ R.T, rtol=1e-8, atol=1e-16)


# -- closed-form map entries (test_physics_oracles.py) ------------------------


def test_dipole_edge_map_formula():
    """R21 = hx tan(e); R43 = -hx tan(e - psi), psi = fint hx gap sec(e)
    (1 + sin^2 e)."""
    length, angle, e1, fint, gap = 0.31, 0.12, 0.07, 0.45, 0.05
    dipole = ltt.Dipole(length=t(length), angle=t(angle), e1=t(e1), fringe_integral=t(fint),
                        gap=t(gap), dtype=F64)
    hx = angle / length
    psi = fint * hx * gap / math.cos(e1) * (1 + math.sin(e1) ** 2)
    R_enter = dipole._edge_map(dipole.e1, dipole.fringe_integral)
    np.testing.assert_allclose(float(R_enter[0, 1, 0]), hx * math.tan(e1), rtol=1e-12)
    np.testing.assert_allclose(float(R_enter[0, 3, 2]), -hx * math.tan(e1 - psi), rtol=1e-12)


def test_solenoid_map_formula():
    """Chao's solenoid block entries; the transverse block's determinant is 1."""
    length, k, energy = 0.4, 1.7, 1.3e8
    R = ltt.Solenoid(length=t(length), k=t(k), dtype=F64).transfer_map(t(energy))
    c, s = math.cos(length * k), math.sin(length * k)
    np.testing.assert_allclose(float(R[0, 0, 0]), c * c, rtol=1e-12)
    np.testing.assert_allclose(float(R[0, 0, 1]), c * s / k, rtol=1e-12)
    np.testing.assert_allclose(float(R[0, 1, 2]), -k * s * s, rtol=1e-12)
    np.testing.assert_allclose(float(R[0, 3, 0]), k * s * s, rtol=1e-12)
    np.testing.assert_allclose(np.linalg.det(R[0, :4, :4].numpy()), 1.0, rtol=1e-10)


@pytest.mark.parametrize("k1", (-8.0, -0.5, 0.0, 0.5, 8.0))
def test_quadrupole_map_is_symplectic(k1):
    quad = ltt.Quadrupole(length=t(0.23), k1=t(k1), tilt=t(0.3), dtype=F64)
    R = quad.transfer_map(t(1e8))
    np.testing.assert_allclose(np.linalg.det(R[0, :4, :4].numpy()), 1.0, rtol=1e-10)


def test_sector_bend_closes_on_itself():
    """64 slices of a 2 pi sector bend return x-x' to the identity."""
    n_slices = 64
    bend = ltt.Dipole(length=t(0.5), angle=t(2 * math.pi / n_slices), dtype=F64)
    R = bend.transfer_map(t(1e9))[0].numpy()
    total = np.eye(7)
    for _ in range(n_slices):
        total = R @ total
    np.testing.assert_allclose(total[:2, :2], np.eye(2), atol=1e-6)


def test_drift_composition_associativity():
    energy = t(1e8)
    R_full = ltt.Drift(t(1.0), dtype=F64).transfer_map(energy)[0].numpy()
    R_half = ltt.Drift(t(0.5), dtype=F64).transfer_map(energy)[0].numpy()
    np.testing.assert_allclose(R_half @ R_half, R_full, rtol=1e-14)


def test_f32_tracking_matches_f64_ares_ea():
    """Float32 tracking through the EA subcell stays within float32
    conditioning of the float64 result."""
    outs = {}
    for dtype in (torch.float32, torch.float64):
        segment = ares_ea_segment(dtype=dtype, device="cpu")
        segment.AREABSCR1.is_active = False
        segment.AREAMQZM1.k1 = t(4.2, dtype=dtype)
        segment.AREAMQZM2.k1 = t(-4.2, dtype=dtype)
        beam = ltt.ParameterBeam.from_parameters(
            sigma_x=t(1.75e-4, dtype=dtype), sigma_y=t(1.75e-4, dtype=dtype),
            sigma_p=t(2e-3, dtype=dtype), energy=t(1.073e8, dtype=dtype), dtype=dtype,
            device="cpu")
        outs[dtype], _ = ltt.functional.track(segment, beam)
    for stat in ("mu_x", "mu_y", "sigma_x", "sigma_y", "sigma_s", "sigma_p"):
        np.testing.assert_allclose(getattr(outs[torch.float32], stat).double().numpy(),
                                   getattr(outs[torch.float64], stat).numpy(), rtol=2e-4,
                                   err_msg=stat)


# -- the symplectic form and the cavity's two paths (test_symplecticity.py) ----


def symplectic_defect(element, energy_ev):
    """Max-entry defect of R^T J R - J, scaled by ||R||^2 (the roundoff
    floor of the triple product)."""
    R = element.transfer_map(t(energy_ev))[0].numpy()[:6, :6]
    scale = max(1.0, float(np.abs(R).max()) ** 2)
    return float(np.abs(R.T @ J_FORM @ R - J_FORM).max()) / scale


def random_static_elements(rng):
    """test_symplecticity's draw of every static element, from the same
    ``RandomState`` sequence."""

    def a(low, high):
        return t(rng.uniform(low, high))

    return [
        ltt.Drift(a(0.01, 5.0), dtype=F64),
        ltt.Quadrupole(a(0.05, 1.0), k1=a(-30.0, 30.0), tilt=a(-np.pi, np.pi), dtype=F64),
        ltt.Quadrupole(a(0.05, 1.0), k1=a(-30.0, 30.0),
                       misalignment=torch.from_numpy(rng.uniform(-1e-3, 1e-3, size=(1, 2))),
                       dtype=F64),
        ltt.Dipole(length=a(0.05, 2.0), angle=a(-0.6, 0.6), dtype=F64),
        ltt.Dipole(length=a(0.05, 2.0), angle=a(-0.6, 0.6), e1=a(-0.2, 0.2), e2=a(-0.2, 0.2),
                   fringe_integral=a(0.0, 0.8), gap=a(0.0, 0.05), tilt=a(-np.pi, np.pi),
                   dtype=F64),
        ltt.RBend(length=a(0.05, 2.0), angle=a(-0.6, 0.6), dtype=F64),
        ltt.Solenoid(length=a(0.05, 2.0), k=a(-10.0, 10.0), dtype=F64),
        ltt.Undulator(a(0.05, 2.0), dtype=F64),
        ltt.HorizontalCorrector(a(0.0, 0.3), angle=a(-2e-3, 2e-3), dtype=F64),
        ltt.VerticalCorrector(a(0.0, 0.3), angle=a(-2e-3, 2e-3), dtype=F64),
    ]


@pytest.mark.parametrize("energy_ev", ENERGIES)
def test_static_elements_symplectic_fuzz(energy_ev):
    rng = np.random.RandomState(int(energy_ev % 97) + 7)
    for _ in range(8):
        for element in random_static_elements(rng):
            defect = symplectic_defect(element, energy_ev)
            assert defect < 1e-13, (type(element).__name__, defect, energy_ev)


def test_segment_product_symplectic():
    cell = ltt.Segment([
        ltt.Drift(t(0.4), dtype=F64),
        ltt.Quadrupole(t(0.2), k1=t(8.3), tilt=t(0.11), dtype=F64),
        ltt.Drift(t(0.3), dtype=F64),
        ltt.Dipole(length=t(0.6), angle=t(0.21), e1=t(0.05), fringe_integral=t(0.45), gap=t(0.02),
                   dtype=F64),
        ltt.Drift(t(0.3), dtype=F64),
        ltt.Quadrupole(t(0.2), k1=t(-7.9), dtype=F64),
        ltt.Solenoid(length=t(0.25), k=t(2.2), dtype=F64),
    ])
    assert symplectic_defect(cell, 1.5e8) < 1e-12


@pytest.mark.parametrize("energy_ev, voltage, phase_deg", [
    (6e6, 18.15975e6, 0.0), (6e6, 18.15975e6, 30.0), (2e7, 5e6, -45.0), (1e8, 3e7, 10.0)])
def test_cavity_particle_jacobian_matches_rmatrix(energy_ev, voltage, phase_deg):
    """The Jacobian of the per-particle cavity update at the reference orbit
    (autograd) is the cavity's map: rows 0-4 and r66 exactly, r65 up to
    beta_0^2."""
    cavity = ltt.Cavity(length=t(1.0377), voltage=t(voltage), phase=t(phase_deg),
                        frequency=t(1.3e9), dtype=F64)
    energy = t(energy_ev)

    def particle_map(x6):
        p = torch.cat([x6, torch.ones(1, dtype=F64)])[None, None, :]
        beam = ltt.ParticleBeam(particles=p, energy=energy,
                                particle_charges=torch.ones((1, 1), dtype=F64))
        return cavity.track(beam).particles[0, 0, :6]

    jac = torch.autograd.functional.jacobian(particle_map, torch.zeros(6, dtype=F64)).numpy()
    R = cavity.transfer_map(energy)[0].numpy()[:6, :6]
    np.testing.assert_allclose(jac[:5], R[:5], rtol=0, atol=1e-12)
    np.testing.assert_allclose(jac[5, 5], R[5, 5], rtol=1e-12)
    np.testing.assert_allclose(jac[5, :4], R[5, :4], rtol=0, atol=1e-12)
    beta0_sq = 1.0 - 1.0 / (energy_ev / ELECTRON_MASS_EV) ** 2
    if phase_deg == 0.0:
        np.testing.assert_allclose(jac[5, 4], 0.0, atol=1e-12)
        np.testing.assert_allclose(R[5, 4], 0.0, atol=1e-12)
    else:
        np.testing.assert_allclose(jac[5, 4], beta0_sq * R[5, 4], rtol=1e-12)


def test_inactive_cavity_jacobian_is_symplectic_drift():
    cavity = ltt.Cavity(length=t(1.0377), voltage=t(0.0), phase=t(30.0), frequency=t(1.3e9),
                        dtype=F64)
    assert symplectic_defect(cavity, 6e6) < 1e-12


# -- the pinned golden file (test_golden_tracking.py) --------------------------


def golden_beam():
    return ltt.ParticleBeam.make_linspaced(
        num_particles=32, mu_x=t(1e-4), mu_xp=t(-2e-5), mu_y=t(-5e-5), mu_yp=t(1e-5),
        sigma_x=t(2e-4), sigma_xp=t(3e-5), sigma_y=t(1.5e-4), sigma_yp=t(2.5e-5),
        sigma_s=t(1e-5), sigma_p=t(2e-3), energy=t(1.2e8), dtype=F64, device="cpu")


GOLDEN_SEGMENTS = {
    "dqd": lambda: [
        ltt.Drift(t(0.5), dtype=F64),
        ltt.Quadrupole(t(0.23), k1=t(4.2), tilt=t(0.1), dtype=F64),
        ltt.Drift(t(0.5), dtype=F64),
    ],
    "bend_line": lambda: [
        ltt.Dipole(t(0.31), angle=t(0.12), e1=t(0.05), e2=t(0.03), fringe_integral=t(0.4),
                   gap=t(0.05), tilt=t(0.2), dtype=F64),
        ltt.Drift(t(0.4), dtype=F64),
        ltt.RBend(t(0.25), angle=t(-0.08), dtype=F64),
    ],
    "sol_und_corr": lambda: [
        ltt.Solenoid(t(0.4), k=t(1.3), misalignment=torch.tensor([[1e-4, -2e-4]], dtype=F64),
                     dtype=F64),
        ltt.Undulator(t(0.35), dtype=F64),
        ltt.HorizontalCorrector(t(0.1), angle=t(3e-4), dtype=F64),
        ltt.VerticalCorrector(t(0.1), angle=t(-2e-4), dtype=F64),
    ],
    "cavity_line": lambda: [
        ltt.Drift(t(0.2), dtype=F64),
        ltt.Cavity(t(1.0377), voltage=t(1.815975e7), phase=t(-12.0), frequency=t(1.3e9),
                   dtype=F64),
        ltt.Drift(t(0.2), dtype=F64),
    ],
}


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_incoming_beam_is_reproduced(golden):
    np.testing.assert_allclose(golden_beam().particles.numpy(), golden["incoming_particles"],
                               rtol=1e-14, atol=0)


@pytest.mark.parametrize("name", list(GOLDEN_SEGMENTS))
def test_tracking_matches_golden(golden, name):
    tracked = ltt.Segment(GOLDEN_SEGMENTS[name]()).track(golden_beam())
    np.testing.assert_allclose(tracked.particles.numpy(), golden[f"{name}_particles"],
                               rtol=1e-12, atol=1e-18)
    np.testing.assert_allclose(tracked.energy.numpy(), golden[f"{name}_energy"], rtol=1e-14)


# -- the Bmad/Tao cavity golden point and invariants (test_cavity.py) ----------


def golden_cavity(dtype=F64):
    return ltt.Cavity(length=t(1.0377, dtype=dtype), voltage=t(0.01815975e9, dtype=dtype),
                      frequency=t(1.3e9, dtype=dtype), phase=t(0.0, dtype=dtype), dtype=dtype)


def twiss_in():
    return {key: t(value) for key, value in TWISS_IN.items()}


def test_cavity_bmad_golden_twiss_parameter_beam():
    beam = ltt.ParameterBeam.from_twiss(**twiss_in(), energy=t(6e6), dtype=F64, device="cpu")
    outgoing = golden_cavity().track(beam)
    for key in ("beta_x", "alpha_x", "beta_y", "alpha_y"):
        assert np.isclose(float(getattr(outgoing, key)[0]), BMAD_OUT[key], rtol=1e-6), key
    assert np.isclose(float(outgoing.energy[0]), 6e6 + 0.01815975e9)


def test_cavity_bmad_golden_twiss_particle_beam():
    beam = ltt.ParticleBeam.from_twiss(num_particles=200_000, **twiss_in(), energy=t(6e6),
                                       generator=torch.Generator().manual_seed(0), dtype=F64)
    outgoing = golden_cavity().track(beam)
    # Sample moments: statistical tolerance.
    assert np.isclose(float(outgoing.beta_x[0]), BMAD_OUT["beta_x"], rtol=2e-2)
    assert np.isclose(float(outgoing.alpha_x[0]), BMAD_OUT["alpha_x"], rtol=2e-2)


def test_cavity_inactive_equals_drift_transverse():
    cavity = ltt.Cavity(length=t(1.0377, dtype=torch.float32), name="c")
    drift = ltt.Drift(length=t(1.0377, dtype=torch.float32))
    beam = ltt.ParameterBeam.from_parameters(energy=t(6e6, dtype=torch.float32), device="cpu")
    out_c, out_d = cavity.track(beam), drift.track(beam)
    np.testing.assert_allclose(out_c._mu.numpy(), out_d._mu.numpy(), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(out_c._cov.numpy(), out_d._cov.numpy(), rtol=1e-5, atol=1e-20)


def test_cavity_zero_crossing_phase_no_nan():
    """phi = 90 deg (pure chirp) stays finite, and the chirp term r65 is
    non-zero there."""
    f32 = torch.float32
    cavity = ltt.Cavity(length=t(1.0, dtype=f32), voltage=t(2e7, dtype=f32),
                        phase=t(90.0, dtype=f32), frequency=t(1.3e9, dtype=f32))
    beam = ltt.ParameterBeam.from_parameters(energy=t(1e8, dtype=f32), device="cpu")
    outgoing = cavity.track(beam)
    assert bool(torch.isfinite(outgoing._mu).all()) and bool(torch.isfinite(outgoing._cov).all())
    assert abs(float(cavity.transfer_map(beam.energy)[0, 5, 4])) > 0


def test_cavity_energy_update_propagates_downstream():
    f32 = torch.float32
    segment = ltt.Segment([
        ltt.Cavity(length=t(1.0377, dtype=f32), voltage=t(0.01815975e9, dtype=f32),
                   frequency=t(1.3e9, dtype=f32), phase=t(0.0, dtype=f32), name="c1"),
        ltt.Drift(length=t(1.0, dtype=f32), name="d1"),
    ])
    outgoing = segment.track(ltt.ParameterBeam.from_parameters(energy=t(6e6, dtype=f32),
                                                               device="cpu"))
    assert np.isclose(float(outgoing.energy[0]), 6e6 + 0.01815975e9)


def test_cavity_non_zero_phase_energy_gain_and_beam_type_consistency():
    """The reference energy gains V cos(phi) exactly, both beam types agree
    on the transverse moments, and off crest gains less than on crest."""
    f32 = torch.float32
    phase_deg, voltage = 30.0, 18159750.0

    def cavity(phase):
        return ltt.Cavity(length=t(1.0377, dtype=f32), voltage=t(voltage, dtype=f32),
                          phase=t(phase, dtype=f32), frequency=t(1.3e9, dtype=f32))

    params = dict(sigma_x=t(1.75e-4, dtype=f32), sigma_y=t(1.75e-4, dtype=f32),
                  sigma_s=t(8e-6, dtype=f32), sigma_p=t(2e-3, dtype=f32),
                  energy=t(6e6, dtype=f32))
    parameter = ltt.ParameterBeam.from_parameters(**params, device="cpu")
    particle = ltt.ParticleBeam.from_parameters(num_particles=200_000,
                                                generator=torch.Generator().manual_seed(11),
                                                **params)
    out_param, out_particle = cavity(phase_deg).track(parameter), cavity(phase_deg).track(particle)
    expected_energy = 6e6 + voltage * np.cos(np.deg2rad(phase_deg))
    np.testing.assert_allclose(float(out_param.energy[0]), expected_energy, rtol=1e-6)
    np.testing.assert_allclose(float(out_particle.energy[0]), expected_energy, rtol=1e-6)
    for stat in ("mu_x", "sigma_x", "mu_y", "sigma_y", "sigma_p"):
        np.testing.assert_allclose(getattr(out_param, stat).numpy(),
                                   getattr(out_particle, stat).numpy(), rtol=1e-2, atol=1e-6,
                                   err_msg=stat)
    assert float(cavity(0.0).track(parameter).energy[0]) > float(out_param.energy[0])


# -- the cavity's ParameterBeam covariance against Monte Carlo -------------------
# (test_cavity_covariance_adjudication.py: the Bmad-golden working point, a
# 4x energy gain from 6 MeV, judged by a 400,000-particle cloud tracked
# through the per-particle update.)


ADJUDICATION_ENERGY = 6e6


def adjudication_cavity(phase_deg):
    return ltt.Cavity(length=t(1.0377), voltage=t(18.15975e6), frequency=t(1.3e9),
                      phase=t(phase_deg), dtype=F64)


def adjudication_beams(n=400_000):
    common = dict(sigma_x=t(2e-4), sigma_xp=t(1e-5), sigma_y=t(2e-4), sigma_yp=t(1e-5),
                  sigma_s=t(1e-6), sigma_p=t(1e-3), energy=t(ADJUDICATION_ENERGY), dtype=F64)
    param = ltt.ParameterBeam.from_parameters(**common, device="cpu")
    particle = ltt.ParticleBeam.from_parameters(
        num_particles=n, generator=torch.Generator().manual_seed(0), **common)
    return param, particle


def sample_cov(beam):
    return np.cov(beam.particles[0, :, :6].numpy().T, ddof=1)


@pytest.mark.parametrize("phase_deg", [0.0, 30.0])
def test_linear_covariance_matches_monte_carlo(phase_deg):
    cavity = adjudication_cavity(phase_deg)
    param_in, particle_in = adjudication_beams()
    ours = cavity.track(param_in)._cov[0].numpy()[:6, :6]
    mc = sample_cov(cavity.track(particle_in))
    for i in range(6):
        np.testing.assert_allclose(ours[i, i], mc[i, i], rtol=2e-2)
    np.testing.assert_allclose(ours[4, 5], mc[4, 5], rtol=5e-2, atol=1e-12)


@pytest.mark.parametrize("phase_deg", [0.0, 30.0])
def test_reference_overwrite_contradicts_monte_carlo(phase_deg):
    """The reference's kept incoming cov[5, 5] misses the adiabatic damping,
    and its cov[4, 4] expression is orders of magnitude off."""
    cavity = adjudication_cavity(phase_deg)
    param_in, particle_in = adjudication_beams()
    mc = sample_cov(cavity.track(particle_in))
    ref44, _, ref55 = _reference_style_longitudinal(param_in, cavity, phase_deg)
    assert ref55 > 5.0 * mc[5, 5]
    assert ref44 < 0.1 * mc[4, 4] or ref44 > 10.0 * mc[4, 4]


def test_energy_gain_and_mean_match_reference_model():
    param_in, _ = adjudication_beams(n=1000)
    out = adjudication_cavity(0.0).track(param_in)
    np.testing.assert_allclose(float(out.energy[0]), ADJUDICATION_ENERGY + 18.15975e6, rtol=1e-12)
