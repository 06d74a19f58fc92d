"""ParameterBeam against ParticleBeam on the PyTorch port: the contracts of
``tests/test_compare_beam_type.py`` (its parameters, elements and
tolerances, imported from it), on the port's beams, float32, on the CPU."""

import numpy as np
import pytest
import torch

import lynx_tpu_torch as ltt
from tests.test_compare_beam_type import _CAVITY, _FULL_STATS, PARAMS

ASTRA_TOLERANCES = dict(rtol=1e-2, atol=1e-6)  # test_compare_beam_type's moment tolerance


def tensors(values):
    return {key: torch.from_numpy(np.array(value)) for key, value in values.items()}


def both_beams(seed=0):
    parameter = ltt.ParameterBeam.from_parameters(**tensors(PARAMS), device="cpu")
    particle = ltt.ParticleBeam.from_parameters(
        num_particles=300_000, **tensors(PARAMS), generator=torch.Generator().manual_seed(seed))
    return parameter, particle


def assert_consistent(out_param, out_particle, stats=(
        ("mu_x", 1e-2, 1e-6), ("mu_y", 1e-2, 1e-6), ("sigma_x", 1e-2, 1e-6),
        ("sigma_y", 1e-2, 1e-6), ("sigma_s", 1e-2, 1e-6), ("sigma_p", 1e-2, 1e-6))):
    for stat, rtol, atol in stats:
        np.testing.assert_allclose(getattr(out_param, stat).numpy(),
                                   getattr(out_particle, stat).numpy(),
                                   rtol=rtol, atol=atol, err_msg=stat)
    np.testing.assert_allclose(out_param.energy.numpy(), out_particle.energy.numpy())


def test_beams_consistent_at_creation():
    assert_consistent(*both_beams())


def t(*values):
    return torch.tensor(values)


ELEMENTS = {
    "drift": lambda: ltt.Drift(length=t(1.3)),
    "quadrupole": lambda: ltt.Quadrupole(length=t(0.23), k1=t(4.2)),
    "dipole": lambda: ltt.Dipole(length=t(0.31), angle=t(0.12)),
    "solenoid": lambda: ltt.Solenoid(length=t(0.4), k=t(1.1)),
    "cavity": lambda: ltt.Cavity(**tensors(_CAVITY)),
}


@pytest.mark.parametrize("element", list(ELEMENTS))
def test_beams_consistent_through_element(element):
    parameter, particle = both_beams()
    segment = ELEMENTS[element]()
    assert_consistent(segment.track(parameter), segment.track(particle))


def test_beams_consistent_through_segment():
    segment = ltt.Segment([
        ltt.Drift(length=t(0.5)),
        ltt.Quadrupole(length=t(0.23), k1=t(4.2)),
        ltt.Drift(length=t(0.5)),
        ltt.HorizontalCorrector(length=t(0.1), angle=t(1e-4)),
        ltt.Drift(length=t(0.5)),
    ])
    parameter, particle = both_beams()
    assert_consistent(segment.track(parameter), segment.track(particle))


def test_from_twiss_consistent():
    kwargs = dict(beta_x=t(5.91), alpha_x=t(3.55), emittance_x=t(3.494e-09), beta_y=t(5.91),
                  alpha_y=t(3.55), emittance_y=t(3.497e-09), energy=t(6e6))
    parameter = ltt.ParameterBeam.from_twiss(**kwargs, device="cpu")
    particle = ltt.ParticleBeam.from_twiss(num_particles=300_000, **kwargs,
                                           generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(parameter.beta_x[0]), float(particle.beta_x[0]), rtol=2e-2)
    np.testing.assert_allclose(float(parameter.alpha_x[0]), float(particle.alpha_x[0]), rtol=2e-2)
    np.testing.assert_allclose(float(parameter.beta_x[0]), 5.91, rtol=1e-5)
    np.testing.assert_allclose(float(parameter.alpha_x[0]), 3.55, rtol=1e-5)


def assert_full_consistency(out_param, out_particle):
    assert_consistent(out_param, out_particle, _FULL_STATS)


def test_cavity_from_astra(astra_beam_path):
    """Both beam types from the repository's ASTRA file agree after the
    cavity, at the Twiss and emittance level."""
    cavity = ltt.Cavity(**tensors(_CAVITY))
    out_param = cavity.track(ltt.ParameterBeam.from_astra(astra_beam_path, device="cpu"))
    out_particle = cavity.track(ltt.ParticleBeam.from_astra(astra_beam_path, device="cpu"))
    assert_full_consistency(out_param, out_particle)


def test_cavity_from_twiss():
    kwargs = dict(beta_x=t(5.91253677), alpha_x=t(3.55631308), beta_y=t(5.91253677),
                  alpha_y=t(3.55631308), emittance_x=t(3.494768647122823e-09),
                  emittance_y=t(3.497810737006068e-09), energy=t(6e6))
    cavity = ltt.Cavity(**tensors(_CAVITY))
    out_param = cavity.track(ltt.ParameterBeam.from_twiss(**kwargs, device="cpu"))
    out_particle = cavity.track(ltt.ParticleBeam.from_twiss(
        num_particles=1_000_000, **kwargs, generator=torch.Generator().manual_seed(42)))
    assert_full_consistency(out_param, out_particle)
