"""Debug utilities of the port: ``tests/test_debug.py``'s cases, and
``nan_debug`` raising inside ``functional.track``."""

import pytest
import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch import functional
from lynx_tpu_torch.debug import nan_debug, validate_beam
from lynx_tpu_torch.models import ares_ea_segment


def test_validate_beam_passes_on_healthy_beams():
    validate_beam(ltt.ParameterBeam.from_parameters(sigma_x=torch.tensor([1e-4]), device="cpu"))
    validate_beam(
        ltt.ParticleBeam.from_parameters(num_particles=100, sigma_x=torch.tensor([1e-4]),
                                         device="cpu")
    )
    validate_beam(ltt.Beam.empty)


def test_validate_beam_catches_nan():
    beam = ltt.ParameterBeam.from_parameters(sigma_x=torch.tensor([1e-4]), device="cpu")
    beam._mu = beam._mu.clone()
    beam._mu[..., 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite mu"):
        validate_beam(beam)


def test_validate_beam_catches_bad_survival():
    beam = ltt.ParticleBeam.from_parameters(
        num_particles=10, sigma_x=torch.tensor([1e-4]), device="cpu"
    )
    beam.survival = torch.full((1, 10), 2.0)
    with pytest.raises(ValueError, match="survival"):
        validate_beam(beam)


def test_validate_beam_names_every_problem():
    beam = ltt.ParameterBeam.from_parameters(sigma_x=torch.tensor([1e-4]), device="cpu")
    beam.energy = torch.tensor([-1.0])
    beam._cov = -beam._cov
    with pytest.raises(ValueError, match="Invalid incoming: negative energy; negative covariance"):
        validate_beam(beam, name="incoming")


def test_nan_debug_context_restores_anomaly_mode():
    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    with nan_debug():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        torch.ones(3) * 2  # finite work passes
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == before
    with pytest.raises(FloatingPointError):
        with nan_debug():
            torch.zeros(1) / 0.0
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == before


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_nan_debug_raises_inside_functional_track(monkeypatch, route):
    """A NaN strength in one setting of a batched sweep raises at the op
    that produces it, on the dense route and on the fused sweep's."""
    from lynx_tpu_torch.accelerator import segment as segment_module

    if route == "fused":
        monkeypatch.setattr(segment_module, "FUSED_SWEEP_PATH", True)
        monkeypatch.setattr(segment_module, "PALLAS_SWEEP_THRESHOLD", 4)
    segment = ares_ea_segment(device="cpu")
    segment.AREABSCR1.is_active = False
    k1 = torch.linspace(-5.0, 5.0, 8)
    segment.AREAMQZM1.length = segment.AREAMQZM1.length.expand(8).clone()
    beam = ltt.ParameterBeam.from_parameters(sigma_x=torch.tensor([1e-4]), device="cpu")
    segment.AREAMQZM1.k1 = k1
    with nan_debug():
        outgoing, _ = functional.track(segment, beam)  # finite: no raise
    assert outgoing.sigma_x.shape == (8,)
    k1[3] = float("nan")
    segment.AREAMQZM1.k1 = k1
    with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
        with nan_debug():
            functional.track(segment, beam)
    outgoing, _ = functional.track(segment, beam)  # outside the block: NaN passes
    assert bool(torch.isnan(outgoing.sigma_x[3])) and bool(torch.isfinite(outgoing.sigma_x[0]))


def test_nan_debug_catches_a_nan_gradient():
    """A finite forward whose backward makes a NaN: d sqrt(x^2) / dx at 0
    is inf * 0."""
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with pytest.raises((RuntimeError, FloatingPointError), match="nan|NaN"):
        with nan_debug():
            torch.sqrt(x**2).sum().backward()
