"""The transverse deflecting cavity (``TransverseDeflectingCavity``), which
the JAX package does not have: its map symplectic in float64, the limit of
drift-kick-drift slices of its kick law, the drift at 0 V, equal to the
plain reference's matrix exponential (``portbench/reference/gpsr6d.py``),
the two beam types agreeing through it, ``gradcheck`` in the voltage, a
LatticeJSON round trip, slices composing to the whole, and its runs taking
the dense route."""

import math
import sys
from pathlib import Path

import pytest
import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch import functional
from lynx_tpu_torch.accelerator import segment as segment_module
from lynx_tpu_torch.accelerator.fused import element_map_builder
from lynx_tpu_torch.ops.rmatrix import drift_rmatrix, igamma2_from_energy

ROOT = Path(__file__).resolve().parents[1]
F64 = dict(dtype=torch.float64, device="cpu")
ENERGY = torch.tensor(1.073e8, **F64)
FREQUENCY = 11995199488.0  # ARES's PolariX structures, as the lattice file holds it
#: The symplectic form of (x, x', y, y', s, p) as this package's maps keep
#: it: the (s, p) pair turns the other way (a sector bend's map keeps it).
J = torch.zeros(6, 6, **F64)
for i, sign in ((0, 1.0), (2, 1.0), (4, -1.0)):
    J[i, i + 1], J[i + 1, i] = sign, -sign


def tds(voltage=3e6, phase=0.0, tilt=0.0, length=1.0):
    return ltt.TransverseDeflectingCavity(length, voltage=voltage, phase=phase,
                                          frequency=FREQUENCY, tilt=tilt, **F64)


def kappa(voltage, phase=0.0):
    p0c = ENERGY * torch.sqrt(1 - igamma2_from_energy(ENERGY))
    return 2 * math.pi * FREQUENCY / 299792458.0 * voltage * math.cos(math.radians(phase)) / p0c


def test_the_bend_keeps_this_form_and_so_does_the_tds():
    bend = ltt.Dipole(length=0.4385, angle=0.8203, e2=-0.7505, **F64).transfer_map(ENERGY)[:6, :6]
    assert torch.allclose(bend.T @ J @ bend, J, rtol=0, atol=1e-14)
    for voltage, phase, tilt in [(3e6, 0.0, 0.0), (-5e6, 30.0, 0.0), (2e7, 0.0, 0.4),
                                 (1e6, 90.0, math.pi / 2)]:
        m = tds(voltage, phase, tilt).transfer_map(ENERGY)[:6, :6]
        assert torch.allclose(m.T @ J @ m, J, rtol=0, atol=1e-13 * float(m.abs().max()) ** 2)


def test_the_map_is_the_limit_of_drift_kick_drift_slices():
    """n slices, each a half drift, the linearised kick of a 1/n share of the
    length (y' -= kappa s / n, p += kappa y / n, y' += A / n) and a half
    drift, converge to the map as 1/n^2."""
    voltage, phase = 4e6, 20.0
    whole = tds(voltage, phase).transfer_map(ENERGY)
    p0c = ENERGY * torch.sqrt(1 - igamma2_from_energy(ENERGY))
    k, A = kappa(voltage, phase), voltage * math.sin(math.radians(phase)) / p0c
    errors = []
    for n in (2_000, 20_000):
        half = drift_rmatrix(torch.tensor(0.5 / n, **F64), ENERGY)
        kick = torch.eye(7, **F64)
        kick[3, 4], kick[5, 2], kick[3, 6] = -k / n, k / n, A / n
        errors.append(float((torch.linalg.matrix_power(half @ kick @ half, n) - whole).abs().max()))
    assert errors[1] < 1e-7 * float(whole.abs().max())
    assert 80 < errors[0] / errors[1] < 120  # second order


def test_the_first_order_terms():
    """Emma, Frisch and Krejcik's thick deflector, y += L y' - (kappa L / 2)
    s, y' -= kappa s, p += kappa y + (kappa L / 2) y' - (kappa^2 L / 6) s,
    to within the drift's r56 terms (u = kappa^2 eta L^2 = 1.1e-3 here, which
    moves them by u / 5! and less)."""
    m = tds(3e6).transfer_map(ENERGY)
    k = float(kappa(3e6))
    for (i, j), want in {(3, 4): -k, (2, 4): -k / 2, (5, 2): k, (5, 3): k / 2,
                         (5, 4): -k * k / 6}.items():
        assert float(m[i, j]) == pytest.approx(want, rel=2e-5), (i, j)
    assert torch.equal(m[:2, :2], torch.tensor([[1.0, 1.0], [0.0, 1.0]], **F64))


def test_the_drift_at_zero_voltage():
    m = tds(0.0, phase=37.0).transfer_map(ENERGY)
    assert torch.equal(m, drift_rmatrix(torch.tensor(1.0, **F64), ENERGY))


@pytest.mark.parametrize("phase", [0.0, 25.0])
def test_the_map_equals_the_plain_references_matrix_exponential(phase):
    sys.path.insert(0, str(ROOT))
    from portbench.reference.gpsr6d import tds_map

    voltage = torch.tensor([0.0, 8e5, -3e6, 2e7], **F64)
    want = tds_map(1.0, voltage, phase, FREQUENCY, 1.073e8, torch.float64, "cpu")
    got = tds(voltage, phase).transfer_map(ENERGY)
    assert got.shape == (4, 7, 7)
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))


def test_both_beam_types_agree_through_it():
    gen = torch.Generator().manual_seed(3)
    particles = torch.randn((20_000, 7), generator=gen, **F64) * torch.tensor(
        [1e-4, 1e-5, 5e-5, 2e-5, 3e-5, 1e-3, 0.0], **F64)
    particles[:, 6] = 1.0
    beam = ltt.ParticleBeam(particles, ENERGY)
    segment = ltt.Segment([ltt.Drift(0.5, **F64), tds(torch.tensor([0.0, 2e6, 5e6], **F64), 10.0),
                           ltt.Drift(3.0, **F64)])
    out = functional.track(segment, beam)[0]
    moments = functional.track(segment, beam.as_parameter_beam())[0]
    mu = out.particles.mean(-2)
    centred = out.particles - mu[..., None, :]
    cov = centred.transpose(-2, -1) @ centred / (particles.shape[0] - 1)
    assert torch.allclose(mu, moments._mu, rtol=0, atol=1e-12)
    scale = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    scale = scale[..., :, None] * scale[..., None, :] + 1e-30
    assert torch.allclose(cov / scale, moments._cov / scale, rtol=0, atol=1e-9)
    assert float(out.sigma_y[2]) > 3 * float(out.sigma_y[0])  # the streak


def test_gradcheck_in_the_voltage():
    voltage = torch.tensor([1e6, -2e6], **F64, requires_grad=True)
    x = torch.randn((50, 7), generator=torch.Generator().manual_seed(1), **F64) * 1e-4
    x[:, 6] = 1.0

    def pushed(v):
        segment = ltt.Segment([tds(v * 1e6, 15.0), ltt.Drift(2.0, **F64)])
        return functional.track(segment, ltt.ParticleBeam(x, ENERGY))[0].particles

    assert torch.autograd.gradcheck(pushed, (voltage / 1e6,))


def test_a_lattice_json_round_trip(tmp_path):
    segment = ltt.Segment([ltt.Drift(0.5, **F64), tds(8e5, 12.0, 0.25, length=1.0)], name="line")
    segment.elements[1].name = "ARDLRXBD1"
    segment.to_lattice_json(str(tmp_path / "line.json"))
    reloaded = ltt.Segment.from_lattice_json(str(tmp_path / "line.json"), dtype=torch.float64,
                                             device="cpu")
    assert type(reloaded.ARDLRXBD1) is ltt.TransverseDeflectingCavity
    assert reloaded == segment
    assert torch.allclose(reloaded.ARDLRXBD1.transfer_map(ENERGY),
                          segment.ARDLRXBD1.transfer_map(ENERGY), rtol=1e-6)


def test_its_slices_compose_to_the_whole_map():
    whole = tds(3e6, 10.0, 0.2, length=1.0)
    pieces = whole.split(0.3)
    assert len(pieces) == 4
    composed = torch.eye(7, **F64)
    for piece in pieces:
        composed = piece.transfer_map(ENERGY) @ composed
    assert torch.allclose(composed, whole.transfer_map(ENERGY), rtol=0, atol=1e-12)


def test_its_runs_take_the_dense_route(monkeypatch):
    """No fused map builder: with B3/B4's sweep and B8's push forced on (and
    made to fail if taken), a run that holds it folds densely, for both beam
    types, and carries the gradient in the voltage."""
    def taken(*args):
        raise AssertionError("a fused route took a run with a TDS")

    monkeypatch.setattr(segment_module, "FUSED_SWEEP_PATH", True)
    monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", True)
    monkeypatch.setattr(segment_module, "PALLAS_SWEEP_THRESHOLD", 1)
    for route in ("_sweep", "_particle_sweep", "_particle_push"):
        monkeypatch.setattr(segment_module, route, taken)
    voltage = torch.full((4,), 1e6, **F64, requires_grad=True)
    run = [ltt.Drift(0.3, **F64), tds(voltage), ltt.Quadrupole(0.1, k1=2.0, **F64)]
    assert element_map_builder(run[1]) is None
    particles = ltt.ParticleBeam(torch.eye(7, **F64)[None].expand(4, 7, 7).clone(), ENERGY)
    for beam in (particles, particles.as_parameter_beam()):
        out = segment_module.Segment._flush_run(run, beam, per_setting_push=True)
        want = segment_module.flush_run(run, beam)
        for got, expected in zip(vars(out).values(), vars(want).values()):
            if isinstance(got, torch.Tensor):
                assert torch.equal(got, expected)
    out = functional.track(ltt.Segment(run), particles)[0]
    (grad,) = torch.autograd.grad(out.particles[..., 2, 4].sum(), voltage)
    assert torch.all(grad != 0)
