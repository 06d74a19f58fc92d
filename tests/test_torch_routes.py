"""The route a run of skippable elements takes (``segment._choose_route``),
on the CPU with the card's routing: the switches left to the device (or set
as a case says) and the beam's tensors read as CUDA tensors by the chooser.
The routes are recorded, not run.

One case per condition of each route, on its accepting and its refusing
side.  Each case tracks through ``Segment.track`` and ``functional.track``:
both take the case's route, except in B2's window, where
``functional.track`` (which never takes B2) takes the route B2 would
otherwise leave to, and each makes every element's map builder once.
"""

import pytest
import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch import functional
from lynx_tpu_torch.accelerator import fused
from lynx_tpu_torch.accelerator import segment as segment_module
from lynx_tpu_torch.accelerator.custom_transfer_map import CustomTransferMap
from lynx_tpu_torch.accelerator.drift import Drift
from lynx_tpu_torch.accelerator.quadrupole import Quadrupole

SWEEP = segment_module.PALLAS_SWEEP_THRESHOLD
PUSH_N = segment_module.PARTICLE_SWEEP_N_THRESHOLD
MIN_B = segment_module._PARTICLE_SWEEP_MIN_SETTINGS
S = 3  # settings that a case's field or energy carries
N = 8  # particles per setting, below PUSH_N
ENERGY = 1.073e8


class OnCard(torch.Tensor):
    """A CPU tensor that the chooser reads as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


class UnbuiltDrift(Drift):
    """A drift that ``element_map_builder`` does not know (it matches the
    type exactly)."""


def lattice(dtype=torch.float32, k1=4.0, length=0.5, custom=False):
    if custom:
        return [CustomTransferMap(torch.eye(7, dtype=dtype), device="cpu", dtype=dtype)]
    return [Drift(length, device="cpu", dtype=dtype),
            Quadrupole(0.2, k1=k1, device="cpu", dtype=dtype),
            Drift(0.3, device="cpu", dtype=dtype)]


def parameter_beam(T, card=True, energy=ENERGY):
    mu = torch.zeros(T, 7)
    cov = torch.eye(7).expand(T, 7, 7).clone()
    beam = ltt.ParameterBeam(mu, cov, torch.as_tensor(energy), device="cpu")
    if card:
        beam._mu = beam._mu.as_subclass(OnCard)
    return beam


def particle_beam(shape, card=True, energy=ENERGY, requires_grad=False):
    particles = torch.randn(*shape, 7, generator=torch.Generator().manual_seed(0))
    beam = ltt.ParticleBeam(particles.requires_grad_(requires_grad), torch.as_tensor(energy),
                            device="cpu")
    if card:
        beam.particles = beam.particles.as_subclass(OnCard)
    return beam


def grad_k1():
    return torch.tensor(4.0, requires_grad=True)


# name: (elements, beam, switches, Segment.track's route, functional.track's
# route where it differs: in B2's window).
CASES = {
    # The fused moment sweep, B3/B4.
    "sweep: at the threshold": lambda: (lattice(), parameter_beam(SWEEP), {}, "sweep"),
    "sweep: below the threshold": lambda: (lattice(), parameter_beam(SWEEP - 1), {}, "dense"),
    "sweep: the lengths count in the shape": lambda: (
        lattice(length=torch.full((SWEEP,), 0.5)), parameter_beam(1), {}, "sweep"),
    "sweep: the energy counts in the shape": lambda: (
        lattice(), parameter_beam(1, energy=torch.full((SWEEP,), ENERGY)), {}, "sweep"),
    "sweep: on the CPU": lambda: (lattice(), parameter_beam(SWEEP, card=False), {}, "dense"),
    "sweep: switched on on the CPU": lambda: (
        lattice(), parameter_beam(SWEEP, card=False), {"FUSED_SWEEP_PATH": True}, "sweep"),
    "sweep: switched off": lambda: (
        lattice(), parameter_beam(SWEEP), {"FUSED_SWEEP_PATH": False}, "dense"),
    "sweep: an element without a builder": lambda: (
        [UnbuiltDrift(0.5, device="cpu")], parameter_beam(SWEEP), {}, "dense"),
    # The per-setting particle push, B2.
    "B2: B at its least": lambda: (lattice(), particle_beam((MIN_B, N)), {}, "B2", "B8"),
    "B2: B below its least": lambda: (lattice(), particle_beam((MIN_B - 1, N)), {}, "B8"),
    "B2: N below the threshold": lambda: (
        lattice(), particle_beam((MIN_B, PUSH_N - 1)), {}, "B2", "B8"),
    "B2: N at the threshold": lambda: (lattice(), particle_beam((MIN_B, PUSH_N)), {}, "B8"),
    "B2: the settings match B": lambda: (
        lattice(length=torch.full((MIN_B,), 0.5)), particle_beam((MIN_B, N)), {}, "B2", "B8"),
    "B2: a setting broadcasts B": lambda: (
        lattice(length=torch.full((2, 1), 0.5)), particle_beam((MIN_B, N)), {}, "dense"),
    "B2: (N, 7) particles": lambda: (lattice(), particle_beam((N,)), {}, "B8"),
    "B2: on the CPU, switched on": lambda: (
        lattice(), particle_beam((MIN_B, PUSH_N), card=False), {"PARTICLE_SWEEP_PATH": True},
        "B2", "dense"),
    "B2: switched off": lambda: (
        lattice(), particle_beam((MIN_B, N)), {"PARTICLE_SWEEP_PATH": False}, "B8"),
    "B2: an element without a builder": lambda: (
        [UnbuiltDrift(0.5, device="cpu")], particle_beam((MIN_B, N)), {}, "dense"),
    # The particle push with the maps built on the card, B8.
    "B8: one setting": lambda: (lattice(), particle_beam((N,)), {}, "B8"),
    "B8: settings matching the particles": lambda: (
        lattice(k1=torch.linspace(-4.0, 4.0, S)), particle_beam((S, N)), {}, "B8"),
    "B8: a setting broadcasting the particles": lambda: (
        lattice(k1=torch.linspace(-4.0, 4.0, S)), particle_beam((N,)), {}, "dense"),
    "B8: a custom-only run leaves the energy out": lambda: (
        lattice(custom=True), particle_beam((N,), energy=torch.full((S,), ENERGY)), {}, "B8"),
    "B8: the energy broadcasting the particles": lambda: (
        lattice(), particle_beam((N,), energy=torch.full((S,), ENERGY)), {}, "dense"),
    "B8: a float64 element on float32 particles": lambda: (
        lattice(torch.float64), particle_beam((N,)), {}, "dense"),
    "B8: a leaf that requires grad": lambda: (
        lattice(k1=grad_k1()), particle_beam((N,)), {}, "dense"),
    "B8: particles that require grad": lambda: (
        lattice(), particle_beam((N,), requires_grad=True), {}, "dense"),
    "B8: a leaf that requires grad, under no_grad": lambda: (
        lattice(k1=grad_k1()), particle_beam((N,)), {}, "B8"),
    "B8: on the CPU": lambda: (lattice(), particle_beam((N,), card=False), {}, "dense"),
    "B8: switched on on the CPU": lambda: (
        lattice(), particle_beam((N,), card=False), {"PARTICLE_PUSH_PATH": True}, "B8"),
    "B8: switched off": lambda: (
        lattice(), particle_beam((N,)), {"PARTICLE_PUSH_PATH": False}, "dense"),
    "B8: an element without a builder": lambda: (
        [UnbuiltDrift(0.5, device="cpu")], particle_beam((N,)), {}, "dense"),
}


@pytest.fixture
def routes(monkeypatch):
    """Record the routes taken and ``element_map_builder``'s calls; the
    switches start from the device's choice."""
    for switch in ("FUSED_SWEEP_PATH", "PARTICLE_SWEEP_PATH", "PARTICLE_PUSH_PATH"):
        monkeypatch.setattr(segment_module, switch, None)
    taken, built = [], []
    for name, route in (("_sweep", "sweep"), ("_particle_sweep", "B2"),
                        ("_particle_push", "B8")):
        monkeypatch.setattr(segment_module, name,
                            lambda builders, beam, batch_shape, route=route:
                            taken.append(route) or beam)
    monkeypatch.setattr(segment_module, "flush_run",
                        lambda run, beam: taken.append("dense") or beam)
    element_map_builder = fused.element_map_builder
    monkeypatch.setattr(fused, "element_map_builder",
                        lambda element: built.append(element) or element_map_builder(element))
    return taken, built


def track_both(case, monkeypatch, routes):
    """The routes ``Segment.track`` and ``functional.track`` take, and the
    elements whose builders each made."""
    elements, beam, switches, *expected = CASES[case]()
    for switch, value in switches.items():
        monkeypatch.setattr(segment_module, switch, value)
    taken, built = routes
    segment = segment_module.Segment(elements)
    out = []
    for track in (segment.track, lambda beam: functional.track(segment, beam)[0]):
        taken.clear(), built.clear()
        if case.endswith("under no_grad"):
            with torch.no_grad():
                track(beam)
        else:
            track(beam)
        out.append((list(taken), [id(element) for element in built]))
    return [id(element) for element in elements], out, expected


@pytest.mark.parametrize("case", CASES)
def test_the_route_and_one_builder_per_element(case, monkeypatch, routes):
    elements, ((taken, built), _), (route, *_) = track_both(case, monkeypatch, routes)
    assert taken == [route]
    assert built == elements  # each element's builder made once, in order


def test_functional_track_takes_segment_tracks_route_outside_b2s_window(monkeypatch, routes):
    for case in CASES:
        with monkeypatch.context() as patch:
            elements, (by_segment, by_functional), expected = track_both(case, patch, routes)
        segment_route, *in_window = expected
        assert bool(in_window) == (segment_route == "B2"), case
        functional_route = in_window[0] if in_window else segment_route
        assert by_segment[0] == [segment_route], case
        assert by_functional == ([functional_route], elements), case
