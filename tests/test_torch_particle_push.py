"""The particle push with a run's maps built on the card (kernel B8) on the
CPU: its plain version, forced through ``segment.PARTICLE_PUSH_PATH``,
against the dense route (``segment.flush_run``: each element's map in
PyTorch, the maps folded, one matmul), and the route's choices.

Lattices: the ARES-EA segment (the screen read's), one of every element
kind the full instantiation builds (a tilted dipole with edges and fringe
fields, a thin one, an RBend, a misaligned solenoid, an inactive cavity, an
undulator, a custom map) beside misaligned quadrupoles with k1 = 0 on a
setting, correctors and the identity elements, and path V's random element
mixes of seeds 0-15 (``chip_smoke.random_lattice``, the JAX suite's
generator; every field drawn per setting, the cavities active on even
seeds, so that they split the runs, and inactive on odd ones).  Shapes: one
setting as ``(1, N, 7)``, three settings, and ``(N, 7)`` particles (one
setting, whose fields broadcast them to ``(1, N, 7)`` on both routes).
Bounds: relative to each setting's largest coordinate, float64 within path
V's 1e-12 (``chip_smoke.DOUBLE_RTOL``), float32 within B2's 1e-5
(``chip_smoke.FLOAT_RTOL``): the two routes sum the same products in other
orders.
"""

import pytest
import torch

import chip_smoke
import lynx_tpu_torch as ltt
from lynx_tpu_torch import functional, graphs
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.accelerator import segment as segment_module
from lynx_tpu_torch.models import ares_ea_segment
from lynx_tpu_torch.ops import fused_track as ft

N = 64
RTOL = {torch.float64: chip_smoke.DOUBLE_RTOL, torch.float32: chip_smoke.FLOAT_RTOL["B2"]}
LATTICES = ("ares_ea", "full_kinds", *(f"random_{seed}" for seed in chip_smoke.RANDOM_SEEDS))
SHAPES = {"B=1": 1, "B=3": 3, "(N, 7)": 1}


@pytest.fixture
def pushes(monkeypatch):
    """Count the plain B8's calls; restore the routing knob."""
    monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", None)
    calls = []
    original = ft.particle_push_reference
    monkeypatch.setattr(ft, "particle_push_reference",
                        lambda *args: calls.append(args[-1].shape) or original(*args))
    return calls


def ares(B, dtype):
    segment = ares_ea_segment(dtype=dtype, device="cpu")
    if B > 1:
        segment = segment.broadcast((B,))
    spread = torch.linspace(0.8, 1.2, B, dtype=dtype)
    for name, k1 in {"AREAMQZM1": 4.2, "AREAMQZM2": -4.2, "AREAMQZM3": 0.0}.items():
        getattr(segment, name).k1 = k1 * spread
    segment.AREAMCVM1.angle = 1e-3 * spread
    return segment


def full_kinds(B, dtype):
    """Every kind with a device builder, fields per setting."""
    gen = torch.Generator().manual_seed(B)
    kw = dict(dtype=dtype, device="cpu")

    def u(low, high, *shape):
        return low + (high - low) * torch.rand(shape or (B,), generator=gen, dtype=dtype)

    k1 = u(-5.0, 5.0)
    k1[0] = 0.0
    return ltt.Segment([
        ltt.Marker(**kw),
        ltt.Quadrupole(u(0.1, 0.3), k1=k1, tilt=u(-0.1, 0.1), misalignment=u(-2e-4, 2e-4, B, 2),
                       **kw),
        ltt.Drift(u(0.2, 0.6), **kw),
        ltt.Dipole(u(0.2, 0.5), angle=u(-0.2, 0.2), e1=u(-0.05, 0.05), e2=u(-0.05, 0.05),
                   tilt=u(-0.1, 0.1), fringe_integral=u(0.3, 0.6), fringe_integral_exit=u(0.3, 0.6),
                   gap=u(0.01, 0.05), **kw),
        ltt.Dipole(torch.zeros(B, dtype=dtype), angle=u(-1e-3, 1e-3), **kw),
        ltt.RBend(u(0.2, 0.4), angle=u(-0.2, 0.2), gap=u(0.01, 0.03), **kw),
        ltt.HorizontalCorrector(u(0.05, 0.1), angle=u(-1e-3, 1e-3), **kw),
        ltt.BPM(**kw),
        ltt.Solenoid(u(0.1, 0.3), k=u(-3.0, 3.0), misalignment=u(-2e-4, 2e-4, B, 2), **kw),
        ltt.Cavity(u(0.5, 1.5), voltage=torch.zeros(B, dtype=dtype), phase=u(-30.0, 30.0),
                   frequency=u(1e9, 3e9), **kw),
        ltt.VerticalCorrector(u(0.05, 0.1), angle=u(-1e-3, 1e-3), **kw),
        ltt.Undulator(u(0.5, 2.0), **kw),
        ltt.CustomTransferMap(torch.eye(7, dtype=dtype) + 0.05 * u(-1.0, 1.0, B, 7, 7), **kw),
        ltt.Screen(**kw),
        ltt.Aperture(x_max=torch.tensor([1e-3], dtype=dtype), is_active=False, **kw),
    ])


def lattice(name, B, dtype):
    if name == "ares_ea":
        return ares(B, dtype)
    if name == "full_kinds":
        return full_kinds(B, dtype)
    seed = int(name.split("_")[1])
    segment = chip_smoke.random_lattice(torch, ltt, seed, chip_smoke.random_length(seed),
                                        dtype=dtype, device="cpu")
    settings = chip_smoke.random_settings(torch, segment, B, seed, cavities=seed % 2 == 0)
    chip_smoke.apply_settings(segment, settings)
    return segment


def beam(shape, dtype, seed=0):
    B = SHAPES[shape]
    cloud = chip_smoke.random_particle_beam(torch, ltt, B, N, seed, "cpu", dtype=dtype)
    if shape == "(N, 7)":
        return ltt.ParticleBeam(cloud.particles[0], cloud.energy[0])
    return cloud


def per_setting_error(actual, expected):
    scale = expected.abs().flatten(-2).amax(dim=-1)
    return float(((actual - expected).abs().flatten(-2).amax(dim=-1) / scale).max())


def runs(segment):
    """The skippable runs that a track flushes."""
    return len(chip_smoke.skippable_runs(segment.flattened().elements))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", LATTICES)
def test_plain_push_matches_the_dense_route(name, shape, dtype, pushes, monkeypatch):
    segment = lattice(name, SHAPES[shape], dtype)
    incoming = beam(shape, dtype)
    with torch.no_grad():
        monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", False)
        dense = segment.track(incoming)
        assert not pushes
        monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", True)
        pushed = segment.track(incoming)
    assert len(pushes) == runs(segment)
    assert pushed.particles.shape == dense.particles.shape
    assert pushed.particles.dtype == dense.particles.dtype
    assert torch.equal(pushed.energy, dense.energy)
    assert per_setting_error(pushed.particles, dense.particles) <= RTOL[dtype]


def test_screen_read_through_the_push(pushes, monkeypatch):
    """``functional.track`` takes the push too, and ``track_jit``'s CPU
    rehearsal of a capture reads nothing on the host: the read's image
    equals the dense route's, pixel for pixel."""
    segment = ares(1, torch.float32)
    segment.AREABSCR1.is_active = True
    incoming = chip_smoke.random_particle_beam(torch, ltt, 1, 5000, 3, "cpu",
                                               dtype=torch.float32)
    monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", False)
    dense = functional.track(segment, incoming)[1]["AREABSCR1"]
    monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", True)
    with graphs.host_read_guard():
        pushed = functional.track_jit(segment, incoming)[1]["AREABSCR1"]
    assert pushes == [(1, 5000, 7)]
    assert torch.equal(pushed, dense)


def test_a_gradient_keeps_the_dense_route(pushes, monkeypatch):
    """Where a field or the particles need a gradient, the run takes the
    dense route and its gradient is the dense route's; without grad mode the
    same inputs take the push."""
    monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", True)
    for grad_on in ("k1", "particles"):
        segment = ares(1, torch.float64)
        incoming = beam("B=1", torch.float64)
        inputs = {"k1": segment.AREAMQZM2.k1.clone().requires_grad_(True),
                  "particles": incoming.particles.clone().requires_grad_(True)}
        segment.AREAMQZM2.k1 = inputs["k1"]
        incoming = ltt.ParticleBeam(inputs["particles"], incoming.energy)
        grads = []
        for route in (True, False):
            monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", route)
            out = segment.track(incoming)
            grads.append(torch.autograd.grad(out.sigma_x.sum(), inputs[grad_on])[0])
        assert not pushes, grad_on
        assert torch.equal(*grads)
        monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", True)
        with torch.no_grad():
            segment.track(incoming)
        assert pushes == [(1, N, 7)]
        pushes.clear()


class SteppedDrift(ltt.Drift):
    """A drift of its own type: no device builder."""


@pytest.mark.parametrize("case", ["no device builder", "parameter beam", "element dtype",
                                  "particles broadcast"])
def test_runs_the_push_does_not_take(case, pushes, monkeypatch):
    """The dense route keeps an element without a device builder, a
    ParameterBeam, elements of another dtype than the particles', and
    particles that the settings would broadcast; the results are the dense
    route's."""
    dtype = torch.float64
    segment, incoming = ares(1, dtype), beam("B=1", dtype)
    if case == "no device builder":
        segment = ltt.Segment([*segment.elements[:3], SteppedDrift(torch.tensor([0.2]), dtype=dtype),
                               *segment.elements[3:]])
    elif case == "parameter beam":
        incoming = chip_smoke.random_parameter_beam(torch, ltt, 1, "cpu")
    elif case == "element dtype":
        segment = ares(1, torch.float32)
    else:
        segment = ares(3, dtype)
        incoming = ltt.ParticleBeam(incoming.particles[0], incoming.energy[0])
    monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", False)
    dense = [segment.track(incoming), functional.track(segment, incoming)[0]]
    monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", True)
    for got, want in zip([segment.track(incoming), functional.track(segment, incoming)[0]], dense):
        for name in ("mu_x", "sigma_x", "mu_y", "sigma_y"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not pushes


@pytest.mark.parametrize("name", LATTICES)
def test_push_masks_are_the_composed_layout(name):
    """The masks B8 takes, composed once per structure on stand-in values,
    are the structural zeros and ones of the run's own composed table."""
    segment = lattice(name, 3, torch.float64)
    energy = torch.full((3,), 1e8, dtype=torch.float64)
    for run in chip_smoke.skippable_runs(segment.elements):
        builders = [torch_fused.element_map_builder(el) for el in run]
        entries = tuple(("dyn", fn, len(values)) for values, fn in builders)
        values = [torch.broadcast_to(p, (3,)) for values, _ in builders for p in values]
        total = ft._compose_entries(entries, values, energy)
        assert ft._push_masks(entries) == ft._layout_masks(ft._split_table(total)[0])
