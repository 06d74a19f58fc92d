"""PyTorch idiom of the port's lattice: elements are ``nn.Module``s with
buffers, a segment keeps them in an ``nn.ModuleList`` and finds them by name
without breaking ``nn.Module``'s own attribute lookup, and tracking never
skips an element type it cannot track."""

import pytest
import torch
from torch import nn

import lynx_tpu_torch as ltt
from lynx_tpu_torch import functional
from lynx_tpu_torch.accelerator.element import Element


def small_segment():
    return ltt.Segment(
        [
            ltt.Marker(name="start", device="cpu"),
            ltt.Drift(torch.tensor([0.5]), name="d1"),
            ltt.Quadrupole(torch.tensor([0.2]), k1=torch.tensor([3.0]), name="q1"),
            ltt.Drift(torch.tensor([0.5]), name="dup"),
            ltt.Drift(torch.tensor([0.25]), name="dup"),
            ltt.Screen(resolution=(64, 48), pixel_size=(1e-5, 1e-5), is_active=True, name="scr",
                       device="cpu"),
        ],
        name="cell",
    )


def test_segment_is_a_module_list_of_buffered_elements():
    segment = small_segment()
    assert isinstance(segment.elements, nn.ModuleList)
    buffers = dict(segment.named_buffers())
    assert "elements.2.k1" in buffers and "elements.5.pixel_size" in buffers
    assert segment.training  # nn.Module's own attributes still resolve
    assert segment.elements[2] is segment.q1


def test_name_lookup_chains_to_module_getattr():
    segment = small_segment()
    assert isinstance(segment.dup, list) and len(segment.dup) == 2
    with pytest.raises(AttributeError):
        segment.no_such_element
    with pytest.raises(AttributeError):
        segment._no_such_private


def test_field_reassignment_updates_the_buffer():
    segment = small_segment()
    segment.q1.k1 = torch.tensor([4.2])
    assert dict(segment.named_buffers())["elements.2.k1"].item() == pytest.approx(4.2)
    segment.q1.k1 = -1.5  # a number becomes a tensor of the field's dtype
    assert segment.q1.k1.dtype == torch.float32 and float(segment.q1.k1) == -1.5
    doubled = segment.to(torch.float64)
    assert doubled.q1.k1.dtype == doubled.scr.misalignment.dtype == torch.float64


def test_track_and_reading_agree_with_functional_track():
    segment = small_segment()
    beam = ltt.ParticleBeam.from_parameters(
        num_particles=2000, sigma_x=torch.tensor([5e-5]), sigma_y=torch.tensor([5e-5]),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    outgoing, diagnostics = functional.track(segment, beam)
    assert outgoing is None
    assert segment.track(beam) is ltt.Beam.empty
    assert torch.equal(segment.scr.reading, diagnostics["scr"])
    assert diagnostics["scr"].shape == (1, 48, 64)


def test_inactive_screen_passes_the_beam_and_segments_broadcast():
    segment = small_segment()
    segment.scr.is_active = False
    segment.scr.histogram_window = (32, 16)
    wide = segment.broadcast((3,))
    assert wide.q1.k1.shape == (3,) and wide.scr.misalignment.shape == (3, 2)
    assert wide.scr.histogram_window == (32, 16)  # else batched reads fall back
    beam = ltt.ParticleBeam(torch.zeros(1, 4, 7) + torch.eye(7)[6], torch.tensor([1e8]))
    outgoing, diagnostics = functional.track(wide, beam)
    assert outgoing.particles.shape == (3, 4, 7) and not diagnostics
    assert float(wide.length[0]) == pytest.approx(1.45)


@pytest.mark.parametrize("windowed", [False, True])
def test_survival_weights_count_unless_fractional_is_declared(monkeypatch, windowed):
    """Survival masks are 0/1, so windowed readings count live particles
    (kernel B1's count mode); with SCREEN_BINARY_SURVIVAL off they sum
    fractional weights instead, as the scatter route always does."""
    import lynx_tpu_torch.accelerator.screen as screen_mod
    import lynx_tpu_torch.ops.histogram as hist

    monkeypatch.setattr(hist, "SCREEN_WINDOWED_PATH", windowed)
    particles = torch.zeros(1, 100, 7)
    particles[..., 0] = torch.linspace(-1e-4, 1e-4, 100)
    particles[..., 6] = 1.0
    survival = torch.full((1, 100), 0.5)
    survival[0, :10] = 0.0  # lost particles never count
    beam = ltt.ParticleBeam(particles, torch.tensor([1e8]), survival=survival)
    screen = ltt.Screen(resolution=(640, 480), pixel_size=(1e-6, 1e-6), is_active=True,
                        name="scr", device="cpu")
    screen.histogram_window = (256, 16)
    _, diagnostics = functional.track(ltt.Segment([screen]), beam)
    assert float(diagnostics["scr"].sum()) == (90.0 if windowed else 45.0)
    monkeypatch.setattr(screen_mod, "SCREEN_BINARY_SURVIVAL", False)
    _, diagnostics = functional.track(ltt.Segment([screen]), beam)
    assert float(diagnostics["scr"].sum()) == 45.0


def test_unported_element_type_raises_by_name():
    class Kicker(Element):
        @property
        def is_skippable(self):
            return False

    segment = ltt.Segment([ltt.Drift(torch.tensor([1.0])), Kicker(name="k", device="cpu")])
    beam = ltt.ParticleBeam(torch.ones(1, 3, 7), torch.tensor([1e8]))
    with pytest.raises(NotImplementedError, match="Kicker"):
        functional.track(segment, beam)


def test_screen_reading_of_a_parameter_beam_is_a_normalised_density():
    screen = ltt.Screen(resolution=(200, 100), pixel_size=(1e-5, 1e-5), is_active=True,
                        device="cpu")
    beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1e-4]), sigma_y=torch.tensor([5e-5]), dtype=torch.float64,
        device="cpu",
    )
    screen.track(beam)
    image = screen.reading
    assert image.shape == (1, 100, 200)
    assert float(image.sum() * 1e-10) == pytest.approx(1.0, rel=1e-3)
