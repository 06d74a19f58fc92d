"""Generative phase-space reconstruction on the port (``ops.kde``,
``Screen(method="kde")``, ``reconstruction``) at small sizes on the CPU:
N = 2,048 particles, S = 4 settings of AREAMQZM3, a 48 x 40 image (the
ARES EA's AREABSCR1 binned 51).

The blocked KDE against the plain formula and ``gradcheck`` in float64; the screen's default still the histogram, bit
for bit; the KDE reading's orientation and normalisation; the captured
step's CPU rehearsal under the host-read guard; and the whole step (images,
loss, first gradient, three Adam steps) against the benchmark's plain
reference ``portbench/reference/gpsr.py`` on seeded random weights."""

import math
from pathlib import Path

import pytest
import torch

from lynx_tpu_torch import graphs
from lynx_tpu_torch.accelerator import screen as screen_module
from lynx_tpu_torch.examples import phase_space_reconstruction as example
from lynx_tpu_torch.functional import track
from lynx_tpu_torch.ops import kde
from lynx_tpu_torch.particles import ParticleBeam
from lynx_tpu_torch.reconstruction import BeamGenerator, make_reconstruction_step

ROOT = Path(__file__).resolve().parents[1]
N, S = 2048, 4
BINNING = 51  # AREABSCR1's 2448 x 2040 binned 51: 48 x 40 pixels
BANDWIDTH = 1.275e-4  # one binned pixel's height (2.5003 um x 51)


def kde_operands(n=N, settings=S, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((settings, n), generator=gen, dtype=dtype) * 0.3
    y = torch.randn((settings, n), generator=gen, dtype=dtype) * 0.2
    weights = torch.rand((settings, n), generator=gen, dtype=dtype)
    x_centres = torch.linspace(-1.0, 1.0, 48, dtype=dtype)
    y_centres = torch.linspace(0.8, -0.8, 40, dtype=dtype)
    return x, y, weights, x_centres, y_centres


@pytest.mark.parametrize("block", [512, 300, 2048, 5000])
@pytest.mark.parametrize("weighted", [True, False])
def test_blocked_route_equals_the_plain_formula(block, weighted):
    """Blocks that divide N (512, 2048), that do not (300) and one larger
    than N: float64 sums in another order, so within 1e-12 of the largest
    pixel."""
    x, y, weights, xc, yc = kde_operands()
    weights = weights if weighted else None
    h = 0.1
    want = kde.kde_sums_reference(x, y, weights, xc, yc, h)
    blocks = kde.kde_sums.blocks
    got = kde.kde_sums(x, y, weights, xc, yc, h, block=block)
    assert kde.kde_sums.blocks - blocks == math.ceil(N / block)
    assert got.shape == (S, 40, 48)
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * float(want.max()))
    # The plain formula written out for one pixel.
    r, c = 17, 29
    k = torch.exp(-0.5 * ((y - yc[r]) / h) ** 2) * torch.exp(-0.5 * ((x - xc[c]) / h) ** 2)
    pixel = (k if weights is None else k * weights).sum(-1)
    assert torch.allclose(got[:, r, c], pixel, rtol=1e-12, atol=0)


@pytest.mark.parametrize("block", [512, 300])
def test_blocked_backward_equals_autograd_of_the_plain_formula(block):
    """The hand-written backward against autograd of the plain version in
    float64, for x, y and the weights, with a random cotangent: the same
    sums in another order, within 1e-10 of the largest."""
    x, y, weights, xc, yc = kde_operands()
    cotangent = torch.randn((S, 40, 48), generator=torch.Generator().manual_seed(5),
                            dtype=torch.float64)
    grads = []
    for route in (kde.kde_sums_reference, lambda *a: kde.kde_sums(*a, block=block)):
        leaves = [t.clone().requires_grad_(True) for t in (x, y, weights)]
        out = route(*leaves, xc, yc, 0.1)
        grads.append(torch.autograd.grad(out, leaves, cotangent))
    for got, want in zip(*grads):
        assert torch.allclose(got, want, rtol=0, atol=1e-10 * float(want.abs().max()))


def test_gradcheck_of_the_blocked_kde():
    """``torch.autograd.gradcheck`` of the blocked sums in float64 (a few
    particles, blocks of 7 that do not divide them)."""
    x, y, weights, xc, yc = kde_operands(n=40, settings=2)
    leaves = [t.clone().requires_grad_(True) for t in (x, y, weights)]
    assert torch.autograd.gradcheck(
        lambda a, b, w: kde.kde_sums(a, b, w, xc[::6], yc[::5], 0.15, block=7), leaves)


def test_a_shared_y_and_weights_broadcast_to_the_settings():
    """``y`` and ``weights`` of one cloud ``(N,)`` broadcast to the settings'
    ``x`` ``(S, N)``, as the plain formula broadcasts them; a leading batch of
    several dimensions keeps its shape."""
    x, y, weights, xc, yc = kde_operands(n=64)
    got = kde.kde_sums(x, y[0], weights[0], xc, yc, 0.1, block=24)
    want = kde.kde_sums_reference(x, y[0].expand_as(x), weights[0].expand_as(x), xc, yc, 0.1)
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * float(want.max()))
    wide = kde.kde_sums(x.reshape(2, 2, 64), y.reshape(2, 2, 64), None, xc, yc, 0.1)
    assert wide.shape == (2, 2, 40, 48)
    assert torch.allclose(wide.reshape(S, 40, 48), kde.kde_sums(x, y, None, xc, yc, 0.1),
                          rtol=0, atol=0)


def ea_segment(dtype=torch.float32, method="kde"):
    """The example's segment in ``dtype``, AREAMQZM1/2 at 4.2/-4.2 in it."""
    segment = example.make_segment("cpu", BINNING, BANDWIDTH)
    if dtype != torch.float32:
        segment = segment.to(dtype=dtype)
        segment.AREAMQZM1.k1 = torch.tensor(4.2, dtype=dtype)
        segment.AREAMQZM2.k1 = torch.tensor(-4.2, dtype=dtype)
    segment.AREABSCR1.method = method
    return segment


def particle_beam(dtype=torch.float32, seed=0, batch=()):
    gen = torch.Generator().manual_seed(seed)
    spread = torch.tensor([2e-4, 2e-5, 1.5e-4, 2e-5, 8e-6, 2e-3], dtype=dtype)
    coords = torch.randn((*batch, N, 6), generator=gen, dtype=dtype) * spread
    particles = torch.cat([coords, torch.ones((*batch, N, 1), dtype=dtype)], dim=-1)
    return ParticleBeam(particles, torch.tensor(1.073e8, dtype=dtype))


def test_the_default_method_still_gives_the_histogram_bit_for_bit():
    """A Screen built without ``method`` reads the histogram, through
    ``Screen.reading`` and ``functional.track``, equal to the histogram read
    called directly."""
    segment = ea_segment(method="kde")
    segment.AREABSCR1.method = screen_module.Screen.method  # the class default
    assert screen_module.Screen(device="cpu").method == "histogram"
    beam = particle_beam()
    _, diagnostics = track(segment, beam)
    screen = segment.AREABSCR1
    at_screen = track(segment.subcell("AREASOLA1", "Drift_AREAMCHM1"), beam)[0]
    want = screen_module.screen_reading_particle(
        screen.misaligned_beam(at_screen), screen.resolution, screen.pixel_size, screen.binning,
        histogram_window=screen.histogram_window)
    assert torch.equal(diagnostics["AREABSCR1"], want)
    assert float(want.sum()) == N  # counts
    segment.track(beam)
    assert torch.equal(screen.reading, want)


def test_the_kde_reading_is_normalised_in_camera_orientation_and_smooth():
    """A spot at (+x, +y) lights the top right; each image sums to 1; the
    reading of ``Screen.reading`` equals ``functional.track``'s and the
    plain formula's; a particle's small move changes the image (the
    histogram's would not)."""
    segment = ea_segment(torch.float64)
    screen = segment.AREABSCR1
    beam = particle_beam(torch.float64, batch=(S,))
    shifted = beam.particles.clone()
    shifted[..., 0] += 1.5e-3
    shifted[..., 2] += 1.0e-3
    beam = ParticleBeam(shifted, beam.energy)
    image = track(segment.subcell("AREABSCR1", "AREABSCR1"), beam)[1]["AREABSCR1"]
    assert image.shape == (S, 40, 48)
    assert torch.allclose(image.sum((-2, -1)), torch.ones(S, dtype=torch.float64), atol=1e-12)
    row, column = divmod(int(image[0].argmax()), 48)
    assert row < 20 and column > 24
    screen.track(beam)
    assert torch.equal(screen.reading, image)
    width, height = 2448 * screen.pixel_size[0], 2040 * screen.pixel_size[1]
    xc = -width / 2 + (torch.arange(48, dtype=torch.float64) + 0.5) * width / 48
    yc = height / 2 - (torch.arange(40, dtype=torch.float64) + 0.5) * height / 40
    raw = kde.kde_sums_reference(shifted[..., 0], shifted[..., 2], None, xc, yc, BANDWIDTH)
    assert torch.allclose(image, raw / (raw.sum((-2, -1), keepdim=True) + 1e-10), rtol=1e-12)
    moved = shifted.clone()
    moved[..., 0, 0] += 1e-6
    assert not torch.equal(track(segment.subcell("AREABSCR1", "AREABSCR1"),
                                 ParticleBeam(moved, beam.energy))[1]["AREABSCR1"], image)


def test_the_kde_bandwidth_defaults_to_one_binned_pixel_and_survives_broadcast():
    screen = screen_module.Screen(resolution=(2448, 2040), pixel_size=(3.5488e-6, 2.5003e-6),
                                  binning=8, is_active=True, method="kde", device="cpu")
    beam = particle_beam()
    default = screen.image(beam)
    binned_pixel = float(screen.effective_pixel_size[1])  # the float32 buffer's
    assert binned_pixel == pytest.approx(8 * 2.5003e-6, rel=1e-7)
    screen.kde_bandwidth = binned_pixel
    assert torch.allclose(default, screen.image(beam), rtol=1e-6, atol=0)
    wide = screen.broadcast((3,))
    assert (wide.method, wide.kde_bandwidth) == ("kde", screen.kde_bandwidth)
    with pytest.raises(ValueError):
        screen_module.Screen(method="bins", device="cpu")


def small_problem(dtype=torch.float32, seed=0):
    segment = ea_segment(dtype)
    k1 = torch.linspace(-10.0, 10.0, S, dtype=dtype)
    truth = BeamGenerator(N, generator=torch.Generator().manual_seed(seed + 1), dtype=dtype,
                          device="cpu")
    with torch.no_grad():
        segment.AREAMQZM3.k1 = k1
        targets = track(segment, truth.beam())[1]["AREABSCR1"]
    generator = BeamGenerator(N, generator=torch.Generator().manual_seed(seed), dtype=dtype,
                              device="cpu")
    return segment, k1, truth, targets, generator


def test_the_beam_generator():
    generator = BeamGenerator(N, generator=torch.Generator().manual_seed(3), device="cpu")
    particles = generator()
    assert particles.shape == (N, 7) and torch.all(particles[:, 6] == 1)
    assert [tuple(p.shape) for p in generator.parameters()] == [
        (20, 6), (20,), (20, 20), (20,), (6, 20), (6,)]
    spread = particles[:, :6].std(0) / generator.spreads
    assert torch.all((spread > 0.05) & (spread < 5))  # the nominal beam's scale
    assert generator.beam().particles.shape == (N, 7)


@pytest.mark.parametrize("block", [kde.BLOCK, 500])
def test_the_step_runs_under_the_host_read_guard_and_learns(block, monkeypatch):
    """The captured step's CPU rehearsal: three steps with no host read
    (what a CUDA graph capture refuses), the loss falling, in one block of
    particles and in several that do not divide them."""
    monkeypatch.setattr(kde, "BLOCK", block)
    segment, k1, _, targets, generator = small_problem()
    optimizer = torch.optim.Adam(generator.parameters(), lr=1e-3)
    step = make_reconstruction_step(segment, {"AREAMQZM3.k1": k1}, generator, optimizer, targets)
    losses = []
    with graphs.host_read_guard():
        for _ in range(3):
            losses.append(step()[0].clone())
    assert step.cache.captures == 1
    assert step.blocks == 2 * math.ceil(N / block)
    assert float(losses[2]) < float(losses[0])


def test_a_screen_without_the_kde_reading_is_refused():
    segment, k1, _, targets, generator = small_problem()
    segment.AREABSCR1.method = "histogram"
    with pytest.raises(ValueError):
        make_reconstruction_step(segment, {"AREAMQZM3.k1": k1}, generator,
                                 torch.optim.Adam(generator.parameters()), targets)


def reference_inputs(generator, truth, k1):
    params = dict(generator.named_parameters())
    return {"weights": {n: p.detach().clone() for n, p in params.items()},
            "z": generator.z.clone(), "k1": k1.clone(),
            "truth_weights": {n: p.detach().clone() for n, p in truth.named_parameters()},
            "truth_z": truth.z.clone()}


@pytest.mark.parametrize("block", [kde.BLOCK, 500])
def test_the_step_against_the_plain_reference(block, monkeypatch):
    """Three steps of the program in float64 on the CPU against
    ``portbench/reference/gpsr.py`` in float64 on seeded random weights.
    Both compute the same formulas in float64 (the maps by different code,
    the KDE in another order), so the images agree to 1e-10 of the largest
    pixel and the losses, the first gradient and the change over three Adam
    steps to 1e-8 relative: Adam divides by sqrt(v) + 1e-8, which lifts a
    gradient's rounding by up to its first step's size."""
    import sys

    sys.path.insert(0, str(ROOT))
    from portbench.reference import gpsr as reference

    monkeypatch.setattr(kde, "BLOCK", block)
    segment, k1, truth, targets, generator = small_problem(torch.float64, seed=7)
    inputs = reference_inputs(generator, truth, k1)
    optimizer = torch.optim.Adam(generator.parameters(), lr=1e-3)
    step = make_reconstruction_step(segment, {"AREAMQZM3.k1": k1}, generator, optimizer, targets)
    start = {n: p.detach().clone() for n, p in generator.named_parameters()}
    losses, first_images = [], None
    for t in range(3):
        loss, images = step()
        losses.append(float(loss))
        if t == 0:
            first_images = images.clone()
            first = {n: optimizer.state[p]["exp_avg"] / (1 - 0.9)
                     for n, p in generator.named_parameters()}
    cfg = {"lattice": "portbench/lattices/ares_stage3_v1_9.json",
           "cell": ["AREASOLA1", "AREABSCR1"], "energy_ev": 1.073e8,
           "beam": dict(zip(("sigma_x", "sigma_xp", "sigma_y", "sigma_yp", "sigma_s", "sigma_p"),
                            generator.spreads.tolist())),
           "scan": {"element": "AREAMQZM3", "fixed": {"AREAMQZM1": 4.2, "AREAMQZM2": -4.2}},
           "screen": {"name": "AREABSCR1", "binning": BINNING, "kde_bandwidth": BANDWIDTH}}
    want_images, (want_losses, want_first, want_change) = reference.steps(
        cfg, ROOT, inputs, 3, 1e-3, 500)
    assert torch.allclose(first_images, want_images, rtol=0,
                          atol=1e-10 * float(want_images.max()))
    assert losses == pytest.approx(want_losses, rel=1e-8)
    for name, p in generator.named_parameters():
        scale = float(want_first[name].abs().max())
        assert torch.allclose(first[name], want_first[name], rtol=0, atol=1e-8 * scale), name
        change = p.detach() - start[name]
        assert torch.allclose(change, want_change[name], rtol=0, atol=1e-8 * 3e-3), name


def test_the_example_runs_on_the_cpu(capsys):
    losses = example.main(steps=3, num_particles=512, scan=(-10.0, 10.0, 3), binning=BINNING,
                          bandwidth=BANDWIDTH, device="cpu")
    assert len(losses) == 3 and losses[2] < losses[0]
    assert "reconstructed" in capsys.readouterr().out


def test_a_shared_cloud_under_settings_with_a_gradient_takes_the_dense_route(monkeypatch):
    """A ``(N, 7)`` cloud under ``(S,)`` settings of one quadrupole, with a
    gradient: B8's route (forced on here) refuses it, the dense route folds
    the run's ``(S, 7, 7)`` maps and pushes the shared cloud, and the
    gradient reaches the particles, under the host-read guard."""
    from lynx_tpu_torch.accelerator import segment as segment_module
    from lynx_tpu_torch.accelerator.fused import element_map_builder

    monkeypatch.setattr(segment_module, "PARTICLE_PUSH_PATH", True)
    segment = ea_segment(torch.float64)
    segment.AREAMQZM3.k1 = torch.linspace(-10.0, 10.0, S, dtype=torch.float64)
    run = list(segment.elements)[:-1]
    particles = particle_beam(torch.float64).particles.requires_grad_(True)
    beam = ParticleBeam(particles, torch.tensor(1.073e8, dtype=torch.float64))
    builders = [element_map_builder(el) for el in run]
    assert segment_module._choose_route(run, beam, builders, per_setting_push=False) == (None, None)
    with graphs.host_read_guard():
        out = track(segment.subcell("AREASOLA1", "Drift_AREAMCHM1"), beam)[0]
    maps = segment_module.stacked_transfer_map(run, beam.energy)
    assert maps.shape == (S, 7, 7) and out.particles.shape == (S, N, 7)
    assert torch.allclose(out.particles, particles @ maps.transpose(-2, -1), rtol=1e-14)
    (grad,) = torch.autograd.grad(out.particles[..., 0].sum(), particles)
    assert torch.allclose(grad, maps[:, 0, :].sum(0).expand(N, 7), rtol=1e-12)
