"""Six-dimensional GPSR on the port: one step that images several
measurements, each on its own KDE screen (``reconstruction.Measurement``),
at small sizes on the CPU: ARES's dogleg and spectrometer with the two
PolariX structures as ``TransverseDeflectingCavity``, N = 2,048
particles, 2 k1 values x TDS off/on = 4 shared settings, each imaged on
ARSHBSCE1 (dipole off) and ARSHBSCE2 (dipole on), binned 24 (102 x 85).

The step against the benchmark's plain reference ``portbench/reference/
gpsr6d.py`` in float64 (images, losses, first gradient, change over three
Adam steps); the line before the dipole tracked once and each tail to its
own screen; the one-screen call still today's step, bit for bit; and the
refusals."""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

from lynx_tpu_torch import graphs, reconstruction
from lynx_tpu_torch.functional import track
from lynx_tpu_torch.ops import kde
from lynx_tpu_torch.reconstruction import Measurement, make_reconstruction_step

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.loops import gpsr6d as loop  # noqa: E402
from portbench.loops.gpsr import draw_generator, scan_values  # noqa: E402
from portbench.reference import gpsr6d as reference  # noqa: E402

CELL = "ares_gpsr6d.tds_dipole_20"


def config():
    cfg = json.loads((ROOT / "portbench/configs/ares_gpsr6d.json").read_text())
    small = json.loads((ROOT / f"portbench/tests/small/{CELL}.json").read_text())
    cfg.update(small["config"])
    return cfg


def problem(dtype=torch.float64, seed=11):
    """The segment, the generator, the measurements and the reference's
    inputs, from ``seed`` (the truth at ``seed + 1``)."""
    cfg = config()
    weights, z = draw_generator(cfg, torch.Generator().manual_seed(seed), "cpu")
    truth_weights, truth_z = draw_generator(cfg, torch.Generator().manual_seed(seed + 1), "cpu")
    segment = loop.dogleg(cfg, ROOT / cfg["lattice"], "cpu", dtype)
    generator = loop.beam_generator(cfg, weights, z, "cpu", dtype)
    truth = loop.beam_generator(cfg, truth_weights, truth_z, "cpu", dtype)
    k1, voltage = reference.settings(cfg, scan_values(cfg, "cpu"), dtype, "cpu")
    measured = loop.imaged(segment, truth, loop.measurements(cfg, k1, voltage))
    inputs = {"weights": weights, "z": z, "truth_weights": truth_weights, "truth_z": truth_z,
              "k1": scan_values(cfg, "cpu")}
    return cfg, segment, generator, measured, inputs


def test_the_step_against_the_plain_reference():
    """Three steps of the program in float64 against ``reference/gpsr6d.py``
    in float64: the maps by other code (the TDS by a matrix exponential),
    the KDE in another order, so the images agree to 1e-10 of each screen's
    largest pixel and the losses, the first gradient and the change to 1e-8
    relative, as the one-screen step does."""
    cfg, segment, generator, measured, inputs = problem()
    optimizer = torch.optim.Adam(generator.parameters(), lr=1e-3)
    step = make_reconstruction_step(segment, measured, generator, optimizer)
    start = {n: p.detach().clone() for n, p in generator.named_parameters()}
    losses = []
    for t in range(3):
        loss, images = step()
        losses.append(float(loss))
        if t == 0:
            first_images = tuple(i.clone() for i in images)
            first = {n: optimizer.state[p]["exp_avg"] / (1 - 0.9)
                     for n, p in generator.named_parameters()}
    want_images, (want_losses, want_first, want_change) = reference.steps(
        cfg, ROOT, inputs, 3, 1e-3, 500)
    assert [tuple(i.shape) for i in first_images] == [(4, 85, 102)] * 2
    for got, want in zip(first_images, want_images):
        assert torch.allclose(got, want, rtol=0, atol=1e-10 * float(want.max()))
    assert losses == pytest.approx(want_losses, rel=1e-8)
    for name, p in generator.named_parameters():
        scale = float(want_first[name].abs().max())
        assert torch.allclose(first[name], want_first[name], rtol=0, atol=1e-8 * scale), name
        assert torch.allclose(p.detach() - start[name], want_change[name], rtol=0,
                              atol=1e-8 * 3e-3), name


def test_the_measurements_share_the_line_before_the_dipole(monkeypatch):
    """The line up to ARSHMBHO1 is tracked once, on the shared settings;
    each tail from the dipole to its own screen only, the other screen
    passed; the streak and the dispersion show on the screens they should;
    a step renders 4 images on each screen, its KDE's blocks twice one
    screen's."""
    cfg, segment, generator, measured, _ = problem(torch.float32)
    assert reconstruction._shared_point(segment, measured) == [
        e.name for e in segment.flattened().elements].index("ARSHMBHO1")
    tracked = []
    real = reconstruction.track

    def recording(line, beam):
        tracked.append([e.name for e in line.flattened().elements if e.name[:5] != "Drift"])
        return real(line, beam)

    monkeypatch.setattr(reconstruction, "track", recording)
    step = make_reconstruction_step(segment, measured, generator,
                                    torch.optim.Adam(generator.parameters(), lr=1e-3))
    with graphs.host_read_guard():
        loss, images = step()
    head, straight, read_straight, bent, read_bent = tracked
    assert head[0] == "ARDLSOLM1" and head[-1] == "ARSHSOLH1" and "ARDLRXBD2" in head
    assert straight == ["ARSHMBHO1", "ARSHBSCE2"] and read_straight == ["ARSHBSCE1"]
    assert bent == ["ARSHMBHO1"] and read_bent == ["ARSHBSCE2"]
    assert step.images == {"ARSHBSCE1": 4, "ARSHBSCE2": 4}
    assert step.blocks == 2 * 2 * math.ceil(2048 / kde.BLOCK)
    assert torch.isfinite(loss) and len(images) == 2
    straight_images, bent_images = (m.targets for m in measured)

    def spread(image, plane):
        """The beam's rms extent in pixels along ``plane`` (0: x, the
        columns; 1: y, the rows), the KDE's bandwidth taken out."""
        profile = image.sum(-2 if plane == 0 else -1)
        at = torch.arange(profile.shape[-1], dtype=profile.dtype)
        mean = (profile * at).sum(-1) / profile.sum(-1)
        var = (profile * (at - mean[..., None]) ** 2).sum(-1) / profile.sum(-1)
        pixel = segment.ARSHBSCE1.effective_pixel_size[plane]
        return torch.sqrt(var - (cfg["screens"]["kde_bandwidth"] / pixel) ** 2)

    # TDS on (settings 2, 3) against off (0, 1): y spreads; the bend spreads x.
    assert torch.all(spread(straight_images[2:], 1) > 3 * spread(straight_images[:2], 1))
    assert torch.all(spread(bent_images, 0) > 3 * spread(straight_images, 0))


def todays_step(segment, scan_values, generator, optimizer, targets, screen):
    """The one-screen step as it was before several measurements, eagerly."""
    beam = generator.beam()
    images = track(reconstruction._scanned(segment, scan_values), beam)[1][screen]
    loss = torch.mean((images - targets) ** 2)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach(), images.detach()


@pytest.mark.parametrize("graph", [True, False])
def test_the_one_screen_step_is_todays_bit_for_bit(graph):
    from tests.test_torch_gpsr import small_problem

    runs = []
    for new in (True, False):
        segment, k1, _, targets, generator = small_problem(seed=5)
        optimizer = torch.optim.Adam(generator.parameters(), lr=1e-3)
        if new:
            step = make_reconstruction_step(segment, {"AREAMQZM3.k1": k1}, generator, optimizer,
                                            targets, graph=graph)
        else:
            def step():
                return todays_step(segment, {"AREAMQZM3.k1": k1}, generator, optimizer,
                                   targets, "AREABSCR1")
        out = [tuple(t.clone() for t in step()) for _ in range(3)]
        runs.append((out, [p.detach().clone() for p in generator.parameters()]))
        if new:
            assert step.images == {"AREABSCR1": 4}
    (new_out, new_params), (old_out, old_params) = runs
    for (loss, image), (old_loss, old_image) in zip(new_out, old_out):
        assert torch.equal(loss, old_loss) and torch.equal(image, old_image)
    assert all(torch.equal(a, b) for a, b in zip(new_params, old_params))


def test_a_measurement_off_a_kde_screen_is_refused():
    cfg, segment, generator, measured, _ = problem(torch.float32)
    optimizer = torch.optim.Adam(generator.parameters())
    segment.ARSHBSCE2.method = "histogram"
    with pytest.raises(ValueError, match="ARSHBSCE2"):
        make_reconstruction_step(segment, measured, generator, optimizer)
    segment.ARSHBSCE2.method = "kde"
    wrong = [measured[0], Measurement(measured[1].scan_values, "ARSHBSCE3", measured[1].targets)]
    with pytest.raises(ValueError, match="ARSHBSCE3"):
        make_reconstruction_step(segment, wrong, generator, optimizer)
    unknown = [measured[0], Measurement(dict(measured[1].scan_values, **{"NOPE.k1": 1.0}),
                                        "ARSHBSCE2", measured[1].targets)]
    with pytest.raises(ValueError, match="NOPE"):
        make_reconstruction_step(segment, unknown, generator, optimizer)
