"""The GPSR cell ``ea_gpsr.quadscan_16`` and the EA tuner cell
``ares_ea.tune_100k`` at small sizes on the CPU: each runs correct through
``run_cell``, and the GPSR cell's comparison fails for each fault planted in
the program (half of the particles in the KDE, a bandwidth off by 2x, a
stale step) and for the control (the reference in TF32), as for the
reference's own planted faults.

The small sizes are ``portbench/tests/small/<cell>.json``:
2,048 particles, 4 settings, a 48 x 40 image (AREABSCR1 binned 51), the
bandwidth one binned pixel's height; 16 settings of the EA tuner."""

import pytest
import torch

from conftest import ROOT, SMALL
from portbench import compare, harness
from portbench.run import run_cell

GPSR = "ea_gpsr.quadscan_16"


def run(name, seed=2**31 + 13):
    return run_cell(ROOT, name, seed, 0.3, 0, device="cpu", overrides=SMALL[name],
                    log=lambda message: None)


@pytest.mark.parametrize("name", [GPSR, "ares_ea.tune_100k"])
def test_the_new_cells_run_correct_on_the_cpu(name):
    result = run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"tune_step_ms", "setup_s"}


def half_of_the_particles(monkeypatch):
    from lynx_tpu_torch.accelerator import screen

    real = screen.kde_sums

    def kde_sums(x, y, weights, *args, **kwargs):
        half = x.shape[-1] // 2
        return real(x[..., :half], y[..., :half],
                    None if weights is None else weights[..., :half], *args, **kwargs)

    monkeypatch.setattr(screen, "kde_sums", kde_sums)


def twice_the_bandwidth(monkeypatch):
    from lynx_tpu_torch.accelerator import screen

    real = screen.kde_sums
    monkeypatch.setattr(screen, "kde_sums", lambda x, y, w, xc, yc, h, **kwargs:
                        real(x, y, w, xc, yc, 2 * h, **kwargs))


def a_stale_step(monkeypatch):
    from lynx_tpu_torch import reconstruction

    monkeypatch.setattr(reconstruction, "optimizer_step", lambda optimizer: None)


@pytest.mark.parametrize("fault", [half_of_the_particles, twice_the_bandwidth, a_stale_step])
def test_a_fault_planted_in_the_program_fails(fault, monkeypatch):
    fault(monkeypatch)
    result = run(GPSR)
    assert not result["correct"], result["checks"]


def test_a_stale_step_reads_a_change_gap_of_one(monkeypatch):
    a_stale_step(monkeypatch)
    assert run(GPSR)["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("kind", ["tf32", "half_batch", "bandwidth", "stale"])
def test_the_control_and_the_reference_faults_fail_the_limits(kind):
    cell = harness.find_cell(ROOT, GPSR, SMALL[GPSR])
    numbers, _ = harness.control(cell, 2**31 + 9, "cpu", kind)
    correct, checks = compare.verdict(numbers, cell.limits)
    assert not correct, checks


def test_the_reference_images_are_normalised_and_in_camera_orientation():
    """A particle at (+x, +y) lights the top right of the reference's image."""
    from portbench.reference import gpsr

    cell = harness.find_cell(ROOT, GPSR, SMALL[GPSR])
    scan = gpsr.Scan(cell.cfg, ROOT, torch.float64, "cpu")
    scan.line.total = lambda k1: torch.eye(7, dtype=torch.float64).expand(len(k1), 7, 7)
    particle = torch.tensor([[2e-3, 0, 1.5e-3, 0, 0, 0, 1]], dtype=torch.float64)
    image = gpsr.images(scan, particle, torch.zeros(1, dtype=torch.float64), 1)[0]
    assert float(image.sum()) == pytest.approx(1.0)
    row, column = divmod(int(image.argmax()), image.shape[1])
    assert row < image.shape[0] // 2 and column > image.shape[1] // 2


def test_work_counts_the_three_kde_products():
    cell = harness.find_cell(ROOT, GPSR)
    loop = harness.make_loop(cell, 1, "cpu")
    loop.scan_size, loop.image_shape = 16, (255, 306)
    n_bytes, flops = loop.work()
    assert flops == 3 * 2 * 16 * 100_000 * 255 * 306  # 7.49e11
    assert flops / 67e12 == pytest.approx(11.18e-3, rel=1e-3)
    assert n_bytes == 4 * (2 * 100_000 * 7 + 2 * 16 * 255 * 306)
