"""The six-dimensional GPSR cell ``ares_gpsr6d.tds_dipole_20`` at its small
size on the CPU (``portbench/tests/small/``: 2,048 particles, 2 k1 values x
TDS off/on, both screens binned 24): its comparison fails for each fault
planted in the program (the TDS without its energy row, the TDS at 0 V
where it should be on, the screens' settings swapped, half of the particles
in the KDE, a stale step) and for the control (the reference in TF32) and
the reference's own planted faults; and ``work()`` counts B9's products on
both screens' images."""

import pytest
import torch

from conftest import ROOT, SMALL
from portbench import compare, harness
from portbench.run import run_cell

CELL = "ares_gpsr6d.tds_dipole_20"


def run(seed=2**31 + 21):
    return run_cell(ROOT, CELL, seed, 0.3, 0, device="cpu", overrides=SMALL[CELL],
                    log=lambda message: None)


def the_tds_without_its_p_row(monkeypatch):
    from lynx_tpu_torch.accelerator import TransverseDeflectingCavity

    real = TransverseDeflectingCavity.transfer_map

    def transfer_map(self, energy):
        m = real(self, energy).clone()
        m[..., 5, :] = torch.eye(7, dtype=m.dtype)[5]
        return m

    monkeypatch.setattr(TransverseDeflectingCavity, "transfer_map", transfer_map)


def the_tds_at_zero_volts(monkeypatch):
    from lynx_tpu_torch.accelerator import TransverseDeflectingCavity

    real = TransverseDeflectingCavity.transfer_map
    monkeypatch.setattr(TransverseDeflectingCavity, "transfer_map",
                        lambda self, energy: real(self.replace(voltage=0 * self.voltage), energy))


def the_screens_settings_swapped(monkeypatch):
    from lynx_tpu_torch import reconstruction

    real = reconstruction._images

    def images(segment, measurements, beam, split):
        swapped = [m._replace(scan_values=other.scan_values)
                   for m, other in zip(measurements, measurements[::-1])]
        return real(segment, swapped, beam, split)

    monkeypatch.setattr(reconstruction, "_images", images)


def half_of_the_particles(monkeypatch):
    from lynx_tpu_torch.accelerator import screen

    real = screen.kde_sums

    def kde_sums(x, y, weights, *args, **kwargs):
        half = x.shape[-1] // 2
        return real(x[..., :half], y[..., :half],
                    None if weights is None else weights[..., :half], *args, **kwargs)

    monkeypatch.setattr(screen, "kde_sums", kde_sums)


def a_stale_step(monkeypatch):
    from lynx_tpu_torch import reconstruction

    monkeypatch.setattr(reconstruction, "optimizer_step", lambda optimizer: None)


@pytest.mark.parametrize("fault", [the_tds_without_its_p_row, the_tds_at_zero_volts,
                                   the_screens_settings_swapped, half_of_the_particles,
                                   a_stale_step])
def test_a_fault_planted_in_the_program_fails(fault, monkeypatch):
    fault(monkeypatch)
    result = run()
    assert not result["correct"], result["checks"]


def test_the_program_runs_correct_and_a_stale_step_reads_a_change_gap_of_one(monkeypatch):
    assert run()["correct"]
    a_stale_step(monkeypatch)
    assert run()["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("kind", ["tf32", "half_batch", "stale", "no_p_row", "swapped"])
def test_the_control_and_the_reference_faults_fail_the_limits(kind):
    cell = harness.find_cell(ROOT, CELL, SMALL[CELL])
    numbers, _ = harness.control(cell, 2**31 + 9, "cpu", kind)
    correct, checks = compare.verdict(numbers, cell.limits)
    assert not correct, checks


def test_work_counts_the_three_kde_products_on_both_screens():
    cell = harness.find_cell(ROOT, CELL)
    loop = harness.make_loop(cell, 1, "cpu")
    loop.image_shapes = [(10, 255, 306), (10, 255, 306)]
    n_bytes, flops = loop.work()
    assert flops == 3 * 2 * 20 * 100_000 * 255 * 306  # 9.36e11, 20/16 of ea_gpsr's
    assert n_bytes == 4 * (2 * 100_000 * 7 + 2 * 20 * 255 * 306)
