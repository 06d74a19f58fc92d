"""Generative phase-space reconstruction (GPSR) on the ARES EA: recover a
beam's phase space from a quadrupole scan's screen images (Roussel et al.,
PRL 130, 145001, 2023).

A "measured" beam is a random generator network's (the truth); its images
on AREABSCR1 (binned 8: 306 x 255 pixels, the KDE reading) under 16 values
of AREAMQZM3's k1 over [-10, 10] 1/m^2 are the targets.  A second generator
is trained by Adam through the track and the KDE until its images match;
its beam's sizes are printed beside the truth's.

Run: python -m lynx_tpu_torch.examples.phase_space_reconstruction [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from lynx_tpu_torch.functional import track
from lynx_tpu_torch.models import ares_ea_segment
from lynx_tpu_torch.reconstruction import BeamGenerator, make_reconstruction_step
from lynx_tpu_torch.utils import resolve_device

BINNING = 8  # 306 x 255 pixels
BANDWIDTH = 2e-5  # m: one binned pixel's height
SCAN = (-10.0, 10.0, 16)  # AREAMQZM3's k1 (1/m^2): low, high, count


def make_segment(device=None, binning: int = BINNING, bandwidth: float = BANDWIDTH):
    """The ARES EA at the flagship AREAMQZM1/2 (4.2, -4.2), AREABSCR1 active
    with the KDE reading."""
    segment = ares_ea_segment(device=device)
    device = segment.AREAMQZM1.k1.device
    segment.AREAMQZM1.k1 = torch.tensor(4.2, device=device)
    segment.AREAMQZM2.k1 = torch.tensor(-4.2, device=device)
    screen = segment.AREABSCR1
    screen.is_active, screen.binning = True, binning
    screen.method, screen.kde_bandwidth = "kde", bandwidth
    return segment


def main(steps: int = 500, num_particles: int = 100_000, scan=SCAN, binning: int = BINNING,
         bandwidth: float = BANDWIDTH, seed: int = 0, device=None, graph: bool = True):
    """Train for ``steps`` steps; print the loss every 100 and the beam's
    sizes at the end; return the ``(steps,)`` losses as host floats."""
    device = resolve_device(device)
    segment = make_segment(device, binning, bandwidth)
    low, high, count = scan
    k1 = torch.linspace(low, high, count, device=device)
    truth = BeamGenerator(num_particles, generator=torch.Generator(device).manual_seed(seed + 1),
                          device=device)
    with torch.no_grad():
        segment.AREAMQZM3.k1 = k1
        targets = track(segment, truth.beam())[1]["AREABSCR1"]
    generator = BeamGenerator(num_particles, generator=torch.Generator(device).manual_seed(seed),
                              device=device)
    optimizer = torch.optim.Adam(generator.parameters(), lr=1e-3)
    reconstruct = make_reconstruction_step(segment, {"AREAMQZM3.k1": k1}, generator, optimizer,
                                           targets, graph=graph)
    losses = []
    for step in range(steps):
        loss, _ = reconstruct()
        losses.append(loss.clone())
        if step % 100 == 0 or step == steps - 1:
            print(f"step {step:5d}  loss {float(loss):.6e}")
    with torch.no_grad():
        for name, beam in (("truth", truth.beam()), ("reconstructed", generator.beam())):
            print(f"{name:13s} sigma_x {float(beam.sigma_x):.4e} m  sigma_xp"
                  f" {float(beam.sigma_xp):.4e}  sigma_y {float(beam.sigma_y):.4e} m  sigma_yp"
                  f" {float(beam.sigma_yp):.4e}")
    return [float(x) for x in losses]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--particles", type=int, default=100_000)
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    main(args.steps, args.particles, device=args.device)
