"""First steps with the port (counterpart of ``examples/simple.py``).

Build a small lattice, track a particle beam through it, read a BPM, change
a magnet and observe the change.

Run: python -m lynx_tpu_torch.examples.simple [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch.utils import resolve_device


def main(num_particles: int = 100_000, device=None):
    """Track, read BPM13SMATCH, kick with H10SMATCH and read again; return
    ``(outgoing_sigma_x, reading, reading_after_kick)``."""
    like = dict(device=resolve_device(device))

    def length(value):
        return torch.tensor([value], **like)

    segment = ltt.Segment(
        elements=[
            ltt.BPM(name="BPM1SMATCH", **like),
            ltt.Drift(length=length(1.0)),
            ltt.BPM(name="BPM6SMATCH", **like),
            ltt.Drift(length=length(1.0)),
            ltt.VerticalCorrector(length=length(0.3), name="V7SMATCH"),
            ltt.Drift(length=length(0.2)),
            ltt.HorizontalCorrector(length=length(0.3), name="H10SMATCH"),
            ltt.Drift(length=length(7.0)),
            ltt.HorizontalCorrector(length=length(0.3), name="H12SMATCH"),
            ltt.Drift(length=length(0.05)),
            ltt.BPM(name="BPM13SMATCH", is_active=True, **like),
        ]
    )

    beam = ltt.ParticleBeam.from_parameters(
        num_particles=num_particles, sigma_x=torch.tensor([1.75e-4]),
        sigma_y=torch.tensor([1.75e-4]), energy=torch.tensor([1e8]),
        generator=torch.Generator(**like).manual_seed(0), **like,
    )

    outgoing = segment.track(beam)
    sigma_x = float(outgoing.sigma_x[0])
    reading = segment.BPM13SMATCH.reading.ravel().clone()
    print("outgoing sigma_x:", sigma_x)
    print("BPM13 reading:", reading.tolist())

    # Kick the beam with a corrector and watch the BPM move.
    segment.H10SMATCH.angle = torch.tensor([2e-4], **like)
    segment.track(beam)
    kicked = segment.BPM13SMATCH.reading.ravel().clone()
    print("BPM13 after kick:", kicked.tolist())
    return sigma_x, reading, kicked


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(device=parser.parse_args().device)
