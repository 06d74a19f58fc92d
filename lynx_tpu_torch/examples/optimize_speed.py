"""Speed-optimisation walkthrough on a 1058-element lattice (counterpart of
``examples/optimize_speed.py``).

A long FODO lattice (150 x [Q, D, Q, D, M, Q, D] + steerers), tracked (1)
as built, (2) without its inactive markers and with its inactive elements
turned into drifts, (3) with the transfer maps merged ahead of time, and
(4) merged and batched over 1000 settings.  Each stage is timed with
``profiling.benchmark``: CUDA events on the card, the host clock on the
CPU.  The JAX example's CPU numbers are not targets for the card.

Run: python -m lynx_tpu_torch.examples.optimize_speed [--cells 150]
[--batch 1000] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch.models.fodo import fodo_lattice
from lynx_tpu_torch.profiling import benchmark
from lynx_tpu_torch.utils import resolve_device


def build_lattice(num_cells: int = 150, dtype: torch.dtype = torch.float32,
                  device=None) -> ltt.Segment:
    return fodo_lattice(num_cells=num_cells, dtype=dtype, device=device)


def stages(lattice: ltt.Segment, beam: ltt.ParameterBeam, batch: int) -> list:
    """The four stages as ``(label, segment, beam)``."""
    no_markers = lattice.without_inactive_markers()
    as_drifts = no_markers.inactive_elements_as_drifts()
    merged = as_drifts.transfer_maps_merged(incoming_beam=beam)
    return [
        ("unoptimized track", lattice, beam),
        ("inactive markers removed, inactive as drifts", as_drifts, beam),
        ("transfer_maps_merged", merged, beam),
        (f"merged + broadcast(({batch},))", merged.broadcast((batch,)), beam.broadcast((batch,))),
    ]


def main(num_cells: int = 150, batch: int = 1000, device=None,
         dtype: torch.dtype = torch.float32, iters: int = 20) -> list:
    """Time the four stages; print ms per track, and at stage 4 us a sample
    and tracks/s.  Return ``[(label, seconds, outgoing beam)]``."""
    device = resolve_device(device)
    lattice = build_lattice(num_cells, dtype, device)
    print(f"lattice: {len(lattice.elements)} elements")
    beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1.75e-4], dtype=dtype), energy=torch.tensor([1e8], dtype=dtype),
        dtype=dtype, device=device,
    )

    def track(segment, incoming):
        return segment.track(incoming)._mu

    results = []
    for label, segment, incoming in stages(lattice, beam, batch):
        if label == "transfer_maps_merged":
            print(f"merged lattice: {len(segment.elements)} elements")
        seconds = benchmark(track, segment, incoming, iters=iters)
        print(f"{label:45s} {seconds * 1e3:10.3f} ms")
        results.append((label, seconds, segment.track(incoming)))
    seconds = results[-1][1]
    print(f"{'':45s} {seconds / batch * 1e6:10.3f} us/sample  ({batch / seconds:,.0f} tracks/s)")
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cells", type=int, default=150)
    parser.add_argument("--batch", type=int, default=1000)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args()
    main(args.cells, args.batch, args.device)
