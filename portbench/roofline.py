"""The least time a call's work needs on one NVIDIA H100: bytes over its
memory bandwidth or operations over its float32 rate, the larger, with the
work counted from the configuration's shapes (inputs read once, outputs
written once, operations on the maps' supports), whatever kernels the
program runs for it.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the full 700 W): 3.35 TB/s of
HBM3, 67 TFLOP/s in float32 outside the tensor cores.  A card set below
700 W reaches less; each run prints the card's power limit beside them."""

from __future__ import annotations

import torch

from portbench.reference import lattice as lat

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def support(m):
    """The map's structurally non-zero entries: a boolean ``(7, 7)``."""
    return (m.reshape(-1, 7, 7) != 0).any(dim=0)


def sandwich_flops(s):
    """Multiply-adds of ``mu' = R mu`` and ``cov' = R cov R^T`` on the
    support ``s`` of ``R``, ``cov`` a dense symmetric 6 x 6 block (a central
    covariance has no homogeneous row): two products of ``R``'s 6 x 6
    non-zeros with 6 columns each, and ``R mu`` on all 7 x 7."""
    return 2 * 6 * 2 * int(s[:6, :6].sum()) + 2 * int(s.sum())


def tune_work(line, batch, n_fields, value_bytes=4):
    """``(bytes, flops)`` of one tuner step on ``batch`` settings.

    Bytes: the beam's moments read once (``7 + 49`` values a setting), and
    the fields and Adam's two moments read and written once.  Operations:
    each map the line applies, at its support (the untuned elements between
    two tuned ones as one map), in the forward pass, and twice that in the
    backward pass (a sandwich's vector-Jacobian product is two sandwiches).
    The maps' own building and Adam's arithmetic are left out."""
    generator = torch.Generator().manual_seed(0)
    settings = 0.5 + torch.rand((2, n_fields), generator=generator, dtype=torch.float64)
    forward = sum(sandwich_flops(support(m)) for m in line.maps(settings))
    n_bytes = value_bytes * batch * ((7 + 49) + 2 * 3 * n_fields)
    return n_bytes, 3 * forward * batch


def read_work(cfg, lattice_path, batch, value_bytes=4):
    """``(bytes, flops)`` of one screen read of ``batch`` settings: the
    particles ``(N, 7)`` read once and the image written once; the push of
    x and y through the line's one map at its support, and the two bin
    indices (a subtraction, a product and a floor each)."""
    fields = next(f for name, _, f in lat.cell(lat.load(lattice_path), *cfg["cell"])
                  if name == cfg["screen_read"]["screen"])
    width, height = (int(v) for v in fields["resolution"])
    n = cfg["particles"]
    n_bytes = value_bytes * batch * (n * 7 + width * height)
    flops = batch * n * (2 * 2 * 7 + 2 * 3)
    return n_bytes, flops
