"""Parameterised FODO lattices (counterpart of ``lynx_tpu.models.fodo``).

The reference's long-lattice benchmark: [HCor, D, VCor, D] + 150 x [Q, D, Q,
D, M, Q, D] + [HCor, D, VCor, D] = 1058 elements, quadrupoles of L = 0.1 m
and k1 = +-4.2, cell drifts of 0.2 m and steerer drifts of 0.3 m; and one
FODO cell.
"""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator import (
    Drift,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    Segment,
    VerticalCorrector,
)
from lynx_tpu_torch.utils import resolve_device

__all__ = ["fodo_cell", "fodo_lattice"]


def fodo_cell(
    k1: float = 4.2,
    quad_length: float = 0.1,
    drift_length: float = 0.2,
    name: str = "fodo",
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Segment:
    """One focusing-drift-defocusing-drift cell, with the inert marker and
    the quadrupole at k1 = 0 of the reference benchmark's cell; on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)

    def arr(value):
        return torch.tensor([value], dtype=dtype, device=device)

    kw = dict(dtype=dtype, device=device)
    return Segment(
        [
            Quadrupole(arr(quad_length), k1=arr(k1), name=f"{name}_qf", **kw),
            Drift(arr(drift_length), name=f"{name}_d1", **kw),
            Quadrupole(arr(quad_length), k1=arr(-k1), name=f"{name}_qd", **kw),
            Drift(arr(drift_length), name=f"{name}_d2", **kw),
            Marker(name=f"{name}_m", **kw),
            Quadrupole(arr(quad_length), k1=arr(0.0), name=f"{name}_qo", **kw),
            Drift(arr(drift_length), name=f"{name}_d3", **kw),
        ],
        name=name,
    )


def _steerer_block(prefix: str, dtype, device) -> list:
    def arr(value):
        return torch.tensor([value], dtype=dtype, device=device)

    kw = dict(dtype=dtype, device=device)
    return [
        HorizontalCorrector(arr(0.1), angle=arr(0.0), name=f"HCOR_{prefix}", **kw),
        Drift(arr(0.3), name=f"d_hcor_{prefix}", **kw),
        VerticalCorrector(arr(0.1), angle=arr(0.0), name=f"VCOR_{prefix}", **kw),
        Drift(arr(0.3), name=f"d_vcor_{prefix}", **kw),
    ]


def fodo_lattice(
    num_cells: int = 150,
    k1: float = 4.2,
    with_steerers: bool = True,
    name: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Segment:
    """``num_cells`` FODO cells in one flat segment, bracketed by the
    reference benchmark's steerer blocks: 1058 elements at 150 cells.  On
    the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    elements = []
    if with_steerers:
        elements += _steerer_block("1", dtype, device)
    for cell in range(num_cells):
        elements += list(fodo_cell(k1=k1, name=f"c{cell}", dtype=dtype, device=device).elements)
    if with_steerers:
        elements += _steerer_block("2", dtype, device)
    return Segment(elements, name=name or f"fodo_{num_cells}")
