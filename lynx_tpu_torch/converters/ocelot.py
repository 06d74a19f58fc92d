"""Ocelot lattice converter (counterpart of ``lynx_tpu.converters.ocelot``).

Duck-typed by class name, so real Ocelot cells and cells built from
:mod:`lynx_tpu_torch.converters.ocelot_shim` both convert, and no
``ocelot`` package is needed.
"""

from __future__ import annotations

import torch

from lynx_tpu_torch import accelerator as acc
from lynx_tpu_torch.log import get_logger
from lynx_tpu_torch.utils import resolve_device

logger = get_logger("converters.ocelot")


def _class_names(element) -> list:
    return [klass.__name__ for klass in type(element).__mro__]


def ocelot2lynx(element, warnings: bool = True, dtype: torch.dtype = torch.float32, device=None):
    """Translate one Ocelot element to the port's element, on the card
    unless ``device`` says otherwise.

    Unsupported elements become drifts; a ``Monitor`` whose id holds "BSC"
    becomes a screen of ARES's default camera, one whose id holds "BPM" a
    BPM, any other monitor a marker.
    """
    device = resolve_device(device)
    names = _class_names(element)
    kw = dict(name=element.id, dtype=dtype, device=device)

    def arr(value) -> torch.Tensor:
        return torch.tensor([value], dtype=dtype, device=device)

    if "Quadrupole" in names:
        return acc.Quadrupole(length=arr(element.l), k1=arr(element.k1),
                              tilt=arr(getattr(element, "tilt", 0.0)), **kw)
    if "Solenoid" in names:
        return acc.Solenoid(length=arr(element.l), k=arr(element.k), **kw)
    if "Hcor" in names:
        return acc.HorizontalCorrector(length=arr(element.l), angle=arr(element.angle), **kw)
    if "Vcor" in names:
        return acc.VerticalCorrector(length=arr(element.l), angle=arr(element.angle), **kw)
    if "RBend" in names or "Bend" in names or "SBend" in names:
        # Ocelot's RBend edge angles include the angle / 2 that the port's
        # RBend adds again, so it is taken off here (a round trip is exact).
        rbend = "RBend" in names
        shift = element.angle / 2 if rbend else 0.0
        return (acc.RBend if rbend else acc.Dipole)(
            length=arr(element.l),
            angle=arr(element.angle),
            e1=arr(element.e1 - shift),
            e2=arr(element.e2 - shift),
            tilt=arr(element.tilt),
            fringe_integral=arr(element.fint),
            fringe_integral_exit=arr(element.fintx),
            gap=arr(element.gap),
            **kw,
        )
    if "Cavity" in names or "TDCavity" in names:
        return acc.Cavity(
            length=arr(element.l),
            voltage=arr(element.v * 1e9),  # Ocelot stores GV
            frequency=arr(element.freq),
            phase=arr(element.phi),
            **kw,
        )
    if "Monitor" in names and "BSC" in (element.id or ""):
        if warnings:
            logger.warning("Diagnostic screen was converted with default screen properties.")
        return acc.Screen(resolution=(2448, 2040),
                          pixel_size=torch.tensor([3.5488e-6, 2.5003e-6], dtype=dtype), **kw)
    if "Monitor" in names and "BPM" in (element.id or ""):
        return acc.BPM(**kw)
    if "Marker" in names or "Monitor" in names:
        return acc.Marker(**kw)
    if "Undulator" in names:
        return acc.Undulator(length=arr(element.l), **kw)
    if "Aperture" in names:
        shape_translation = {"rect": "rectangular", "elip": "elliptical"}
        return acc.Aperture(x_max=arr(element.xmax), y_max=arr(element.ymax),
                            shape=shape_translation[element.type], is_active=True, **kw)
    if "Drift" in names:
        return acc.Drift(length=arr(element.l), **kw)

    if warnings:
        logger.warning(
            "Unknown element %s of type %s, replacing with drift section.",
            element.id, type(element),
        )
    return acc.Drift(length=arr(getattr(element, "l", 0.0)), **kw)


def subcell_of_ocelot(cell: list, start: str, end: str) -> list:
    """The subcell ``[start, end]`` of an Ocelot cell."""
    subcell = []
    is_in_subcell = False
    for el in cell:
        if el.id == start:
            is_in_subcell = True
        if is_in_subcell:
            subcell.append(el)
        if el.id == end:
            break
    return subcell
