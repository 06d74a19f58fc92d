"""NX Tables converter (counterpart of ``lynx_tpu.converters.nxtables``).

DESY's device database format, as used at ARES: each device CLASS code maps
to an element (with ARES's camera geometries and magnet lengths), the
devices are sorted by their ``Z_beam`` position, the gaps between them
become drifts named ``DRIFT_<prev>_<next>``, and overlapping devices are
refused.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from lynx_tpu_torch import accelerator as acc
from lynx_tpu_torch.utils import resolve_device

#: Device classes with no beam-dynamics meaning (pumps, valves, misc.).
IGNORE_CLASSES = frozenset(
    {
        "RSBG", "MSOB", "MSOH", "MSOG", "VVAG", "BSCL", "MIRA", "BAML",
        "SCRL", "TEMG", "FCNG", "SOLE", "EOLE", "MSOL", "BELS", "VVAF",
        "MIRM", "SCRY", "FPSA", "VPUL", "SOLC", "SCRE", "SOLX", "ICTB",
        "BSCS",
    }
)

#: Device classes represented as plain markers.
MARKER_CLASSES = frozenset(
    {
        "SOLG", "BCMG", "EOLG", "SOLS", "EOLS", "SOLA", "EOLA", "SOLT",
        "BSTB", "TORF", "EOLT", "SOLO", "EOLO", "SOLB", "EOLB", "ECHA",
        "MKBB", "MKBE", "MKPM", "EOLC", "SOLM", "EOLM", "SOLH", "BSCD",
        "STDE", "ECHS", "EOLH", "WINA", "LINA", "EOLX",
    }
)


def _t(*values) -> torch.Tensor:
    return torch.tensor(values, device="cpu")


def _screen(resolution, pixel_size) -> Callable[[str], acc.Element]:
    def build(name: str):
        return acc.Screen(name=name, resolution=resolution, pixel_size=_t(*pixel_size),
                          binning=1, device="cpu")

    return build


def _aperture(shape: str) -> Callable[[str], acc.Element]:
    def build(name: str):
        return acc.Aperture(name=name, x_max=_t(math.inf), y_max=_t(math.inf), shape=shape,
                            device="cpu")

    return build


def _mcxg(name: str) -> acc.Element:
    """Combined H/V gun corrector coil pair."""
    if name[6] != "X":
        raise ValueError(f"MCXG device {name} has no X at its seventh character")
    return acc.Segment(
        elements=[
            acc.HorizontalCorrector(name=name[:6] + "H" + name[7:], length=_t(5e-05)),
            acc.VerticalCorrector(name=name[:6] + "V" + name[7:], length=_t(5e-05)),
        ],
        name=name,
    )


#: CLASS code -> element factory (ARES hardware geometry); every element is
#: built on the host in float32, as the JAX package builds it.
CLASS_REGISTRY: Dict[str, Callable[[str], acc.Element]] = {
    "MCXG": _mcxg,
    "BSCX": _screen((2464, 2056), [0.00343e-3, 0.00247e-3]),
    "BSCR": _screen((2448, 2040), [3.5488e-6, 2.5003e-6]),
    "BSCM": _screen((2448, 2040), [3.5488e-6, 2.5003e-6]),
    "BSCO": _screen((2448, 2040), [3.5488e-6, 2.5003e-6]),
    "BSCA": _screen((2448, 2040), [3.5488e-6, 2.5003e-6]),
    "BSCE": _screen((2464, 2056), [0.00998e-3, 0.00715e-3]),
    "SCRD": _screen((2464, 2056), [0.00998e-3, 0.00715e-3]),
    "BPMG": lambda name: acc.BPM(name=name, device="cpu"),
    "BPML": lambda name: acc.BPM(name=name, device="cpu"),
    "SLHG": _aperture("elliptical"),
    "SLHB": _aperture("rectangular"),
    "SLHS": _aperture("rectangular"),
    "MCHM": lambda name: acc.HorizontalCorrector(name=name, length=_t(0.02)),
    "MCVM": lambda name: acc.VerticalCorrector(name=name, length=_t(0.02)),
    "MBHL": lambda name: acc.Dipole(name=name, length=_t(0.322)),
    "MBHB": lambda name: acc.Dipole(name=name, length=_t(0.22)),
    "MBHO": lambda name: acc.Dipole(
        name=name,
        length=_t(0.43852543421396856),
        angle=_t(0.8203047484373349),
        e2=_t(-0.7504915783575616),
    ),
    "MQZM": lambda name: acc.Quadrupole(name=name, length=_t(0.122)),
    "RSBL": lambda name: acc.Cavity(
        name=name, length=_t(4.139), frequency=_t(2.998e9), voltage=_t(76e6)
    ),
    "RXBD": lambda name: acc.Cavity(
        name=name, length=_t(1.0), frequency=_t(11.9952e9), voltage=_t(0.0)
    ),
    "UNDA": lambda name: acc.Undulator(name=name, length=_t(0.25)),
}


def translate_element(row: list, header: list) -> Optional[dict]:
    """Translate one NX Tables row; ``None`` for irrelevant devices."""
    class_name = row[header.index("CLASS")]
    name = row[header.index("NAME")]
    s_position = float(row[header.index("Z_beam")])

    if class_name in IGNORE_CLASSES:
        return None
    if class_name in MARKER_CLASSES:
        element = acc.Marker(name=name, device="cpu")
    elif class_name in CLASS_REGISTRY:
        element = CLASS_REGISTRY[class_name](name)
    else:
        raise ValueError(f"Encountered unknown class {class_name} for element {name}")
    return {"element": element, "s_position": s_position}


def read_nx_tables(
    filepath: Path, dtype: torch.dtype = torch.float32, device=None
) -> acc.Segment:
    """Read an NX Tables CSV into a flat Segment with gap drifts, on the card
    unless ``device`` says otherwise.  The values are set in float32 on the
    host, as the JAX package sets them, then cast to ``dtype``."""
    device = resolve_device(device)
    with open(filepath, "r") as csvfile:
        rows = list(csv.reader(csvfile, delimiter=","))
    header, rows = rows[0], rows[1:]

    translated = [translate_element(row, header) for row in rows]
    ordered = sorted(
        (entry for entry in translated if entry is not None),
        key=lambda entry: entry["s_position"],
    )

    def length_of(element) -> float:
        return float(torch.max(element.length)) if hasattr(element, "length") else 0.0

    elements = [ordered[0]["element"]]
    for previous, current in zip(ordered[:-1], ordered[1:]):
        drift_length = (
            current["s_position"]
            - previous["s_position"]
            - length_of(previous["element"]) / 2
            - length_of(current["element"]) / 2
        )
        if drift_length < 0.0:
            raise ValueError(
                f"Elements {previous['element'].name} and {current['element'].name}"
                f" overlap by {drift_length}."
            )
        if drift_length > 0.0:
            elements.append(
                acc.Drift(
                    name=f"DRIFT_{previous['element'].name}_{current['element'].name}",
                    length=_t(drift_length),
                )
            )
        elements.append(current["element"])

    segment = acc.Segment(elements=elements, name=Path(filepath).stem).flattened()
    return segment.to(device=device, dtype=dtype)
