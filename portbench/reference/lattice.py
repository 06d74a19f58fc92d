"""Plain linear optics of a LatticeJSON lattice: the 7x7 transfer map of
each element kind the ARES lattice holds, written from the formulas (Ocelot's
``uni_matrix`` for magnets and bends, thin-wedge edges, the solenoid's
rotating frame), with no code of the program under test.

Maps act on ``(x, x', y, y', s, p, 1)``.  Every function takes plain tensors
and returns ``(..., 7, 7)`` in their dtype.  The energy is fixed: the ARES
file's cavities have zero voltage, where a cavity's map is the drift's
(``cavity_map`` refuses any other voltage).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from portbench.reference.precision import matmul

# m_e c^2 / e in eV, from the CODATA 2018 values.
REST_ENERGY_EV = 9.1093837015e-31 * 299792458.0**2 / 1.602176634e-19

IDENTITY_KINDS = ("Marker", "BPM", "Aperture", "Screen")


def load(path, lattice="ares"):
    """``[(name, kind, fields)]`` of the lattice's elements in order, read from
    a LatticeJSON file (each field as the file's number or list)."""
    data = json.loads(Path(path).read_text())
    elements = data["elements"]
    return [(name, *elements[name]) for name in data["lattices"][lattice]]


def cell(elements, first, last):
    """The elements from ``first`` to ``last``, both included."""
    names = [name for name, _, _ in elements]
    return elements[names.index(first): names.index(last) + 1]


def scalar(fields, key, default=0.0):
    value = fields.get(key, default)
    while isinstance(value, list):
        value = value[0]
    return float(value)


def matrix(entries, shape, dtype, device):
    """Identity plus ``entries`` ``{(i, j): tensor}``, broadcast to ``shape``."""
    zero = torch.zeros(shape, dtype=dtype, device=device)
    one = torch.ones(shape, dtype=dtype, device=device)
    rows = []
    for i in range(7):
        row = [torch.broadcast_to(torch.as_tensor(entries[(i, j)], dtype=dtype, device=device),
                                  shape) if (i, j) in entries else (one if i == j else zero)
               for j in range(7)]
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def relativistic(energy):
    """``(1 / gamma^2, beta)`` of an electron of ``energy`` eV."""
    igamma2 = (REST_ENERGY_EV / energy) ** 2
    return igamma2, math.sqrt(1.0 - igamma2)


def cos_sinc(k2, length):
    """``(cos(k L), sin(k L) / k)`` for ``k = sqrt(k2)``; the hyperbolic
    forms for ``k2 < 0`` and the drift's ``(1, L)`` for ``k2 = 0``."""
    k = torch.sqrt(torch.abs(k2))
    arg = k * length
    safe = torch.where(k == 0, torch.ones_like(k), k)
    c = torch.where(k2 >= 0, torch.cos(arg), torch.cosh(arg))
    s = torch.where(k2 >= 0, torch.sin(arg), torch.sinh(arg)) / safe
    return torch.where(k == 0, torch.ones_like(c), c), torch.where(k == 0, length + 0 * s, s)


def rotation(angle, dtype, device):
    angle = torch.as_tensor(angle, dtype=dtype, device=device)
    c, s = torch.cos(angle), torch.sin(angle)
    return matrix({(0, 0): c, (0, 2): s, (1, 1): c, (1, 3): s,
                   (2, 0): -s, (2, 2): c, (3, 1): -s, (3, 3): c}, angle.shape, dtype, device)


def product(*maps):
    """``maps[0] @ maps[1] @ ...`` (batched)."""
    out = maps[0]
    for m in maps[1:]:
        out = matmul(out, m)
    return out


def magnet_map(length, k1, hx, tilt, energy, dtype, device):
    """Ocelot's universal linear map of a quadrupole or sector-bend body
    (focusing ``k1``, curvature ``hx``), rotated by ``tilt``."""
    length, k1, hx = (torch.as_tensor(v, dtype=dtype, device=device) for v in (length, k1, hx))
    shape = torch.broadcast_shapes(length.shape, k1.shape, hx.shape)
    igamma2, beta = relativistic(energy)
    kx2, ky2 = k1 + hx**2, -k1
    cx, sx = cos_sinc(kx2, length)
    cy, sy = cos_sinc(ky2, length)
    safe = torch.where(kx2 == 0, torch.ones_like(kx2), kx2)
    dx = torch.where(kx2 == 0, torch.zeros_like(cx), hx / safe * (1.0 - cx))
    bend = torch.where(kx2 == 0, torch.zeros_like(cx), hx**2 * (length - sx) / safe)
    r56 = bend / beta**2 - length / beta**2 * igamma2
    body = matrix({(0, 0): cx, (0, 1): sx, (0, 5): dx / beta, (1, 0): -kx2 * sx, (1, 1): cx,
                   (1, 5): sx * hx / beta, (2, 2): cy, (2, 3): sy, (3, 2): -ky2 * sy,
                   (3, 3): cy, (4, 0): sx * hx / beta, (4, 1): dx / beta, (4, 5): r56},
                  shape, dtype, device)
    return product(rotation(-tilt, dtype, device), body, rotation(tilt, dtype, device))


def misaligned(body, misalignment, dtype, device):
    """``exit @ body @ entry`` for a transverse ``(dx, dy)`` misalignment."""
    mx, my = (float(v) for v in misalignment)
    if mx == 0 and my == 0:
        return body
    shape = body.shape[:-2]
    entry = matrix({(0, 6): -mx, (2, 6): -my}, shape, dtype, device)
    exit_ = matrix({(0, 6): mx, (2, 6): my}, shape, dtype, device)
    return product(exit_, body, entry)


def drift_map(length, energy, dtype, device):
    length = torch.as_tensor(length, dtype=dtype, device=device)
    igamma2, beta = relativistic(energy)
    return matrix({(0, 1): length, (2, 3): length, (4, 5): -length * igamma2 / beta**2},
                  length.shape, dtype, device)


def corrector_map(length, angle, row, energy, dtype, device):
    """A drift, then a kick of ``angle`` on ``row`` (1: x', 3: y')."""
    length, angle = (torch.as_tensor(v, dtype=dtype, device=device) for v in (length, angle))
    shape = torch.broadcast_shapes(length.shape, angle.shape)
    igamma2, beta = relativistic(energy)
    return matrix({(0, 1): length, (2, 3): length, (4, 5): -length * igamma2 / beta**2,
                   (row, 6): angle}, shape, dtype, device)


def solenoid_map(length, k, energy, dtype, device):
    length, k = (torch.as_tensor(v, dtype=dtype, device=device) for v in (length, k))
    shape = torch.broadcast_shapes(length.shape, k.shape)
    c, s = torch.cos(length * k), torch.sin(length * k)
    s_k = torch.where(k == 0, length + 0 * s, s / torch.where(k == 0, torch.ones_like(k), k))
    gamma = energy / REST_ENERGY_EV
    return matrix({(0, 0): c**2, (0, 1): c * s_k, (0, 2): s * c, (0, 3): s * s_k,
                   (1, 0): -k * s * c, (1, 1): c**2, (1, 2): -k * s**2, (1, 3): s * c,
                   (2, 0): -s * c, (2, 1): -s * s_k, (2, 2): c**2, (2, 3): c * s_k,
                   (3, 0): k * s**2, (3, 1): -s * c, (3, 2): -k * s * c, (3, 3): c**2,
                   (4, 5): -length / (gamma**2 - 1.0)}, shape, dtype, device)


def dipole_map(fields, angle, energy, dtype, device):
    """A sector bend of ``angle`` with thin-wedge edge maps at its faces,
    the whole rotated by its tilt."""
    length = scalar(fields, "length")
    if length == 0:
        raise ValueError("a zero-length dipole is not part of this reference")
    angle = torch.as_tensor(angle, dtype=dtype, device=device)
    hx = angle / length
    gap = scalar(fields, "gap")

    def edge(e, fint):
        phi = fint * hx * gap / math.cos(e) * (1 + math.sin(e) ** 2)
        return matrix({(1, 0): hx * math.tan(e), (3, 2): -hx * torch.tan(e - phi)},
                      angle.shape, dtype, device)

    body = magnet_map(length, 0.0, hx, 0.0, energy, dtype, device)
    bend = product(edge(scalar(fields, "e2"), scalar(fields, "fringe_integral_exit")), body,
                   edge(scalar(fields, "e1"), scalar(fields, "fringe_integral")))
    tilt = scalar(fields, "tilt")
    return product(rotation(-tilt, dtype, device), bend, rotation(tilt, dtype, device))


def cavity_map(fields, energy, dtype, device):
    if scalar(fields, "voltage") != 0:
        raise ValueError("only unpowered cavities (a drift's map) are part of this reference")
    return drift_map(scalar(fields, "length"), energy, dtype, device)


#: The field that a tuned element of each kind takes per setting.
TUNED_FIELD = {"Quadrupole": "k1", "HorizontalCorrector": "angle",
               "VerticalCorrector": "angle", "Solenoid": "k", "Dipole": "angle"}


def element_map(kind, fields, energy, dtype, device, value=None):
    """The map of one element; ``value`` replaces its tuned field
    (:data:`TUNED_FIELD`) with a tensor of per-setting values."""
    def field(key):
        return value if value is not None and key == TUNED_FIELD.get(kind) else scalar(fields, key)

    if kind in IDENTITY_KINDS:
        if any(v != 0 for v in fields.get("misalignment", [[0.0, 0.0]])[0]):
            raise ValueError(f"a misaligned {kind} is not part of this reference")
        if kind == "Aperture" and math.isfinite(min(scalar(fields, "x_max", math.inf),
                                                    scalar(fields, "y_max", math.inf))):
            raise ValueError("an aperture that cuts the beam is not part of this reference")
        return torch.eye(7, dtype=dtype, device=device)
    if kind == "Drift":
        return drift_map(scalar(fields, "length"), energy, dtype, device)
    if kind == "Quadrupole":
        body = magnet_map(scalar(fields, "length"), field("k1"), 0.0, scalar(fields, "tilt"),
                          energy, dtype, device)
        return misaligned(body, fields.get("misalignment", [[0.0, 0.0]])[0], dtype, device)
    if kind in ("HorizontalCorrector", "VerticalCorrector"):
        row = 1 if kind == "HorizontalCorrector" else 3
        return corrector_map(scalar(fields, "length"), field("angle"), row, energy, dtype, device)
    if kind == "Solenoid":
        body = solenoid_map(scalar(fields, "length"), field("k"), energy, dtype, device)
        return misaligned(body, fields.get("misalignment", [[0.0, 0.0]])[0], dtype, device)
    if kind == "Dipole":
        return dipole_map(fields, field("angle"), energy, dtype, device)
    if kind == "Cavity":
        return cavity_map(fields, energy, dtype, device)
    raise ValueError(f"no reference map for element kind {kind!r}")
