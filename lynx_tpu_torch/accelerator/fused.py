"""Fused sweep path: adapters from elements to map builders (counterpart of
``lynx_tpu.accelerator.fused``).

Each supported element type contributes a list of parameter tensors and a
pure builder ``f(params, energy) -> table`` over the sparse table algebra
(``ops/table.py``).  The plain version of the sweep calls the builders in
PyTorch; the CUDA kernels B3 and B4 carry a device function per builder
that repeats it op for op, named by the builder's ``tape_kind``
(``ops/fused_track.py``).

Types: Drift, Quadrupole, the horizontal and vertical correctors, an
inactive Cavity, Undulator, Solenoid, Dipole and RBend, CustomTransferMap,
and the identity of Marker, BPM, Screen and Aperture (only an inactive
cavity, BPM, screen or aperture is skippable).

:func:`particle_moment_plan` builds the plan of the particle moment sweep
(kernels B5 and B6, ``ops/fused_track.fused_particle_moment_sweep``); on the
card kernel B10 (``ops/fused_track.map_fold``) folds each run's maps.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from lynx_tpu_torch.accelerator.aperture import Aperture
from lynx_tpu_torch.accelerator.bpm import BPM
from lynx_tpu_torch.accelerator.cavity import Cavity
from lynx_tpu_torch.accelerator.correctors import HorizontalCorrector, VerticalCorrector
from lynx_tpu_torch.accelerator.custom_transfer_map import CustomTransferMap
from lynx_tpu_torch.accelerator.dipole import Dipole, RBend, dipole_hx
from lynx_tpu_torch.accelerator.drift import Drift
from lynx_tpu_torch.accelerator.marker import Marker
from lynx_tpu_torch.accelerator.quadrupole import Quadrupole
from lynx_tpu_torch.accelerator.screen import Screen
from lynx_tpu_torch.accelerator.solenoid import Solenoid, solenoid_entries
from lynx_tpu_torch.accelerator.undulator import Undulator
from lynx_tpu_torch.ops import table as tbl
from lynx_tpu_torch.ops.fused_track import (
    TAPE_CAVITY,
    TAPE_CUSTOM,
    TAPE_DIPOLE,
    TAPE_DRIFT,
    TAPE_HCOR,
    TAPE_IDENTITY,
    TAPE_QUAD,
    TAPE_SOLENOID,
    TAPE_UNDULATOR,
    TAPE_VCOR,
    _compose_entries,
    _fold_layout,
    _split_table,
    map_fold,
)
from lynx_tpu_torch.ops.rmatrix import (
    base_rmatrix_entries,
    base_rmatrix_table,
    cavity_rmatrix_entries,
    drift_rmatrix_entries,
    igamma2_from_energy,
    rotation_entries,
)

Tensor = torch.Tensor

#: A builder maps (params, energy) -> sparse table (see ``ops/table.py``).
Builder = Tuple[List[Tensor], Callable[[List[Tensor], Tensor], tbl.Table]]


def _build_drift(params, energy):
    return tbl.entries_to_table(drift_rmatrix_entries(params[0], energy))


def _build_quadrupole(params, energy):
    length, k1, tilt, mx, my = params
    T = base_rmatrix_table(length, k1, torch.zeros_like(length), tilt, energy)
    entry = tbl.entries_to_table({(0, 6): -mx, (2, 6): -my})
    exit_ = tbl.entries_to_table({(0, 6): mx, (2, 6): my})
    return tbl.compose(exit_, tbl.compose(T, entry))


def _build_corrector(kick_row, params, energy):
    length, angle = params
    entries = drift_rmatrix_entries(length, energy)
    entries[(kick_row, 6)] = angle
    return tbl.entries_to_table(entries)


def _build_horizontal_corrector(params, energy):
    return _build_corrector(1, params, energy)


def _build_vertical_corrector(params, energy):
    return _build_corrector(3, params, energy)


def _build_identity(params, energy):
    return tbl.identity_table()


def _build_cavity(params, energy):
    length, voltage, phase, frequency = params
    entries, _, _ = cavity_rmatrix_entries(length, voltage, phase, frequency, energy)
    return tbl.entries_to_table(entries)


def _build_undulator(params, energy):
    (length,) = params
    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    return tbl.entries_to_table({(0, 1): length, (2, 3): length, (4, 5): length * igamma2})


def _misaligned(T, mx, my):
    entry = tbl.entries_to_table({(0, 6): -mx, (2, 6): -my})
    exit_ = tbl.entries_to_table({(0, 6): mx, (2, 6): my})
    return tbl.compose(exit_, tbl.compose(T, entry))


def _build_solenoid(params, energy):
    length, k, mx, my = params
    return _misaligned(tbl.entries_to_table(solenoid_entries(length, k, energy)), mx, my)


def _build_dipole(params, energy):
    length, angle, e1, e2, tilt, fint, fintx, gap = params
    zero_length = length == 0
    hx = dipole_hx(length, angle)
    body_entries, _, _, _ = base_rmatrix_entries(
        length=torch.where(zero_length, 1.0, length),
        k1=torch.zeros_like(length),
        hx=hx,
        tilt=torch.zeros_like(length),
        energy=energy,
    )
    body = tbl.entries_to_table(body_entries)
    thin = tbl.entries_to_table({(0, 1): length, (2, 6): angle, (2, 3): length})
    R = tbl.where_table(zero_length, thin, body)

    def edge(e, fi):
        sec_e = 1.0 / torch.cos(e)
        phi = fi * hx * gap * sec_e * (1 + torch.sin(e) ** 2)
        return tbl.entries_to_table({(1, 0): hx * torch.tan(e), (3, 2): -hx * torch.tan(e - phi)})

    R = tbl.compose(edge(e2, fintx), tbl.compose(R, edge(e1, fint)))
    rot_fwd = tbl.entries_to_table(rotation_entries(tilt))
    rot_bwd = tbl.entries_to_table(rotation_entries(-tilt))
    return tbl.compose(rot_bwd, tbl.compose(R, rot_fwd))


def _build_custom(params, energy):
    return [[params[i * 7 + j] for j in range(7)] for i in range(7)]


# The kernels' device function for each builder.
_build_drift.tape_kind = TAPE_DRIFT
_build_quadrupole.tape_kind = TAPE_QUAD
_build_horizontal_corrector.tape_kind = TAPE_HCOR
_build_vertical_corrector.tape_kind = TAPE_VCOR
_build_identity.tape_kind = TAPE_IDENTITY
_build_cavity.tape_kind = TAPE_CAVITY
_build_undulator.tape_kind = TAPE_UNDULATOR
_build_solenoid.tape_kind = TAPE_SOLENOID
_build_dipole.tape_kind = TAPE_DIPOLE
_build_custom.tape_kind = TAPE_CUSTOM


def element_map_builder(element) -> Optional[Builder]:
    """Return (param tensors, builder) for a supported element, or ``None``
    if the element type has no fused builder (yet)."""
    if type(element) is Drift:
        return [element.length], _build_drift
    if type(element) is Quadrupole:
        return (
            [
                element.length,
                element.k1,
                element.tilt,
                element.misalignment[..., 0],
                element.misalignment[..., 1],
            ],
            _build_quadrupole,
        )
    if isinstance(element, HorizontalCorrector):
        return [element.length, element.angle], _build_horizontal_corrector
    if isinstance(element, VerticalCorrector):
        return [element.length, element.angle], _build_vertical_corrector
    if type(element) is Cavity:  # reached only when inactive (skippable)
        return (
            [element.length, element.voltage, element.phase, element.frequency],
            _build_cavity,
        )
    if isinstance(element, (Marker, BPM, Screen, Aperture)):
        return [], _build_identity
    if isinstance(element, Undulator):
        return [element.length], _build_undulator
    if isinstance(element, Solenoid):
        return (
            [element.length, element.k, element.misalignment[..., 0],
             element.misalignment[..., 1]],
            _build_solenoid,
        )
    if type(element) in (Dipole, RBend):
        return (
            [element.length, element.angle, element.e1, element.e2, element.tilt,
             element.fringe_integral, element.fringe_integral_exit, element.gap],
            _build_dipole,
        )
    if isinstance(element, CustomTransferMap):
        tm = element._transfer_map
        return [tm[..., i, j] for i in range(7) for j in range(7)], _build_custom
    return None


def fused_flush_supported(run: list) -> bool:
    return all(element_map_builder(el) is not None for el in run)


def _flat_size(value) -> int:
    return torch.as_tensor(value).numel()


_IDENTITY_LAYOUT = [[1.0 if i == j else 0.0 for j in range(7)] for i in range(7)]


def _fold_batch(values: List[Tensor], energy: Tensor) -> Optional[int]:
    """The settings B where a run of ``(B,)`` values at the ``(B,)`` energy
    takes kernel B10 (``ops/fused_track.map_fold``): the values and the
    energy are CUDA tensors and none needs a gradient; else ``None``, the
    table algebra."""
    if not (energy.is_cuda and all(v.is_cuda for v in values)):
        return None
    if energy.dtype not in (torch.float32, torch.float64):
        return None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (energy, *values)):
        return None
    shape = torch.broadcast_shapes(energy.shape, *(v.shape for v in values))
    return shape[0] if len(shape) == 1 else None


def particle_moment_plan(elements: list, energy: Tensor, vec: Callable[[Tensor], Tensor]):
    """Build the plan of the particle moment sweep
    (``ops/fused_track.fused_particle_moment_sweep``): maximal runs of affine
    elements compose into ``("map", layout)`` entries whose dynamic cells are
    ``(B,)`` per-setting scalars, and an active aperture, the one
    per-particle, per-setting operation no moment algebra can absorb,
    becomes an ``("aperture", x_idx, y_idx, shape)`` entry.  An active BPM
    leaves the beam untouched and is passed over.

    A run composes in one launch of kernel B10 (``ops/fused_track.map_fold``:
    its scalars are rows of the kernel's output) where :func:`_fold_batch`
    says so, else in the sparse table algebra (``ops/table.py``), an operation a
    cell; both give the same layout.  ``particle_moment_plan.folded_runs``
    and ``.table_runs`` count the runs composed each way (a run that
    composes to the identity is dropped and counted in neither).

    Returns ``(entries, scalars)``, or ``None`` when an element needs
    anything else per particle (an active screen): such lattices take the
    general tracking paths."""
    vec_energy = vec(torch.as_tensor(energy))
    # Compose in the energy's dtype: element parameters default to float32,
    # and the dense path promotes them inside each map builder the same way.
    dtype = vec_energy.dtype
    entries: List[tuple] = []
    scalars: List[Tensor] = []
    group: List[Builder] = []

    def flush_group() -> None:
        if not group:
            return
        run = tuple(("dyn", fn, len(params)) for params, fn in group)
        values = [vec(p) for params, _ in group for p in params]
        group.clear()
        B = _fold_batch(values, vec_energy)
        if B is not None:
            layout, mask = _fold_layout(run)
            cells = ()
            if mask:
                run_energy = torch.broadcast_to(vec_energy, (B,)).contiguous()
                cells = map_fold(run, values, run_energy).unbind(0)
        else:
            total = _compose_entries(run, [v.to(dtype) for v in values], vec_energy)
            layout, cells = _split_table(total)
        if not cells and layout == _IDENTITY_LAYOUT:
            return
        if B is not None:
            particle_moment_plan.folded_runs += 1
        else:
            particle_moment_plan.table_runs += 1
        offset = len(scalars)
        scalars.extend(cells)
        entries.append((
            "map",
            tuple(
                tuple(c if isinstance(c, float) else c + offset for c in row)
                for row in layout
            ),
        ))

    for element in elements:
        if element.is_skippable:
            builder = element_map_builder(element)
            if builder is None:
                return None
            group.append(builder)
        elif isinstance(element, Aperture):
            flush_group()
            x_idx = len(scalars)
            scalars.append(vec(element.x_max).to(dtype))
            y_idx = len(scalars)
            scalars.append(vec(element.y_max).to(dtype))
            entries.append(("aperture", x_idx, y_idx, element.shape))
        elif isinstance(element, BPM):
            continue
        else:
            return None
    flush_group()
    return tuple(entries), tuple(scalars)


particle_moment_plan.folded_runs = 0
particle_moment_plan.table_runs = 0


def plan_run(
    builders: List[Builder], energy: Tensor, vec: Callable[[Tensor], Tensor]
) -> List[tuple]:
    """Build a fused-sweep run plan: maximal groups of batch-invariant
    elements (every parameter AND the energy of size 1) are pre-composed
    once, in PyTorch at ``(1,)`` shape, and enter the sweep as
    ``("const", layout, cells)`` entries; everything else stays a
    ``("dyn", build_fn, vec'd params)`` entry.

    The pre-composition runs through the same differentiable table algebra,
    so gradients with respect to static elements' parameters flow through
    the const cells (``ops/fused_track.fused_moment_sweep_plan``)."""
    energy_static = _flat_size(energy) == 1
    energy_1 = torch.reshape(energy, (-1,))[:1]
    plan: List[tuple] = []
    group: List[Builder] = []

    def flush_group() -> None:
        if not group:
            return
        total = None
        for params, fn in group:
            T = fn([torch.reshape(p, (-1,)) for p in params], energy_1)
            total = T if total is None else tbl.compose(T, total)
        group.clear()
        layout, cells = _split_table(total)
        if not cells and layout == _IDENTITY_LAYOUT:
            return  # pure identity (markers / inactive screens): drop
        plan.append(("const", layout, cells))

    for params, fn in builders:
        if energy_static and all(_flat_size(p) == 1 for p in params):
            group.append((params, fn))
        else:
            flush_group()
            plan.append(("dyn", fn, [vec(p) for p in params]))
    flush_group()
    return plan
