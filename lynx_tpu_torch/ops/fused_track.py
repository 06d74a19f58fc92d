"""Fused batched-settings tracking (counterpart of ``lynx_tpu.ops.pallas_track``):
the ParameterBeam settings sweep with its gradient, the per-setting particle
push, and the particle moment sweep of one shared cloud.

Five hand-written CUDA kernels carry it on the card, each beside its plain
PyTorch version:

* **B3** (``csrc/moment_sweep.cu``, wrapper :func:`moment_sweep`): for B
  settings, builds each dynamic element's 7x7 map from its ``(B,)``
  parameters, composes it with the pre-composed constant groups, and writes
  ``mu' = T mu`` and ``cov' = T cov T^T``.  Plain version:
  :func:`_table_reference_sweep` (sparse tables, ``ops/table.py``).
* **B4** (``csrc/moment_sweep_bwd.cu``, wrapper :func:`moment_sweep_bwd`):
  B3's vector-Jacobian product.  Plain version: autograd of
  :func:`_table_reference_sweep`.
* **B2** (``csrc/particle_apply.cu``, wrapper :func:`particle_apply`): one
  composed 7x7 map per setting applied to ``(B, N, 7)`` particles; its
  backward is the same kernel on the transposed map.  Plain version:
  :func:`particle_apply_reference`.
* **B5** (``csrc/particle_moment_sweep.cu``, wrapper
  :func:`particle_moment_sweep`): the 36 weighted moment sums of one shared
  ``(N, 7)`` cloud after a plan of sparse maps and aperture masks, walked
  per setting.  Plain version: :func:`_moment_sweep_reference`.
* **B6** (``csrc/packed_gram.cu``, wrapper :func:`packed_gram`): the same
  sums for many settings as the survival-weighted joint Gram of the
  augmented cloud, the maps applied afterwards as one exact sandwich.
  Plain version: :func:`packed_gram_reference`.
:func:`fused_particle_moment_sweep` routes between B5 and B6; its backward
is autograd of the plain walk, as in the JAX package.

* **B8** (``csrc/particle_push.cu``, wrapper :func:`particle_push`): a run's
  7x7 map built per setting on the card from B3's op tape and the run's
  parameters, and ``(B, N, 7)`` particles pushed through it, in one launch.
  It has no TPU counterpart: it replaces the dense route's per-element maps
  in PyTorch.  Plain version: :func:`particle_push_reference`.
* **B10** (``csrc/map_fold.cu``, wrapper :func:`map_fold`): a run's 7x7
  map built per setting on the card from B3's op tape, as B8 builds it,
  written out as the composed layout's per-setting cells.  It has no TPU
  counterpart: it replaces the particle moment plan's table algebra
  (``accelerator/fused.particle_moment_plan``) on the card.  Plain
  version: :func:`map_fold_reference`.

A plan (``accelerator/fused.plan_run``) reaches B3, B4, B8 and B10 as a
small op tape: one entry per plan entry, ``(kind, offset, cell_start, cell_count)``
(:func:`_tape`).  A wrapper takes the plain version for CPU tensors and
launches its kernel (or raises) for CUDA tensors; it never synchronises the
host, and ``<wrapper>.launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from lynx_tpu_torch import profiling
from lynx_tpu_torch._build import check, load_library
from lynx_tpu_torch.constants import ELECTRON_MASS_EV, REST_ENERGY_EV
from lynx_tpu_torch.ops import table as tbl

Tensor = torch.Tensor

#: Tape kinds: the kernels' device function for each plan entry.  A dynamic
#: builder names its kind in its ``tape_kind`` attribute
#: (``accelerator/fused.py``); ``csrc/fused_builders.cuh`` has the same codes.
(
    TAPE_CONST, TAPE_DRIFT, TAPE_QUAD, TAPE_HCOR, TAPE_VCOR, TAPE_IDENTITY, TAPE_CAVITY,
    TAPE_UNDULATOR, TAPE_SOLENOID, TAPE_DIPOLE, TAPE_CUSTOM,
) = range(11)
_TAPE_PARAMS = {
    TAPE_DRIFT: 1, TAPE_QUAD: 5, TAPE_HCOR: 2, TAPE_VCOR: 2, TAPE_IDENTITY: 0, TAPE_CAVITY: 4,
    TAPE_UNDULATOR: 1, TAPE_SOLENOID: 4, TAPE_DIPOLE: 8, TAPE_CUSTOM: 49,
}

#: Support classes of a const entry's map, as ``csrc/fused_builders.cuh``'s
#: ``ConstSupport`` codes: B3 composes such an entry over the class's cells
#: only.  A class takes a layout whose literal zeros cover every cell outside
#: it and whose diagonal is literal ones; any other layout is dense (code 0).
_DRIFT_CELLS = frozenset([(i, i) for i in range(7)] + [(0, 1), (2, 3), (4, 5)])
_KICK_CELLS = frozenset((i, 6) for i in range(5))
_CONST_SUPPORTS = ((1, _DRIFT_CELLS), (2, _DRIFT_CELLS | _KICK_CELLS))


def _table_from_layout(layout, cells):
    """Rehydrate a sparse table from a ``_split_table`` layout: float entries
    are structural literals, int entries index into ``cells``."""
    return [
        [cell if isinstance(cell, float) else cells[cell] for cell in row]
        for row in layout
    ]


def _split_table(total):
    """Split a composed table into (layout, dynamic cells): literals stay in
    the layout, tensor cells are replaced by their index into the cell list."""
    layout = []
    cells = []
    for i in range(7):
        row = []
        for j in range(7):
            cell = total[i][j]
            if tbl._is_literal(cell):
                row.append(float(cell))
            else:
                row.append(len(cells))
                cells.append(cell)
        layout.append(row)
    return layout, cells


def _transpose_layout(layout):
    return [[layout[j][i] for j in range(7)] for i in range(7)]


# -- Kernel B3's plain version ----------------------------------------------


def _compose_entries(entries, flat_values, energy):
    """The composed table ``R_{E-1} ... R_0`` of a plan's ``(kind, meta,
    count)`` entries, ``flat_values`` the matching parameter/cell tensors in
    plan order: a dynamic entry's table from its builder, a const entry's
    from its layout.  Differentiable."""
    total = None
    offset = 0
    for kind, meta, count in entries:
        values = list(flat_values[offset : offset + count])
        offset += count
        if kind == "dyn":
            T = meta(values, energy)
        else:
            T = _table_from_layout(meta, values)
        total = T if total is None else tbl.compose(T, total)
    return tbl.identity_table() if total is None else total


def _table_reference_sweep(entries, flat_values, energy, mu, cov):
    """Plain PyTorch version of the fused sweep (same math, same builders):
    ``entries`` are ``(kind, meta, count)`` plan entries, ``flat_values`` the
    matching parameter/cell tensors in plan order, ``mu`` ``(B, 7)`` and
    ``cov`` ``(B, 7, 7)``.  Differentiable."""
    total = _compose_entries(entries, flat_values, energy)
    mu_cells = [mu[:, i] for i in range(7)]
    out_mu_cells = tbl.matvec(total, mu_cells)
    cov_table = [[cov[:, i, j] for j in range(7)] for i in range(7)]
    out_cov_table = tbl.cov_sandwich(total, cov_table)
    B = energy.shape[0]
    dtype, device = mu.dtype, mu.device
    out_mu = torch.stack(
        [tbl.broadcast_cell(c, (B,), dtype, device) for c in out_mu_cells], dim=-1
    )
    out_cov = torch.stack(
        [
            torch.stack([tbl.broadcast_cell(c, (B,), dtype, device) for c in row], dim=-1)
            for row in out_cov_table
        ],
        dim=-2,
    )
    return out_mu, out_cov


def _reference_sweep_vjp(entries, flat_values, energy, mu, cov, dmu, dcov, wanted=None):
    """Plain version of B4: autograd of :func:`_table_reference_sweep`.
    ``wanted`` (one flag per flat value, then the energy, mu and cov; None:
    every input) names the cotangents asked for.  Returns ``(d_flat_values,
    d_energy, d_mu, d_cov)``, None where not asked for."""
    n = len(flat_values)
    wanted = (True,) * (n + 3) if wanted is None else tuple(wanted)
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(flag)
                  for t, flag in zip((*flat_values, energy, mu, cov), wanted)]
        out = _table_reference_sweep(entries, inputs[:n], *inputs[n:])
        asked = [x for x in inputs if x.requires_grad]
        found = iter(torch.autograd.grad(out, asked, (dmu, dcov), allow_unused=True)
                     if asked else ())
    grads = []
    for x, flag in zip(inputs, wanted):
        g = next(found) if flag else None
        grads.append(torch.zeros_like(x) if flag and g is None else g)
    return tuple(grads[:n]), grads[n], grads[n + 1], grads[n + 2]


# -- The op tape of B3 and B4 -----------------------------------------------

#: Tapes by plan structure and device: the tape depends only on the
#: structure, so it is copied to the card once per lattice.
_TAPES: dict = {}


def _const_support(layout) -> int:
    """The support class of a const entry's layout (see ``_CONST_SUPPORTS``)."""
    if not all(isinstance(layout[i][i], float) and layout[i][i] == 1.0 for i in range(7)):
        return 0
    cells = {
        (r, c) for r in range(7) for c in range(7)
        if not (isinstance(layout[r][c], float) and layout[r][c] == 0.0)
    }
    return next((code for code, support in _CONST_SUPPORTS if cells <= support), 0)


def _tape_key(entries, device):
    key = []
    for kind, meta, count in entries:
        if kind == "dyn":
            code = getattr(meta, "tape_kind", None)
            if code is None or _TAPE_PARAMS[code] != count:
                raise ValueError(
                    f"fused sweep: no CUDA builder for {getattr(meta, '__name__', meta)!r}"
                    f" with {count} parameters"
                )
            key.append(code)
        else:
            key.append(tuple(tuple(row) for row in meta))
    return tuple(key), str(device)


class Tape(NamedTuple):
    """The op tape of a plan, on the kernels' device.

    ``rows`` is ``(E, 5)`` int32, one ``(kind, offset, cell_start,
    cell_count, support)`` per entry: a dynamic entry's parameters are rows
    ``offset ...`` of the ``(P, B)`` parameter tensor; a const entry's dense
    49 cells are row ``offset`` of the ``(n_consts, 49)`` const tensor, its
    ``cell_count`` non-literal cells, at positions ``cell_pos[cell_start
    ...]`` of the 49, are the ones whose cotangents B4 writes out, and
    ``support`` is its support class (``_const_support``; 0 for a dynamic
    entry).
    ``literals`` is the const tensor with the literal cells filled in and
    zeros elsewhere; ``cell_index`` places the non-literal cells into its
    flattened view.  ``full`` says that the tape holds a kind of the full
    lattice (a cavity, undulator, solenoid, dipole or custom map): the
    kernels then run their instantiation with those builders."""

    rows: Tensor
    cell_pos: Tensor
    cell_index: Tensor
    literals: Tensor
    n_params: int
    full: bool


def _tape(entries, device) -> Tape:
    """The op tape of a plan (see :class:`Tape`), built once per plan
    structure and device."""
    key = _tape_key(entries, device)
    if key in _TAPES:
        return _TAPES[key]
    rows, positions, index, literals = [], [], [], []
    n_params = 0
    for code, (kind, meta, count) in zip(key[0], entries):
        if kind == "dyn":
            rows.append((code, n_params, 0, 0, 0))
            n_params += count
            continue
        pos = [7 * r + c for r in range(7) for c in range(7) if not isinstance(meta[r][c], float)]
        rows.append((TAPE_CONST, len(literals), len(positions), len(pos), _const_support(meta)))
        index.extend(49 * len(literals) + q for q in pos)
        positions.extend(pos)
        literals.append([cell if isinstance(cell, float) else 0.0 for row in meta for cell in row])
    tape = Tape(
        rows=torch.tensor(rows, dtype=torch.int32).reshape(-1, 5).to(device),
        cell_pos=torch.tensor(positions, dtype=torch.int32).to(device),
        cell_index=torch.tensor(index, dtype=torch.int64).to(device),
        literals=torch.tensor(literals, dtype=torch.float64).reshape(-1, 49).to(device),
        n_params=n_params,
        full=any(row[0] >= TAPE_CAVITY for row in rows),
    )
    _TAPES[key] = tape
    return tape


def _tape_operands(entries, flat_values, tape: Tape, dtype, B):
    """The ``(P, B)`` dynamic parameters and the ``(n_consts, 49)`` dense
    const cells of a plan, in ``dtype``: a handful of device ops whatever
    the plan's length."""
    dyn, cells = [], []
    values = iter(flat_values)
    for kind, _, count in entries:
        for _ in range(count):
            value = next(values)
            if kind == "dyn":
                dyn.append(torch.broadcast_to(value, (B,)))
            else:
                cells.append(value.reshape(()))
    device = tape.literals.device
    if dyn:
        params = torch.stack(dyn).to(dtype)
    else:
        params = torch.empty((0, B), dtype=dtype, device=device)
    consts = tape.literals.to(dtype, copy=True)
    if cells:
        consts.view(-1)[tape.cell_index] = torch.stack(cells).to(dtype)
    return params.contiguous(), consts


def _check_sweep_operands(what, energy, mu, cov, *more):
    B = mu.shape[0]
    if mu.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: moments must be float32 or float64, got {mu.dtype}")
    for t in (energy, mu, cov, *more):
        if not t.is_cuda or t.device != mu.device:
            raise ValueError(f"{what}: operands must share one CUDA device")
        if t.dtype != mu.dtype or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous {mu.dtype}")
    if energy.shape != (B,) or mu.shape != (B, 7) or cov.shape != (B, 7, 7):
        raise ValueError(
            f"{what}: expected energy (B,), mu (B, 7), cov (B, 7, 7), got"
            f" {tuple(energy.shape)}, {tuple(mu.shape)}, {tuple(cov.shape)}"
        )


# -- Kernel B3: the fused moment sweep ---------------------------------------

_P = ctypes.c_void_p
#: C signature of B3's entry point: is_double, full, tape, n_entries, params,
#: consts, energy, mu, cov, out_mu, out_cov, batch, rest energy, electron
#: mass, stream.
_B3_SIGNATURE = {
    "lynx_moment_sweep": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, _P, ctypes.c_int] + [_P] * 7
        + [ctypes.c_longlong, ctypes.c_double, ctypes.c_double, _P],
    )
}


def moment_sweep_library() -> ctypes.CDLL:
    """Kernel B3's library, built with nvcc at first use."""
    return load_library("moment_sweep", _B3_SIGNATURE)


def _moment_sweep_cuda(entries, flat_values, energy, mu, cov):
    """Launch kernel B3 on the current stream (no synchronisation)."""
    _check_sweep_operands("moment_sweep", energy, mu, cov)
    B, dtype, device = mu.shape[0], mu.dtype, mu.device
    tape = _tape(entries, device)
    params, consts = _tape_operands(entries, flat_values, tape, dtype, B)
    out_mu = torch.empty_like(mu)
    out_cov = torch.empty_like(cov)
    library = moment_sweep_library()
    with torch.cuda.device(device), profiling.span("kernel.moment_sweep"):
        code = library.lynx_moment_sweep(
            int(dtype == torch.float64), int(tape.full), tape.rows.data_ptr(), tape.rows.shape[0],
            params.data_ptr(), consts.data_ptr(), energy.data_ptr(), mu.data_ptr(),
            cov.data_ptr(), out_mu.data_ptr(), out_cov.data_ptr(), B, REST_ENERGY_EV,
            ELECTRON_MASS_EV, torch.cuda.current_stream(device).cuda_stream,
        )
    check(library, code, "moment_sweep")
    moment_sweep.launches += 1
    return out_mu, out_cov


def moment_sweep(entries, flat_values, energy: Tensor, mu: Tensor, cov: Tensor):
    """Kernel B3: ``(mu', cov')`` of B settings through a plan's entries.

    ``energy`` ``(B,)``, ``mu`` ``(B, 7)`` and ``cov`` ``(B, 7, 7)`` share
    one dtype (float32 or float64), which the kernel computes in; the flat
    values are cast to it.  A CUDA tensor launches the kernel (or raises); a
    CPU tensor takes the plain version, :func:`_table_reference_sweep`."""
    flat_values = [v.to(mu.dtype) for v in flat_values]
    if mu.device.type == "cpu":
        return _table_reference_sweep(entries, flat_values, energy, mu, cov)
    return _moment_sweep_cuda(entries, flat_values, energy, mu, cov)


moment_sweep.launches = 0


# -- Kernel B4: the sweep's backward -----------------------------------------

#: C signatures of B4's entry points.  ``lynx_moment_sweep_bwd``: is_double,
#: full, tape, wants (:class:`VjpLayout`'s rows), n_entries, n_forward,
#: states (the workspace), totals (the composed map, where d_cov is asked
#: for), params, consts, energy, mu, cov, dmu, dcov,
#: d_params, d_consts, d_energy, d_mu, d_cov (the last three null where not
#: asked for), batch, rest energy, electron mass, stream; it returns a CUDA
#: error code.  ``lynx_moment_sweep_bwd_block``: settings per block;
#: ``lynx_moment_sweep_bwd_state``: values of a state in the workspace.
_B4_SIGNATURE = {
    "lynx_moment_sweep_bwd": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int] + [_P] * 14
        + [ctypes.c_longlong, ctypes.c_double, ctypes.c_double, _P],
    ),
    "lynx_moment_sweep_bwd_block": (ctypes.c_int, []),
    "lynx_moment_sweep_bwd_state": (ctypes.c_int, []),
}

#: Values of a setting's state in B4's workspace: mu and the upper triangle
#: of Sigma (``lynx_moment_sweep_bwd_state``).
B4_STATE = 35


class VjpLayout(NamedTuple):
    """What one B4 launch differentiates, from a plan and the cotangents
    asked for (:func:`_vjp_layout`).

    ``wants`` is ``(E, 4)`` int32 on the tape's device, one ``(lo, hi, row,
    slot)`` per entry (``EntryWants`` in ``csrc/moment_sweep_bwd.cu``): bit
    k of the 64-bit ``hi:lo`` asks for the cotangent of the entry's value k
    (a dynamic entry's parameter, a custom map's cell; a const entry's cell
    at position k of the 49), a dynamic entry's bit ``count`` for the
    energy; ``row`` is its first row in ``d_params`` (dynamic) or
    ``d_consts`` (const); ``slot`` its state's place in the workspace (-1:
    nothing asked, no state).  ``slots`` states a setting; ``forward`` the
    entries the forward pass walks (through the last with a slot);
    ``param_rows`` and ``const_rows`` the outputs' rows; ``cotangents`` the
    inputs differentiated (values and the energy)."""

    wants: Tensor
    slots: int
    forward: int
    param_rows: int
    const_rows: int
    cotangents: int


#: Layouts by plan structure, device and mask.
_LAYOUTS: dict = {}


def _vjp_layout(entries, device, wanted_values, want_energy: bool) -> VjpLayout:
    """B4's :class:`VjpLayout` for a plan, ``wanted_values`` one flag per
    flat value; built once per structure, device and mask."""
    tape_key = _tape_key(entries, device)
    key = (tape_key, tuple(wanted_values), want_energy)
    if key in _LAYOUTS:
        return _LAYOUTS[key]
    flags = iter(wanted_values)
    rows = []
    slots = forward = cotangents = 0
    counts = {"dyn": 0, "const": 0}  # output rows so far
    for e, (code, (kind, meta, count)) in enumerate(zip(tape_key[0], entries)):
        want = [bool(next(flags)) for _ in range(count)]
        if kind == "dyn":
            places = range(count)
        else:  # a const entry's values are its non-literal cells
            places = [7 * r + c for r in range(7) for c in range(7)
                      if not isinstance(meta[r][c], float)]
        bits = sum(1 << place for place, flag in zip(places, want) if flag)
        if kind == "dyn" and want_energy and code not in (TAPE_IDENTITY, TAPE_CUSTOM):
            bits |= 1 << count
        slot = -1
        if bits:
            slot, slots, forward = slots, slots + 1, e + 1
        lo, hi = bits & 0xFFFFFFFF, bits >> 32
        rows.append((lo - (1 << 32) if lo >> 31 else lo, hi, counts[kind], slot))
        counts[kind] += sum(want)
        cotangents += sum(want)
    layout = VjpLayout(
        wants=torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).to(device),
        slots=slots,
        forward=forward,
        param_rows=counts["dyn"],
        const_rows=counts["const"],
        cotangents=cotangents + int(want_energy),
    )
    _LAYOUTS[key] = layout
    return layout


def moment_sweep_bwd_library() -> ctypes.CDLL:
    """Kernel B4's library, built with nvcc at first use."""
    return load_library("moment_sweep_bwd", _B4_SIGNATURE)


def _pointer(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _sweep_vjp_launch(library, entries, flat_values, energy, mu, cov, dmu, dcov, wanted, stream):
    """B4 through ``library`` on ``stream`` (no synchronisation): the
    marshalling of :func:`moment_sweep_bwd`'s kernel route, with ``wanted``
    one flag per flat value, then the energy, mu and cov.  Counts the launch,
    the cotangents it forms and the tape's inputs."""
    B, dtype, device = mu.shape[0], mu.dtype, mu.device
    n = len(flat_values)
    tape = _tape(entries, device)
    layout = _vjp_layout(entries, device, wanted[:n], bool(wanted[n]))
    params, consts = _tape_operands(entries, flat_values, tape, dtype, B)
    d_params = torch.empty((layout.param_rows, B), dtype=dtype, device=device)
    d_consts = torch.empty((layout.const_rows, B), dtype=dtype, device=device)
    d_energy = torch.empty_like(energy) if wanted[n] else None
    d_mu = torch.empty_like(mu) if wanted[n + 1] else None
    d_cov = torch.empty_like(cov) if wanted[n + 2] else None
    states = totals = None
    if layout.slots:  # the states entering the entries with something asked for
        states = torch.empty((layout.slots, B4_STATE, B), dtype=dtype, device=device)
    if d_cov is not None:  # the composed map, for d_cov = T^T dcov T
        totals = torch.empty((49, B), dtype=dtype, device=device)
    with profiling.span("kernel.moment_sweep_bwd"):
        code = library.lynx_moment_sweep_bwd(
            int(dtype == torch.float64), int(tape.full), tape.rows.data_ptr(),
            layout.wants.data_ptr(), tape.rows.shape[0], layout.forward, _pointer(states),
            _pointer(totals), params.data_ptr(), consts.data_ptr(), energy.data_ptr(),
            mu.data_ptr(), cov.data_ptr(), dmu.data_ptr(), dcov.data_ptr(), d_params.data_ptr(),
            d_consts.data_ptr(), _pointer(d_energy), _pointer(d_mu), _pointer(d_cov), B,
            REST_ENERGY_EV, ELECTRON_MASS_EV, stream,
        )
    check(library, code, "moment_sweep_bwd")
    moment_sweep_bwd.launches += 1
    moment_sweep_bwd.cotangents += layout.cotangents
    moment_sweep_bwd.inputs += n + 1

    # Per-value cotangents: dynamic rows as they are, const cells summed
    # over the batch (the kernel writes them per setting); None where not
    # asked for.
    rows = iter(d_params)
    sums = iter(d_consts.sum(dim=1) if layout.const_rows else ())
    flags = iter(wanted[:n])
    d_flat = []
    for kind, _, count in entries:
        for _ in range(count):
            d_flat.append((next(rows) if kind == "dyn" else next(sums)) if next(flags) else None)
    return tuple(d_flat), d_energy, d_mu, d_cov


def _moment_sweep_bwd_cuda(entries, flat_values, energy, mu, cov, dmu, dcov, wanted):
    """Launch kernel B4 on the current stream (no synchronisation)."""
    _check_sweep_operands("moment_sweep_bwd", energy, mu, cov, dmu, dcov)
    if dmu.shape != mu.shape or dcov.shape != cov.shape:
        raise ValueError("moment_sweep_bwd: cotangents must have the moments' shapes")
    library = moment_sweep_bwd_library()
    with torch.cuda.device(mu.device):
        return _sweep_vjp_launch(library, entries, flat_values, energy, mu, cov, dmu, dcov, wanted,
                                 torch.cuda.current_stream(mu.device).cuda_stream)


def moment_sweep_bwd(entries, flat_values, energy, mu, cov, dmu, dcov, wanted=None):
    """Kernel B4: the VJP of :func:`moment_sweep`, returning
    ``(d_flat_values, d_energy, d_mu, d_cov)`` in the moments' dtype:
    ``(B,)`` for dynamic values, batch-summed scalars for const cells.
    ``wanted``, one flag per flat value, then the energy, mu and cov (None:
    every input), names the cotangents asked for; the others come back None
    and are not formed.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, autograd of :func:`_table_reference_sweep`.
    ``moment_sweep_bwd.cotangents`` counts the inputs the launches
    differentiated (values and the energy), ``moment_sweep_bwd.inputs`` the
    inputs of their tapes, both summed over the launches."""
    flat_values = [v.to(mu.dtype) for v in flat_values]
    wanted = (True,) * (len(flat_values) + 3) if wanted is None else tuple(wanted)
    if mu.device.type == "cpu":
        return _reference_sweep_vjp(entries, flat_values, energy, mu, cov, dmu, dcov, wanted)
    return _moment_sweep_bwd_cuda(entries, flat_values, energy, mu, cov, dmu, dcov, wanted)


moment_sweep_bwd.launches = 0
moment_sweep_bwd.cotangents = 0
moment_sweep_bwd.inputs = 0


class _FusedMomentSweep(torch.autograd.Function):
    """B3 forward, B4 backward.  Gradients flow to the flat plan values
    (const cells reduced to their own shape and dtype), the energy and the
    moments that autograd asks for; B4 forms only those."""

    @staticmethod
    def forward(ctx, entries, energy, mu, cov, *flat_values):
        ctx.entries = entries
        ctx.save_for_backward(energy, mu, cov, *flat_values)
        return moment_sweep(entries, flat_values, energy, mu, cov)

    @staticmethod
    def backward(ctx, dmu, dcov):
        energy, mu, cov, *flat_values = ctx.saved_tensors
        needs = ctx.needs_input_grad  # entries, energy, mu, cov, flat values
        d_flat, d_energy, d_mu, d_cov = moment_sweep_bwd(
            ctx.entries, flat_values, energy, mu, cov, dmu.contiguous(), dcov.contiguous(),
            wanted=(*needs[4:], *needs[1:4]),
        )
        # Const cells come back batch-summed as scalars: give each its value's
        # own shape and dtype.
        d_flat = [None if d is None else d.reshape(v.shape).to(v.dtype)
                  for d, v in zip(d_flat, flat_values)]
        return (None, d_energy, d_mu, d_cov, *d_flat)


def fused_moment_sweep(
    build_fns: List[Callable],
    element_params: List[List[Tensor]],
    energy: Tensor,
    mu: Tensor,
    cov: Tensor,
) -> Tuple[Tensor, Tensor]:
    """All-dynamic convenience wrapper over :func:`fused_moment_sweep_plan`
    (every element's map rebuilt per setting in the kernel)."""
    plan = [("dyn", fn, list(params)) for fn, params in zip(build_fns, element_params)]
    return fused_moment_sweep_plan(plan, energy, mu, cov)


def fused_moment_sweep_plan(
    plan: List[tuple], energy: Tensor, mu: Tensor, cov: Tensor
) -> Tuple[Tensor, Tensor]:
    """Differentiable fused sweep over a mixed static/dynamic run plan.

    ``plan`` entries are ``("dyn", build_fn, [(B,) param tensors])`` for
    elements whose parameters vary per setting, or ``("const", layout,
    [(1,) cell tensors])`` for maximal groups of batch-invariant elements
    pre-composed once (``accelerator/fused.plan_run``).  ``energy`` is
    ``(B,)``, ``mu`` ``(B, 7)`` and ``cov`` ``(B, 7, 7)``; everything runs
    in ``mu``'s dtype.  Forward is kernel B3 on CUDA, backward kernel B4; on
    the CPU both take their plain versions."""
    if not plan:
        # A run can plan to nothing (only inactive diagnostics, whose
        # pure-identity const group plan_run drops): the identity.
        return mu, cov
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    flat_values = [v for _, _, values in plan for v in values]
    dtype = mu.dtype
    energy = torch.broadcast_to(energy.to(dtype), mu.shape[:1]).contiguous()
    return _FusedMomentSweep.apply(
        entries, energy, mu.contiguous(), cov.to(dtype).contiguous(), *flat_values
    )


# -- Kernel B2: the per-setting particle push ---------------------------------


def _layout_masks(layout) -> Tuple[int, int]:
    """Bit ``7 i + j`` of the first mask is set where the layout holds a
    structural zero, of the second where it holds a structural one."""
    zeros = ones = 0
    for i in range(7):
        for j in range(7):
            cell = layout[i][j]
            if isinstance(cell, float) and cell == 0.0:
                zeros |= 1 << (7 * i + j)
            elif isinstance(cell, float) and cell == 1.0:
                ones |= 1 << (7 * i + j)
    return zeros, ones


def _layout_and_matrix(total, B: int, dtype, device):
    """A composed table as B2 takes it: its ``_split_table`` layout and its
    cells as a ``(B, 49)`` row-major matrix."""
    layout, _ = _split_table(total)
    matrix = torch.stack(
        [tbl.broadcast_cell(c, (B,), dtype, device) for row in total for c in row], dim=-1
    )
    return layout, matrix


def particle_apply_reference(layout, matrix: Tensor, particles: Tensor) -> Tensor:
    """Plain PyTorch version of kernel B2: ``out[b, n, i] = sum_j
    T_b[i, j] p[b, n, j]`` with ``T_b`` row ``b`` of the ``(B, 49)``
    ``matrix``, summed in ``j`` order over the cells the layout does not
    mark as structural zeros (a structural one adds the coordinate)."""
    coords = [particles[..., j] for j in range(7)]
    rows = []
    for i in range(7):
        acc = None
        for j in range(7):
            cell = layout[i][j]
            if isinstance(cell, float) and cell == 0.0:
                continue
            if isinstance(cell, float) and cell == 1.0:
                term = coords[j]
            else:
                term = matrix[:, 7 * i + j, None] * coords[j]
            acc = term if acc is None else acc + term
        rows.append(torch.zeros_like(coords[0]) if acc is None else acc)
    return torch.stack(rows, dim=-1)


#: C signature of B2's entry point: is_double, matrix, particles, out,
#: batch, n (64-bit), zero mask, one mask (64-bit), stream.
_B2_SIGNATURE = {
    "lynx_particle_apply": (
        ctypes.c_int,
        [ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_ulonglong, ctypes.c_ulonglong, _P],
    )
}


def particle_apply_library() -> ctypes.CDLL:
    """Kernel B2's library, built with nvcc at first use."""
    return load_library("particle_apply", _B2_SIGNATURE)


def _particle_apply_cuda(layout, matrix: Tensor, particles: Tensor) -> Tensor:
    """Launch kernel B2 on the current stream (no synchronisation)."""
    if particles.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"particle_apply: particles must be float32 or float64, got {particles.dtype}")
    for t in (matrix, particles):
        if not t.is_cuda or t.device != particles.device:
            raise ValueError("particle_apply: operands must share one CUDA device")
        if t.dtype != particles.dtype or not t.is_contiguous():
            raise ValueError(f"particle_apply: operands must be contiguous {particles.dtype}")
    if particles.ndim != 3 or particles.shape[-1] != 7:
        raise ValueError(f"particle_apply: particles must be (B, N, 7), got {tuple(particles.shape)}")
    B, N, _ = particles.shape
    if matrix.shape != (B, 49):
        raise ValueError(f"particle_apply: matrix must be (B, 49), got {tuple(matrix.shape)}")
    zeros, ones = _layout_masks(layout)
    out = torch.empty_like(particles)
    library = particle_apply_library()
    with torch.cuda.device(particles.device), profiling.span("kernel.particle_apply"):
        code = library.lynx_particle_apply(
            int(particles.dtype == torch.float64), matrix.data_ptr(), particles.data_ptr(),
            out.data_ptr(), B, N, zeros, ones,
            torch.cuda.current_stream(particles.device).cuda_stream,
        )
    check(library, code, "particle_apply")
    particle_apply.launches += 1
    return out


def particle_apply(layout, matrix: Tensor, particles: Tensor) -> Tensor:
    """Kernel B2: ``(B, N, 7)`` particles pushed through one 7x7 map per
    setting, given as the ``(B, 49)`` row-major ``matrix`` and the static
    ``layout`` of structural zeros and ones (``_split_table``'s).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, :func:`particle_apply_reference`."""
    if particles.device.type == "cpu":
        return particle_apply_reference(layout, matrix, particles)
    return _particle_apply_cuda(layout, matrix, particles)


particle_apply.launches = 0


class _ParticleApply(torch.autograd.Function):
    """B2 and its backward: the push is bilinear, so ``d_particles`` is B2
    on the transposed map and ``d_matrix`` one batched matmul."""

    @staticmethod
    def forward(ctx, layout, matrix, particles):
        ctx.layout = layout
        ctx.save_for_backward(matrix, particles)
        return particle_apply(layout, matrix, particles)

    @staticmethod
    def backward(ctx, d_out):
        matrix, particles = ctx.saved_tensors
        B = matrix.shape[0]
        d_out = d_out.contiguous()
        matrix_t = matrix.reshape(B, 7, 7).transpose(1, 2).reshape(B, 49).contiguous()
        d_particles = particle_apply(_transpose_layout(ctx.layout), matrix_t, d_out)
        # d_T[b, i, j] = sum_n d_out[b, n, i] p[b, n, j]
        d_matrix = torch.matmul(d_out.transpose(1, 2), particles).reshape(B, 49)
        return None, d_matrix, d_particles


def fused_particle_sweep(
    build_fns: List[Callable],
    element_params: List[List[Tensor]],
    energy: Tensor,
    particles: Tensor,
) -> Tensor:
    """Track ``(B, N, 7)`` particles through a linear run for B settings.

    Each setting's 7x7 map is composed once, as a sparse table of ``(B,)``
    cells in PyTorch; kernel B2 then applies it to every particle.
    Differentiable: parameter gradients flow back through the table
    composition."""
    dtype = particles.dtype
    entries = tuple(("dyn", build, len(params)) for build, params in zip(build_fns, element_params))
    flat_values = [p.to(dtype) for params in element_params for p in params]
    total = _compose_entries(entries, flat_values, energy.to(dtype))
    layout, matrix = _layout_and_matrix(total, particles.shape[0], dtype, particles.device)
    return _ParticleApply.apply(layout, matrix, particles.contiguous())


# -- Kernel B8: the particle push with its maps built on the card --------------


def particle_push_reference(entries, flat_values, energy: Tensor, particles: Tensor) -> Tensor:
    """Plain PyTorch version of kernel B8: the plan's tables composed as
    B3's plain version composes them (:func:`_compose_entries`), then B2's
    plain push of the ``(B, N, 7)`` particles through each setting's map,
    skipping the composed layout's structural zeros and ones."""
    total = _compose_entries(entries, flat_values, energy)
    layout, matrix = _layout_and_matrix(total, particles.shape[0], particles.dtype,
                                        particles.device)
    return particle_apply_reference(layout, matrix, particles)


#: B8's structural masks by plan structure: the composed layout of the
#: builders' tables, which is a property of the structure alone.
_PUSH_MASKS: dict = {}


def _push_masks(entries) -> Tuple[int, int]:
    """``_layout_masks`` of the plan's composed layout (the one
    :func:`particle_push_reference` skips over), found once per structure by
    composing the builders' tables on stand-in values on the CPU."""
    key = _tape_key(entries, "cpu")[0]
    if key not in _PUSH_MASKS:
        stand_in = [torch.full((1,), 0.5, dtype=torch.float64)] * sum(c for _, _, c in entries)
        total = _compose_entries(entries, stand_in, torch.full((1,), 1e8, dtype=torch.float64))
        _PUSH_MASKS[key] = _layout_masks(_split_table(total)[0])
    return _PUSH_MASKS[key]


#: C signature of B8's entry point: is_double, full, tape, n_entries, params,
#: consts, energy, particles, out, batch, n, zero mask, one mask (64-bit),
#: rest energy, electron mass, stream.
_B8_SIGNATURE = {
    "lynx_particle_push": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, _P, ctypes.c_int] + [_P] * 5
        + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_ulonglong,
           ctypes.c_double, ctypes.c_double, _P],
    )
}


def particle_push_library() -> ctypes.CDLL:
    """Kernel B8's library, built with nvcc at first use."""
    return load_library("particle_push", _B8_SIGNATURE)


def _particle_push_cuda(entries, flat_values, energy: Tensor, particles: Tensor) -> Tensor:
    """Launch kernel B8 on the current stream (no synchronisation)."""
    if particles.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"particle_push: particles must be float32 or float64, got {particles.dtype}")
    for t in (energy, particles):
        if not t.is_cuda or t.device != particles.device:
            raise ValueError("particle_push: operands must share one CUDA device")
        if t.dtype != particles.dtype or not t.is_contiguous():
            raise ValueError(f"particle_push: operands must be contiguous {particles.dtype}")
    if particles.ndim != 3 or particles.shape[-1] != 7:
        raise ValueError(f"particle_push: particles must be (B, N, 7), got {tuple(particles.shape)}")
    B, N, _ = particles.shape
    if energy.shape != (B,):
        raise ValueError(f"particle_push: energy must be ({B},), got {tuple(energy.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (energy, particles, *flat_values)):
        raise ValueError("particle_push: the kernel has no backward; an input requires grad")
    dtype, device = particles.dtype, particles.device
    tape = _tape(entries, device)
    params, consts = _tape_operands(entries, flat_values, tape, dtype, B)
    zeros, ones = _push_masks(entries)
    out = torch.empty_like(particles)
    library = particle_push_library()
    with torch.cuda.device(device), profiling.span("kernel.particle_push"):
        code = library.lynx_particle_push(
            int(dtype == torch.float64), int(tape.full), tape.rows.data_ptr(), tape.rows.shape[0],
            params.data_ptr(), consts.data_ptr(), energy.data_ptr(), particles.data_ptr(),
            out.data_ptr(), B, N, zeros, ones, REST_ENERGY_EV, ELECTRON_MASS_EV,
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(library, code, "particle_push")
    particle_push.launches += 1
    return out


def particle_push(entries, flat_values, energy: Tensor, particles: Tensor) -> Tensor:
    """Kernel B8: ``(B, N, 7)`` particles pushed through a plan's composed
    map, built per setting from the ``(B,)`` flat values (``entries`` and
    ``flat_values`` as :func:`moment_sweep` takes them) at the ``(B,)``
    energy.  Not differentiable: a run that needs a gradient takes another
    route.

    ``energy`` and ``particles`` share one dtype (float32 or float64), which
    the kernel computes in; the flat values are cast to it.  A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain version,
    :func:`particle_push_reference`."""
    if particles.device.type == "cpu":
        flat_values = [v.to(particles.dtype) for v in flat_values]
        return particle_push_reference(entries, flat_values, energy, particles)
    return _particle_push_cuda(entries, flat_values, energy, particles)


particle_push.launches = 0


# -- Kernel B10: a run's maps folded per setting on the card -------------------

#: B10's composed layouts by plan structure (see :func:`_fold_layout`).
_FOLD_LAYOUTS: dict = {}


def _fold_layout(entries) -> Tuple[list, int]:
    """``(layout, cells)``: the ``_split_table`` layout of an all-dynamic
    plan's composed table and the mask of its non-literal cells (bit ``7 i +
    j``), found once per structure by composing the builders' tables on
    stand-in values on the CPU, as :func:`_push_masks` does: which cells are
    literals depends on the structure alone."""
    key = _tape_key(entries, "cpu")[0]
    if key not in _FOLD_LAYOUTS:
        stand_in = [torch.full((1,), 0.5, dtype=torch.float64)] * sum(c for _, _, c in entries)
        total = _compose_entries(entries, stand_in, torch.full((1,), 1e8, dtype=torch.float64))
        layout, _ = _split_table(total)
        cells = sum(1 << (7 * i + j) for i in range(7) for j in range(7)
                    if not isinstance(layout[i][j], float))
        _FOLD_LAYOUTS[key] = layout, cells
    return _FOLD_LAYOUTS[key]


def map_fold_reference(entries, flat_values, energy: Tensor) -> Tensor:
    """Plain PyTorch version of kernel B10: the plan's tables composed as
    B3's plain version composes them (:func:`_compose_entries`), and the
    composed table's non-literal cells, in ``_split_table``'s order, stacked
    as ``(n_cells, B)`` for the ``(B,)`` energy's settings."""
    total = _compose_entries(entries, flat_values, energy)
    B, dtype, device = energy.shape[0], energy.dtype, energy.device
    cells = [tbl.broadcast_cell(c, (B,), dtype, device)
             for row in total for c in row if not tbl._is_literal(c)]
    return torch.stack(cells) if cells else torch.empty((0, B), dtype=dtype, device=device)


#: C signature of B10's entry point: is_double, full, tape, n_entries, params,
#: consts, energy, out, batch, cell mask (64-bit), rest energy, electron mass,
#: stream.
_B10_SIGNATURE = {
    "lynx_map_fold": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, _P, ctypes.c_int] + [_P] * 4
        + [ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_double, ctypes.c_double, _P],
    )
}


def map_fold_library() -> ctypes.CDLL:
    """Kernel B10's library, built with nvcc at first use."""
    return load_library("map_fold", _B10_SIGNATURE)


def _map_fold_cuda(entries, flat_values, energy: Tensor) -> Tensor:
    """Launch kernel B10 on the current stream (no synchronisation)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (energy, *flat_values)):
        raise ValueError("map_fold: the kernel has no backward; an input requires grad")
    if energy.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"map_fold: the energy must be float32 or float64, got {energy.dtype}")
    if not energy.is_cuda or energy.ndim != 1 or not energy.is_contiguous():
        raise ValueError(f"map_fold: the energy must be a contiguous (B,) CUDA tensor, got"
                         f" {tuple(energy.shape)} on {energy.device}")
    B, dtype, device = energy.shape[0], energy.dtype, energy.device
    tape = _tape(entries, device)
    params, consts = _tape_operands(entries, flat_values, tape, dtype, B)
    _, cells = _fold_layout(entries)
    out = torch.empty((bin(cells).count("1"), B), dtype=dtype, device=device)
    library = map_fold_library()
    with torch.cuda.device(device):
        code = library.lynx_map_fold(
            int(dtype == torch.float64), int(tape.full), tape.rows.data_ptr(), tape.rows.shape[0],
            params.data_ptr(), consts.data_ptr(), energy.data_ptr(), out.data_ptr(), B, cells,
            REST_ENERGY_EV, ELECTRON_MASS_EV, torch.cuda.current_stream(device).cuda_stream,
        )
    check(library, code, "map_fold")
    map_fold.launches += 1
    return out


def map_fold(entries, flat_values, energy: Tensor) -> Tensor:
    """Kernel B10: a plan's composed map built per setting from the ``(B,)``
    flat values (``entries`` and ``flat_values`` as :func:`moment_sweep`
    takes them, every entry dynamic) at the ``(B,)`` energy, returned as the
    composed layout's non-literal cells (:func:`_fold_layout`), ``(n_cells,
    B)`` in ``_split_table``'s order.  Not differentiable: a plan that needs
    a gradient takes the table algebra.

    The kernel computes in the energy's dtype (float32 or float64); the flat
    values are cast to it.  A CUDA energy launches the kernel (or raises); a
    CPU energy takes the plain version, :func:`map_fold_reference`."""
    if energy.device.type == "cpu":
        return map_fold_reference(entries, [v.to(energy.dtype) for v in flat_values], energy)
    return _map_fold_cuda(entries, flat_values, energy)


map_fold.launches = 0


# -- The particle moment sweep: kernels B5 and B6 ------------------------------
#
# One shared particle cloud observed under B settings of a plan of sparse
# affine maps and active apertures (``accelerator/fused.particle_moment_plan``).
# Plan entries are ``("map", layout)``, whose dynamic cells index a flat tuple
# of ``(B,)`` per-setting scalars, and ``("aperture", x_idx, y_idx, cx_idx,
# cy_idx, shape)``, which multiplies the survival weights by the aperture's
# mask at the current coordinates offset by the plane centre ``(cx, cy)``.

#: Upper-triangle order of the 28 second-moment sums.
_S2_POSITIONS = tuple((r, c) for r in range(7) for c in range(r, 7))

#: Routing override: ``None`` = by device (the kernels for CUDA tensors, the
#: plain walk on the CPU), ``True``/``False`` force the kernel route (on the
#: CPU, the kernels' plain versions) or the plain walk whatever the device.
PARTICLE_MOMENT_SWEEP_PATH = None

#: Packed-Gram route (kernel B6) of the kernel route: ``None`` = for
#: B >= _PACK_SETTINGS settings, ``True``/``False`` force it on or off.
PACKED_MOMENT_SWEEP = None

#: Fewest settings that take B6 by default; fewer take the walk (B5).  The
#: JAX package's value, tuned on a TPU; the H100's crossover is in PERF.md.
_PACK_SETTINGS = 16

#: Settings per slice of the backward: autograd of the plain walk keeps
#: (slice, 7, N) coordinates per map entry, so the backward runs in slices to
#: bound its memory at any B.
_BWD_SETTING_CHUNK = 64


def _apply_layout_rows(layout, coords, cell_of):
    """Push 7 coordinate tensors through a sparse 7x7 layout; ``cell_of(k)``
    is the value of dynamic cell ``k``.  Structural zeros are skipped and
    structural ones add the coordinate itself."""
    pushed = []
    for r in range(7):
        acc = None
        for j in range(7):
            cell = layout[r][j]
            if isinstance(cell, float):
                if cell == 0.0:
                    continue
                term = coords[j] if cell == 1.0 else cell * coords[j]
            else:
                term = cell_of(cell) * coords[j]
            acc = term if acc is None else acc + term
        pushed.append(acc if acc is not None else torch.zeros_like(coords[0]))
    return pushed


def _aperture_mask(xs, ys, x_max, y_max, shape):
    """Survival mask matching ``accelerator.aperture.aperture_survival_mask``
    (rectangular strict, elliptical inclusive)."""
    if shape == "rectangular":
        return (xs > -x_max) & (xs < x_max) & (ys > -y_max) & (ys < y_max)
    return (xs**2 / x_max**2 + ys**2 / y_max**2) <= 1.0


def _moment_sweep_reference(entries, scalars, particles, weights):
    """Plain version of kernel B5: the walk over dense ``(B, N)`` coordinate
    tensors, returning ``(s1 (B, 7), s2 (B, 7, 7), w_sum (B,))``, the
    weighted moment sums after the plan.  Differentiable: the sweep's
    backward is autograd of this function."""
    B, N = scalars[0].shape[0], particles.shape[0]
    coords = [particles[:, j].expand(B, N) for j in range(7)]
    w = weights.expand(B, N)
    for entry in entries:
        if entry[0] == "map":
            coords = _apply_layout_rows(entry[1], coords, lambda k: scalars[k][:, None])
        else:
            _, x_idx, y_idx, cx_idx, cy_idx, shape = entry
            mask = _aperture_mask(
                coords[0] + scalars[cx_idx][:, None],
                coords[2] + scalars[cy_idx][:, None],
                scalars[x_idx][:, None],
                scalars[y_idx][:, None],
                shape,
            )
            w = w * mask.to(w.dtype)
    coords = torch.stack(coords, dim=1)
    weighted = w[:, None, :] * coords
    s1 = weighted.sum(dim=-1)
    s2 = torch.einsum("bin,bjn->bij", weighted, coords)
    return s1, s2, w.sum(dim=-1)


def particle_moments_from_sums(s1: Tensor, s2: Tensor, w_sum: Tensor) -> Tuple[Tensor, Tensor]:
    """``(mu, cov)`` from weighted moment sums, with the package's statistics
    conventions: weight-sum normalisation for the mean, Bessel ``max(W - 1,
    1)`` for the covariance, so that ``sqrt(cov[r, r])`` is ``sigma_*``.  A
    setting that lost every particle gives zeros, not NaN."""
    total = torch.where(w_sum == 0, torch.ones_like(w_sum), w_sum)
    mu = s1 / total[..., None]
    centered = s2 - w_sum[..., None, None] * (mu[..., :, None] * mu[..., None, :])
    denom = torch.clamp(w_sum - 1.0, min=1.0)
    return mu, centered / denom[..., None, None]


def _apply_layout_vector(layout, vector, scalars):
    """A sparse layout applied to a per-setting ``(B, 7)`` vector (dynamic
    cells index the ``(B,)`` ``scalars``)."""
    rows = _apply_layout_rows(layout, [vector[:, j] for j in range(7)], lambda k: scalars[k])
    return torch.stack(rows, dim=-1)


def _apply_layout_matrix_left(layout, mat, scalars):
    """``out[b, i, k] = sum_j layout[i][j] mat[b, j, k]`` with structural
    zeros skipped (dynamic cells are ``(B,)`` scalars)."""
    rows = _apply_layout_rows(
        layout, [mat[:, j, :] for j in range(7)], lambda k: scalars[k][:, None]
    )
    return torch.stack(rows, dim=1)


def _moment_workspace(B: int, slots: int, dtype, device):
    """``(partials, scratch, out)`` of a B6 launch with ``slots`` partial
    sums per setting (``csrc/moment_sums.cuh``)."""
    partials = torch.empty((B, slots, 36), dtype=dtype, device=device)
    scratch = torch.empty((B, -(-slots // 64), 36), dtype=dtype, device=device)
    out = torch.empty((B, 36), dtype=dtype, device=device)
    return partials, scratch, out


#: Index tensors by (name, device): the gathers that unpack the kernels' 36
#: sums, built once per device.
_INDICES: dict = {}


def _index(name: str, values, device) -> Tensor:
    key = (name, str(device))
    if key not in _INDICES:
        _INDICES[key] = torch.tensor(values, dtype=torch.int64, device=device)
    return _INDICES[key]


def _upper(r: int, c: int, n: int) -> int:
    """Position of cell (min, max) of an n x n symmetric matrix in its
    row-major upper triangle."""
    r, c = min(r, c), max(r, c)
    return r * n - r * (r - 1) // 2 + (c - r)


def _check_cloud(what, particles, weights, *more):
    if particles.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: particles must be float32 or float64, got {particles.dtype}")
    for t in (particles, weights, *more):
        if not t.is_cuda or t.device != particles.device:
            raise ValueError(f"{what}: operands must share one CUDA device")
        if t.dtype != particles.dtype or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous {particles.dtype}")


# -- Kernel B5: the per-setting walk -------------------------------------------

#: B5's tape: one record of ``_WALK_RECORD`` int32 per plan entry, laid out as
#: ``csrc/particle_moment_sweep.cu`` reads it.  A map record holds its kind
#: and, from ``_WALK_CODES``, its 49 cell codes: ``_CODE_ZERO``,
#: ``_CODE_ONE``, ``-3 - i`` for literal ``i`` or the index of a scalar.  An
#: aperture record holds ``(kind, x_idx, y_idx, cx_idx, cy_idx, shape)``
#: with shape 0 for rectangular.
_WALK_MAP, _WALK_APERTURE = 0, 1
_WALK_RECORD, _WALK_CODES = 64, 8
_CODE_ZERO, _CODE_ONE = -1, -2


class WalkTape(NamedTuple):
    """B5's tape of a plan, on the kernel's device: ``records`` (E, 64)
    int32, the literal cells as ``literals`` (L,) float64, and the number
    of scalars the records index."""

    records: Tensor
    literals: Tensor
    n_scalars: int


_WALK_TAPES: dict = {}


def _walk_tape(entries, device) -> WalkTape:
    """B5's tape of a plan (see :class:`WalkTape`), built once per plan and
    device."""
    key = (entries, str(device))
    if key in _WALK_TAPES:
        return _WALK_TAPES[key]
    records, literals, indices = [], [], [0]
    for entry in entries:
        record = [0] * _WALK_RECORD
        if entry[0] == "map":
            record[0] = _WALK_MAP
            for r in range(7):
                for j in range(7):
                    cell = entry[1][r][j]
                    if not isinstance(cell, float):
                        code = cell
                        indices.append(cell)
                    elif cell == 0.0:
                        code = _CODE_ZERO
                    elif cell == 1.0:
                        code = _CODE_ONE
                    else:
                        code = -3 - len(literals)
                        literals.append(cell)
                    record[_WALK_CODES + 7 * r + j] = code
        else:
            _, x_idx, y_idx, cx_idx, cy_idx, shape = entry
            shape_code = 0 if shape == "rectangular" else 1
            record[:6] = [_WALK_APERTURE, x_idx, y_idx, cx_idx, cy_idx, shape_code]
            indices += [x_idx, y_idx, cx_idx, cy_idx]
        records.append(record)
    tape = WalkTape(
        records=torch.tensor(records, dtype=torch.int32).reshape(-1, _WALK_RECORD).to(device),
        literals=torch.tensor(literals, dtype=torch.float64).to(device),
        n_scalars=max(indices) + 1,
    )
    _WALK_TAPES[key] = tape
    return tape


#: C signatures of B5's entry points.  ``lynx_particle_moment_sweep``:
#: is_double, tape, n_entries, literals, scalars, cloud, weights, partials,
#: arrived, out, batch, n, spans, stream; it returns a CUDA error code, or
#: ``_B5_DOES_NOT_FIT``.  ``lynx_particle_moment_spans``: is_double, batch, n
#: -> the particle spans per setting of a launch (its blocks per setting).
_B5_SIGNATURE = {
    "lynx_particle_moment_sweep": (
        ctypes.c_int,
        [ctypes.c_int, _P, ctypes.c_int] + [_P] * 7 + [ctypes.c_longlong] * 3 + [_P],
    ),
    "lynx_particle_moment_spans": (
        ctypes.c_longlong, [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    ),
}
#: B5's return code when a block's resolved tape exceeds the device's shared
#: memory per block.
_B5_DOES_NOT_FIT = -1


def particle_moment_sweep_library() -> ctypes.CDLL:
    """Kernel B5's library, built with nvcc at first use."""
    return load_library("particle_moment_sweep", _B5_SIGNATURE)


def _walk_workspace(B: int, spans: int, dtype, device):
    """``(partials, arrived, out)`` of a B5 launch with ``spans`` blocks per
    setting: one partial sum per block, each setting's count of arrived
    blocks (zeroed) and the ``(B, 36)`` sums."""
    partials = torch.empty((B, spans, 36), dtype=dtype, device=device)
    arrived = torch.zeros((B,), dtype=torch.int32, device=device)
    out = torch.empty((B, 36), dtype=dtype, device=device)
    return partials, arrived, out


def _walk_sums(out: Tensor):
    """``(s1, s2, w_sum)`` from B5's ``(B, 36)`` sums."""
    B = out.shape[0]
    index = _index("s2", [7 + _upper(r, c, 7) for r in range(7) for c in range(7)], out.device)
    return out[:, :7], out[:, index].reshape(B, 7, 7), out[:, 35]


def _particle_moment_sweep_cuda(entries, scalars, particles, weights):
    """Launch kernel B5 on the current stream (no synchronisation)."""
    dtype, device = particles.dtype, particles.device
    if particles.ndim != 2 or particles.shape[1] != 7:
        raise ValueError(f"particle_moment_sweep: particles must be (N, 7), got {tuple(particles.shape)}")
    N, B = particles.shape[0], scalars[0].shape[0]
    stacked = torch.stack([torch.broadcast_to(s.to(dtype), (B,)) for s in scalars])
    cloud = particles.t().contiguous()
    weights = weights.to(dtype).contiguous()
    if weights.shape != (N,):
        raise ValueError(f"particle_moment_sweep: weights must be ({N},), got {tuple(weights.shape)}")
    _check_cloud("particle_moment_sweep", cloud, weights, stacked)
    tape = _walk_tape(entries, device)
    if len(scalars) < tape.n_scalars:
        raise ValueError(
            f"particle_moment_sweep: the plan indexes {tape.n_scalars} scalars, got {len(scalars)}"
        )
    literals = tape.literals.to(dtype)
    library = particle_moment_sweep_library()
    is_double = int(dtype == torch.float64)
    spans = library.lynx_particle_moment_spans(is_double, B, N)
    partials, arrived, out = _walk_workspace(B, spans, dtype, device)
    with torch.cuda.device(device), profiling.span("kernel.particle_moment_sweep"):
        code = library.lynx_particle_moment_sweep(
            is_double, tape.records.data_ptr(), tape.records.shape[0],
            literals.data_ptr(), stacked.data_ptr(), cloud.data_ptr(), weights.data_ptr(),
            partials.data_ptr(), arrived.data_ptr(), out.data_ptr(), B, N, spans,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if code == _B5_DOES_NOT_FIT:
        raise ValueError(
            f"particle_moment_sweep: the plan's {tape.records.shape[0]} entries do not fit in"
            f" the device's shared memory per block ({dtype})"
        )
    check(library, code, "particle_moment_sweep")
    particle_moment_sweep.launches += 1
    return _walk_sums(out)


def particle_moment_sweep(entries, scalars, particles: Tensor, weights: Tensor):
    """Kernel B5: ``(s1 (B, 7), s2 (B, 7, 7), w_sum (B,))``, the weighted
    moment sums of the ``(N, 7)`` cloud with ``(N,)`` initial weights after
    the plan, one setting at a time.

    A CUDA tensor launches the kernel (or raises), in the cloud's dtype, to
    which the scalars and weights are cast; a CPU tensor takes the plain
    version, :func:`_moment_sweep_reference`."""
    if particles.device.type == "cpu":
        return _moment_sweep_reference(entries, scalars, particles, weights)
    return _particle_moment_sweep_cuda(entries, scalars, particles, weights)


particle_moment_sweep.launches = 0


# -- Kernel B6: the packed Gram ------------------------------------------------


def _packed_prefix_rows(entries, scalars):
    """The plan as B6 takes it: for each aperture, rows 0 and 2 of the map
    prefix composed up to it (its x and y planes), encoded like map layouts
    (a float literal or an index into the extended scalars); and the total
    map's layout.

    Returns ``(aperture_specs, total_layout, extended_scalars)``, each spec
    ``(x_row, y_row, x_idx, y_idx, cx_idx, cy_idx, shape)`` with 7-tuple
    rows."""
    extended = list(scalars)
    prefix = tbl.identity_table()
    aperture_specs = []
    for entry in entries:
        if entry[0] == "map":
            prefix = tbl.compose(_table_from_layout(entry[1], scalars), prefix)
            continue
        _, x_idx, y_idx, cx_idx, cy_idx, shape = entry

        def encode_row(r):
            spec = []
            for j in range(7):
                cell = prefix[r][j]
                if tbl._is_literal(cell):
                    spec.append(float(cell))
                else:
                    spec.append(len(extended))
                    extended.append(cell)
            return tuple(spec)

        aperture_specs.append((encode_row(0), encode_row(2), x_idx, y_idx, cx_idx, cy_idx, shape))
    layout, cells = _split_table(prefix)
    offset = len(extended)
    extended.extend(cells)
    total_layout = tuple(
        tuple(c if isinstance(c, float) else c + offset for c in row) for row in layout
    )
    return tuple(aperture_specs), total_layout, tuple(extended)


def packed_gram_reference(apertures, planes: Tensor, bounds: Tensor, aug: Tensor, w0: Tensor) -> Tensor:
    """Plain version of kernel B6: the ``(B, 8, 8)`` joint Gram ``sum_n W
    aug_j aug_k`` of the augmented cloud ``aug`` (8, N) under B settings.

    ``apertures`` is static, one ``(shape, x_rows, y_rows)`` per aperture,
    the rows naming the aug row of each of its plane rows; ``planes`` (R, B)
    holds the plane rows of all apertures in that order (x then y), and
    ``bounds`` (A, 4, B) each aperture's ``[x_max, y_max, 1/x_max^2,
    1/y_max^2]``.  ``W = w0 * prod_a mask_a`` with the TPU kernel's mask
    formulas; then one einsum for the Gram."""
    B, N = planes.shape[1], aug.shape[1]
    W = w0.expand(B, N)
    row = 0

    def plane(aug_rows):
        nonlocal row
        acc = None
        for j in aug_rows:
            term = planes[row][:, None] * aug[j][None, :]
            acc = term if acc is None else acc + term
            row += 1
        return acc

    for a, (shape, x_rows, y_rows) in enumerate(apertures):
        px = plane(x_rows)
        if shape == "rectangular":
            x_max = bounds[a, 0][:, None]
            W = W * ((px > -x_max) & (px < x_max)).to(W.dtype)
            py = plane(y_rows)
            y_max = bounds[a, 1][:, None]
            W = W * ((py > -y_max) & (py < y_max)).to(W.dtype)
        else:
            t = px * px * bounds[a, 2][:, None]
            py = plane(y_rows)
            W = W * ((t + py * py * bounds[a, 3][:, None]) <= 1.0).to(W.dtype)
    pairs = aug[:, None, :] * aug[None, :, :]
    return torch.einsum("bn,jkn->bjk", W, pairs)


#: B6's aperture records, as ``csrc/packed_gram.cu`` reads them: (shape, first
#: x plane row, x row count, first y plane row, y row count, 3 unused).
_GRAM_RECORD = 8


class GramTape(NamedTuple):
    """B6's tape of an aperture layout, on the kernel's device: ``records``
    (A, 8) int32 and ``row_index`` (R,) int32, the aug row of each plane
    row."""

    records: Tensor
    row_index: Tensor


_GRAM_TAPES: dict = {}


def _gram_tape(apertures, device) -> GramTape:
    key = (apertures, str(device))
    if key in _GRAM_TAPES:
        return _GRAM_TAPES[key]
    records, row_index = [], []
    for shape, x_rows, y_rows in apertures:
        for rows in (x_rows, y_rows):
            if list(rows) != sorted(set(rows)) or not all(0 <= j < 8 for j in rows):
                raise ValueError(
                    f"packed_gram: a plane's rows must be distinct aug rows in ascending"
                    f" order, got {rows}"
                )
        x_start = len(row_index)
        row_index.extend(x_rows)
        y_start = len(row_index)
        row_index.extend(y_rows)
        records.append([0 if shape == "rectangular" else 1, x_start, len(x_rows), y_start,
                        len(y_rows), 0, 0, 0])
    tape = GramTape(
        records=torch.tensor(records, dtype=torch.int32).reshape(-1, _GRAM_RECORD).to(device),
        row_index=torch.tensor(row_index, dtype=torch.int32).to(device),
    )
    _GRAM_TAPES[key] = tape
    return tape


#: C signatures of B6's entry points.  ``lynx_packed_gram``: is_double,
#: apertures, n_apertures, row_index, n_rows, planes, bounds, aug, w0,
#: partials, scratch, out, batch, n, splits, stream; it returns a CUDA error
#: code, or ``_B6_DOES_NOT_FIT``.  ``lynx_packed_gram_splits``: is_double,
#: batch, n -> the particle splits of a launch (its partial sums per
#: setting).
_B6_SIGNATURE = {
    "lynx_packed_gram": (
        ctypes.c_int,
        [ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 7
        + [ctypes.c_longlong] * 3 + [_P],
    ),
    "lynx_packed_gram_splits": (
        ctypes.c_longlong, [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    ),
}
#: B6's return code when a block's plane coefficients and bounds exceed the
#: device's shared memory per block.
_B6_DOES_NOT_FIT = -1


def packed_gram_library() -> ctypes.CDLL:
    """Kernel B6's library, built with nvcc at first use."""
    return load_library("packed_gram", _B6_SIGNATURE)


def _packed_gram_cuda(apertures, planes, bounds, aug, w0):
    """Launch kernel B6 on the current stream (no synchronisation)."""
    _check_cloud("packed_gram", aug, w0, planes, bounds)
    dtype, device = aug.dtype, aug.device
    tape = _gram_tape(apertures, device)
    B, N = planes.shape[1], aug.shape[1]
    if (aug.shape[0] != 8 or w0.shape != (N,) or planes.shape[0] != tape.row_index.shape[0]
            or bounds.shape != (len(apertures), 4, B)):
        raise ValueError(
            "packed_gram: expected aug (8, N), w0 (N,), planes (R, B) and bounds (A, 4, B), got"
            f" {tuple(aug.shape)}, {tuple(w0.shape)}, {tuple(planes.shape)}, {tuple(bounds.shape)}"
        )
    library = packed_gram_library()
    is_double = int(dtype == torch.float64)
    splits = library.lynx_packed_gram_splits(is_double, B, N)
    partials, scratch, out = _moment_workspace(B, splits, dtype, device)
    with torch.cuda.device(device), profiling.span("kernel.packed_gram"):
        code = library.lynx_packed_gram(
            is_double, tape.records.data_ptr(), len(apertures),
            tape.row_index.data_ptr(), tape.row_index.shape[0], planes.data_ptr(),
            bounds.data_ptr(), aug.data_ptr(), w0.data_ptr(), partials.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, N, splits,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if code == _B6_DOES_NOT_FIT:
        raise ValueError(
            f"packed_gram: the plane coefficients and bounds of {len(apertures)} apertures do"
            f" not fit in the device's shared memory per block ({dtype})"
        )
    check(library, code, "packed_gram")
    packed_gram.launches += 1
    index = _index("gram", [_upper(j, k, 8) for j in range(8) for k in range(8)], device)
    return out[:, index].reshape(B, 8, 8)


def packed_gram(apertures, planes: Tensor, bounds: Tensor, aug: Tensor, w0: Tensor) -> Tensor:
    """Kernel B6: the ``(B, 8, 8)`` joint Gram of :func:`packed_gram_reference`.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    if aug.device.type == "cpu":
        return packed_gram_reference(apertures, planes, bounds, aug, w0)
    return _packed_gram_cuda(apertures, planes, bounds, aug, w0)


packed_gram.launches = 0


def _packed_operands(entries, scalars, particles, weights):
    """B6's operands from a plan: ``(apertures, planes, bounds, aug, w0)``
    as :func:`packed_gram` takes them, and the total map as ``(layout,
    extended scalars)``."""
    N, B = particles.shape[0], scalars[0].shape[0]
    dtype, device = particles.dtype, particles.device
    specs, total_layout, extended = _packed_prefix_rows(entries, scalars)
    extended = tuple(torch.broadcast_to(v.to(dtype), (B,)) for v in extended)

    def row_columns(row_spec, center_idx):
        # The statically nonzero prefix-row cells, plus the plane centre,
        # which pairs with aug's valid row (7).
        columns, aug_rows = [], []
        for j, cell in enumerate(row_spec):
            if isinstance(cell, float):
                if cell == 0.0:
                    continue
                columns.append(torch.full((B,), cell, dtype=dtype, device=device))
            else:
                columns.append(extended[cell])
            aug_rows.append(j)
        columns.append(extended[center_idx])
        aug_rows.append(7)
        return columns, tuple(aug_rows)

    apertures, rows, bounds = [], [], []
    for x_row, y_row, x_idx, y_idx, cx_idx, cy_idx, shape in specs:
        x_columns, x_rows = row_columns(x_row, cx_idx)
        y_columns, y_rows = row_columns(y_row, cy_idx)
        rows += x_columns + y_columns
        apertures.append((shape, x_rows, y_rows))
        x_max, y_max = extended[x_idx], extended[y_idx]
        bounds.append(torch.stack([x_max, y_max, 1.0 / (x_max * x_max), 1.0 / (y_max * y_max)]))
    planes = torch.stack(rows) if rows else torch.empty((0, B), dtype=dtype, device=device)
    bounds = torch.stack(bounds) if bounds else torch.empty((0, 4, B), dtype=dtype, device=device)
    aug = torch.cat([particles.t(), torch.ones((1, N), dtype=dtype, device=device)]).contiguous()
    operands = (tuple(apertures), planes, bounds, aug, weights.to(dtype).contiguous())
    return operands, (total_layout, extended)


def _moment_sweep_packed(entries, scalars, particles, weights):
    """B6's route: the aperture planes, bounds and augmented cloud from the
    plan, kernel B6 for the joint Gram, then the exact affine sandwich
    ``s2 = T G T^T`` and ``s1 = T g`` in PyTorch, as the JAX package does
    outside its kernel."""
    operands, (total_layout, extended) = _packed_operands(entries, scalars, particles, weights)
    gram = packed_gram(*operands)
    s1_delta, s2_delta, w_sum = gram[:, 7, :7], gram[:, :7, :7], gram[:, 7, 7]
    s1 = _apply_layout_vector(total_layout, s1_delta, extended)
    left = _apply_layout_matrix_left(total_layout, s2_delta, extended)
    s2 = _apply_layout_matrix_left(total_layout, left.transpose(-1, -2), extended).transpose(-1, -2)
    return s1, s2, w_sum


# -- The sweep: routing and backward -------------------------------------------


def _moment_sweep_vjp(entries, scalars, particles, weights, cotangents):
    """Autograd of :func:`_moment_sweep_reference` for one slice of
    settings: ``(d_scalars, d_particles, d_weights)``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (*scalars, particles, weights)]
        n = len(scalars)
        out = _moment_sweep_reference(entries, inputs[:n], inputs[n], inputs[n + 1])
        grads = torch.autograd.grad(out, inputs, cotangents, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    return grads[:n], grads[n], grads[n + 1]


class _ParticleMomentSweep(torch.autograd.Function):
    """Forward: kernel B5 for fewer than ``_PACK_SETTINGS`` settings, B6's
    route for more (``PACKED_MOMENT_SWEEP`` forces either).  Backward: the
    JAX package's design, autograd of the plain walk over slices of
    ``_BWD_SETTING_CHUNK`` settings, scalar cotangents concatenated and the
    particles' and weights' summed."""

    @staticmethod
    def forward(ctx, entries, particles, weights, *scalars):
        ctx.entries = entries
        ctx.save_for_backward(particles, weights, *scalars)
        packed = PACKED_MOMENT_SWEEP
        if packed is None:
            packed = scalars[0].shape[0] >= _PACK_SETTINGS
        sweep = _moment_sweep_packed if packed else particle_moment_sweep
        return sweep(entries, scalars, particles, weights)

    @staticmethod
    def backward(ctx, d_s1, d_s2, d_w):
        particles, weights, *scalars = ctx.saved_tensors
        B = scalars[0].shape[0]
        d_scalars = [[] for _ in scalars]
        d_particles = torch.zeros_like(particles)
        d_weights = torch.zeros_like(weights)
        for lo in range(0, B, _BWD_SETTING_CHUNK):
            hi = min(lo + _BWD_SETTING_CHUNK, B)
            ds, dp, dw = _moment_sweep_vjp(
                ctx.entries, [s[lo:hi] for s in scalars], particles, weights,
                (d_s1[lo:hi], d_s2[lo:hi], d_w[lo:hi]),
            )
            for pieces, d in zip(d_scalars, ds):
                pieces.append(d)
            d_particles = d_particles + dp
            d_weights = d_weights + dw
        return (None, d_particles, d_weights, *(torch.cat(p) for p in d_scalars))


def _settings_axis(scalars, batch_size, particles):
    """The plan's scalars, or for a plan with none (an identity-only
    lattice carries no settings axis) one zero scalar of ``batch_size``
    settings."""
    if scalars:
        return scalars
    if batch_size is None:
        raise ValueError(
            "the plan has no per-setting scalars (identity-only lattice);"
            " pass batch_size= to define the settings axis"
        )
    return (torch.zeros((batch_size,), dtype=particles.dtype, device=particles.device),)


def fused_particle_moment_sweep(
    entries: tuple,
    scalars: tuple,
    particles: Tensor,
    weights: Tensor,
    batch_size: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Survival-weighted moment sums of ONE shared particle cloud observed
    under B settings (counterpart of
    ``lynx_tpu.ops.pallas_track.fused_particle_moment_sweep``).

    :param entries: static plan: ``("map", layout)`` applies a composed
        sparse affine map whose dynamic cells index ``scalars``;
        ``("aperture", x_idx, y_idx, cx_idx, cy_idx, shape)`` multiplies the
        weights by the aperture's mask at the current coordinates offset by
        the plane centre ``(cx, cy)``.
    :param scalars: flat tuple of ``(B,)`` per-setting scalars.
    :param particles: ``(N, 7)`` shared cloud.
    :param weights: ``(N,)`` initial survival weights.
    :param batch_size: B, required when the plan has no scalars (an
        identity-only lattice carries no settings axis).
    :return: ``(s1 (B, 7), s2 (B, 7, 7), w_sum (B,))`` after the plan;
        :func:`particle_moments_from_sums` converts them.

    CUDA tensors take kernel B5 (B < 16) or B6 (B >= 16); CPU tensors the
    plain walk; ``PARTICLE_MOMENT_SWEEP_PATH`` and ``PACKED_MOMENT_SWEEP``
    force the routes.  The kernel route runs in the cloud's dtype.
    Differentiable: the backward is autograd of the plain walk, in slices of
    64 settings.
    """
    scalars = _settings_axis(scalars, batch_size, particles)
    use_kernels = PARTICLE_MOMENT_SWEEP_PATH
    if use_kernels is None:
        use_kernels = particles.is_cuda
    if not use_kernels:
        return _moment_sweep_reference(entries, scalars, particles, weights)
    dtype = particles.dtype
    return _ParticleMomentSweep.apply(
        entries, particles, weights.to(dtype), *(s.to(dtype) for s in scalars)
    )


def _centered_plan(entries, scalars, particles, weights):
    """The kernels' operands of :func:`sweep_particle_moments`:
    ``(kernel_entries, scalars, delta, image)`` with the deviation cloud
    ``delta`` about the weighted centre (``delta[:, 6] = 0``), each
    aperture's plane centre appended to the scalars, and the centre's
    ``(B, 7)`` image through the whole plan."""
    B, dtype = scalars[0].shape[0], particles.dtype
    total_w = weights.sum()
    total_w = torch.where(total_w == 0, torch.ones_like(total_w), total_w)
    center = (particles * weights[:, None]).sum(dim=0) / total_w
    center = torch.cat([center[:6], torch.ones_like(center[6:])])
    delta = particles - center

    # Walk the plan once in PyTorch, tracking the centre's per-setting image
    # for the apertures' offsets and the final mean.
    image = center.to(dtype).expand(B, 7)
    scalars = tuple(s.to(dtype) for s in scalars)
    kernel_entries = []
    extra = list(scalars)
    for entry in entries:
        if entry[0] == "map":
            kernel_entries.append(entry)
            image = _apply_layout_vector(entry[1], image, scalars)
        else:
            _, x_idx, y_idx, shape = entry
            cx_idx = len(extra)
            extra.append(image[:, 0])
            cy_idx = len(extra)
            extra.append(image[:, 2])
            kernel_entries.append(("aperture", x_idx, y_idx, cx_idx, cy_idx, shape))
    return tuple(kernel_entries), tuple(extra), delta, image


def sweep_particle_moments(
    entries: tuple,
    scalars: tuple,
    particles: Tensor,
    weights: Tensor,
    batch_size: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-setting ``(mu (B, 7), cov (B, 7, 7), w_sum (B,))`` of the shared
    cloud after a ``particle_moment_plan`` plan (4-field ``("aperture",
    x_idx, y_idx, shape)`` entries), free of cancellation.

    Raw second moments lose ~|mu|/sigma digits in float32 when the
    covariance is formed from them.  So the sweep runs on the deviation
    cloud ``delta = x - c`` about the weighted centre ``c`` with ``c[6] =
    1``: delta's homogeneous component is 0, which switches every affine
    column off.  The centre's per-setting image through the maps gives each
    aperture its plane centre ``(cx, cy)`` (affine maps commute with ``x = c
    + delta``), and the result is ``mu = image + s1/W`` with the covariance
    from the deviation sums.

    The centre and its walk run in the span ``particle.center``;
    ``sweep_particle_moments.particle_settings`` counts the settings times
    the particles swept, summed over the calls issued (a replay issues
    none), as the kernels' wrappers count their ``launches``."""
    scalars = _settings_axis(scalars, batch_size, particles)
    with profiling.span("particle.center"):
        kernel_entries, extra, delta, image = _centered_plan(entries, scalars, particles, weights)
    s1, s2, w_sum = fused_particle_moment_sweep(kernel_entries, extra, delta, weights)
    sweep_particle_moments.particle_settings += scalars[0].shape[0] * particles.shape[0]
    # The deviation cloud's mean is the shift from the tracked image.
    shift, cov = particle_moments_from_sums(s1, s2, w_sum)
    return image + shift, cov, w_sum


sweep_particle_moments.particle_settings = 0
