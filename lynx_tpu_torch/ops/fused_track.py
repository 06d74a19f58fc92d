"""Fused batched-settings tracking (counterpart of ``lynx_tpu.ops.pallas_track``):
the ParameterBeam settings sweep with its gradient, and the per-setting
particle push.

Three hand-written CUDA kernels carry it on the card, each beside its plain
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

A plan (``accelerator/fused.plan_run``) reaches the kernels as a small op
tape: one entry per plan entry, ``(kind, offset, cell_start, cell_count)``
(:func:`_tape`).  A wrapper takes the plain version for CPU tensors and
launches its kernel (or raises) for CUDA tensors; it never synchronises the
host, and ``<wrapper>.launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Tuple

import torch

from lynx_tpu_torch._build import check, load_library
from lynx_tpu_torch.constants import REST_ENERGY_EV
from lynx_tpu_torch.ops import table as tbl

Tensor = torch.Tensor

#: Tape kinds: the kernels' device function for each plan entry.  A dynamic
#: builder names its kind in its ``tape_kind`` attribute
#: (``accelerator/fused.py``); ``csrc/fused_builders.cuh`` has the same codes.
TAPE_CONST, TAPE_DRIFT, TAPE_QUAD, TAPE_HCOR, TAPE_VCOR, TAPE_IDENTITY = range(6)
_TAPE_PARAMS = {TAPE_DRIFT: 1, TAPE_QUAD: 5, TAPE_HCOR: 2, TAPE_VCOR: 2, TAPE_IDENTITY: 0}


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


def _table_reference_sweep(entries, flat_values, energy, mu, cov):
    """Plain PyTorch version of the fused sweep (same math, same builders):
    ``entries`` are ``(kind, meta, count)`` plan entries, ``flat_values`` the
    matching parameter/cell tensors in plan order, ``mu`` ``(B, 7)`` and
    ``cov`` ``(B, 7, 7)``.  Differentiable."""
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
    if total is None:
        total = tbl.identity_table()
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


def _reference_sweep_vjp(entries, flat_values, energy, mu, cov, dmu, dcov):
    """Plain version of B4: autograd of :func:`_table_reference_sweep`.
    Returns ``(d_flat_values, d_energy, d_mu, d_cov)``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (*flat_values, energy, mu, cov)]
        n = len(flat_values)
        out = _table_reference_sweep(entries, inputs[:n], *inputs[n:])
        grads = torch.autograd.grad(out, inputs, (dmu, dcov), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    return tuple(grads[:n]), grads[n], grads[n + 1], grads[n + 2]


# -- The op tape of B3 and B4 -----------------------------------------------

#: Tapes by plan structure and device: the tape depends only on the
#: structure, so it is copied to the card once per lattice.
_TAPES: dict = {}


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

    ``rows`` is ``(E, 4)`` int32, one ``(kind, offset, cell_start,
    cell_count)`` per entry: a dynamic entry's parameters are rows
    ``offset ...`` of the ``(P, B)`` parameter tensor; a const entry's dense
    49 cells are row ``offset`` of the ``(n_consts, 49)`` const tensor, and
    its ``cell_count`` non-literal cells, at positions ``cell_pos[cell_start
    ...]`` of the 49, are the ones whose cotangents B4 writes out.
    ``literals`` is the const tensor with the literal cells filled in and
    zeros elsewhere; ``cell_index`` places the non-literal cells into its
    flattened view."""

    rows: Tensor
    cell_pos: Tensor
    cell_index: Tensor
    literals: Tensor
    n_params: int


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
            rows.append((code, n_params, 0, 0))
            n_params += count
            continue
        pos = [7 * r + c for r in range(7) for c in range(7) if not isinstance(meta[r][c], float)]
        rows.append((TAPE_CONST, len(literals), len(positions), len(pos)))
        index.extend(49 * len(literals) + q for q in pos)
        positions.extend(pos)
        literals.append([cell if isinstance(cell, float) else 0.0 for row in meta for cell in row])
    tape = Tape(
        rows=torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).to(device),
        cell_pos=torch.tensor(positions, dtype=torch.int32).to(device),
        cell_index=torch.tensor(index, dtype=torch.int64).to(device),
        literals=torch.tensor(literals, dtype=torch.float64).reshape(-1, 49).to(device),
        n_params=n_params,
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
#: C signature of B3's entry point: is_double, tape, n_entries, params,
#: consts, energy, mu, cov, out_mu, out_cov, batch, rest energy, stream.
_B3_SIGNATURE = {
    "lynx_moment_sweep": (
        ctypes.c_int,
        [ctypes.c_int, _P, ctypes.c_int] + [_P] * 7 + [ctypes.c_longlong, ctypes.c_double, _P],
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
    with torch.cuda.device(device):
        code = library.lynx_moment_sweep(
            int(dtype == torch.float64), tape.rows.data_ptr(), tape.rows.shape[0],
            params.data_ptr(), consts.data_ptr(), energy.data_ptr(), mu.data_ptr(),
            cov.data_ptr(), out_mu.data_ptr(), out_cov.data_ptr(), B, REST_ENERGY_EV,
            torch.cuda.current_stream(device).cuda_stream,
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

#: C signature of B4's entry point: is_double, tape, n_entries, cell_pos,
#: params, consts, energy, mu, cov, dmu, dcov, prefix workspace, d_params,
#: d_consts, d_energy, d_mu, d_cov, batch, rest energy, stream.
_B4_SIGNATURE = {
    "lynx_moment_sweep_bwd": (
        ctypes.c_int,
        [ctypes.c_int, _P, ctypes.c_int] + [_P] * 14 + [ctypes.c_longlong, ctypes.c_double, _P],
    )
}


def moment_sweep_bwd_library() -> ctypes.CDLL:
    """Kernel B4's library, built with nvcc at first use."""
    return load_library("moment_sweep_bwd", _B4_SIGNATURE)


def _moment_sweep_bwd_cuda(entries, flat_values, energy, mu, cov, dmu, dcov):
    """Launch kernel B4 on the current stream (no synchronisation)."""
    _check_sweep_operands("moment_sweep_bwd", energy, mu, cov, dmu, dcov)
    if dmu.shape != mu.shape or dcov.shape != cov.shape:
        raise ValueError("moment_sweep_bwd: cotangents must have the moments' shapes")
    B, dtype, device = mu.shape[0], mu.dtype, mu.device
    tape = _tape(entries, device)
    params, consts = _tape_operands(entries, flat_values, tape, dtype, B)
    # Workspace: each entry's prefix product M_i, laid out (E, 49, B) so that
    # the threads of a warp touch neighbouring addresses.
    prefix = torch.empty((tape.rows.shape[0], 49, B), dtype=dtype, device=device)
    d_params = torch.empty((tape.n_params, B), dtype=dtype, device=device)
    d_consts = torch.empty((tape.cell_pos.shape[0], B), dtype=dtype, device=device)
    d_energy = torch.empty_like(energy)
    d_mu = torch.empty_like(mu)
    d_cov = torch.empty_like(cov)
    library = moment_sweep_bwd_library()
    with torch.cuda.device(device):
        code = library.lynx_moment_sweep_bwd(
            int(dtype == torch.float64), tape.rows.data_ptr(), tape.rows.shape[0],
            tape.cell_pos.data_ptr(),
            params.data_ptr(), consts.data_ptr(), energy.data_ptr(), mu.data_ptr(),
            cov.data_ptr(), dmu.data_ptr(), dcov.data_ptr(), prefix.data_ptr(),
            d_params.data_ptr(), d_consts.data_ptr(), d_energy.data_ptr(), d_mu.data_ptr(),
            d_cov.data_ptr(), B, REST_ENERGY_EV, torch.cuda.current_stream(device).cuda_stream,
        )
    check(library, code, "moment_sweep_bwd")
    moment_sweep_bwd.launches += 1

    # Per-value cotangents: dynamic rows as they are, const cells summed
    # over the batch (the kernel writes them per setting).
    rows = iter(d_params)
    sums = iter(d_consts.sum(dim=1))
    d_flat = tuple(
        next(rows) if kind == "dyn" else next(sums)
        for kind, _, count in entries
        for _ in range(count)
    )
    return d_flat, d_energy, d_mu, d_cov


def moment_sweep_bwd(entries, flat_values, energy, mu, cov, dmu, dcov):
    """Kernel B4: the VJP of :func:`moment_sweep`, returning
    ``(d_flat_values, d_energy, d_mu, d_cov)`` in the moments' dtype:
    ``(B,)`` for dynamic values, batch-summed scalars for const cells.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version, autograd of :func:`_table_reference_sweep`."""
    flat_values = [v.to(mu.dtype) for v in flat_values]
    if mu.device.type == "cpu":
        return _reference_sweep_vjp(entries, flat_values, energy, mu, cov, dmu, dcov)
    return _moment_sweep_bwd_cuda(entries, flat_values, energy, mu, cov, dmu, dcov)


moment_sweep_bwd.launches = 0


class _FusedMomentSweep(torch.autograd.Function):
    """B3 forward, B4 backward.  Gradients flow to every flat plan value
    (const cells reduced to their own shape and dtype), the energy and the
    moments."""

    @staticmethod
    def forward(ctx, entries, energy, mu, cov, *flat_values):
        ctx.entries = entries
        ctx.save_for_backward(energy, mu, cov, *flat_values)
        return moment_sweep(entries, flat_values, energy, mu, cov)

    @staticmethod
    def backward(ctx, dmu, dcov):
        energy, mu, cov, *flat_values = ctx.saved_tensors
        d_flat, d_energy, d_mu, d_cov = moment_sweep_bwd(
            ctx.entries, flat_values, energy, mu, cov, dmu.contiguous(), dcov.contiguous()
        )
        # Const cells come back batch-summed as scalars: give each its value's
        # own shape and dtype.
        d_flat = [d.reshape(v.shape).to(v.dtype) for d, v in zip(d_flat, flat_values)]
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
    with torch.cuda.device(particles.device):
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
    B, N, _ = particles.shape
    dtype, device = particles.dtype, particles.device
    energy = energy.to(dtype)
    total = None
    for build, params in zip(build_fns, element_params):
        T = build([p.to(dtype) for p in params], energy)
        total = T if total is None else tbl.compose(T, total)
    if total is None:
        total = tbl.identity_table()
    layout, _ = _split_table(total)
    matrix = torch.stack(
        [tbl.broadcast_cell(c, (B,), dtype, device) for row in total for c in row], dim=-1
    )
    return _ParticleApply.apply(layout, matrix, particles.contiguous())
