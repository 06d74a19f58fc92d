"""Linear-optics transfer-matrix functions (counterpart of ``lynx_tpu.ops.rmatrix``).

Every lattice element maps the 7-dimensional trace-space state
``(x, x', y, y', s, p, 1)`` linearly: ``state' = R @ state`` with ``R`` a
``(..., 7, 7)`` matrix.  The constant 7th component turns affine kicks
(correctors, misalignments) into pure matmuls.

The functions are branch-free (``torch.where`` over guarded operands), so
they stay autograd-safe: in particular the quadrupole's ``k1 == 0``
degeneracy is avoided by an additive perturbation that keeps d/dk1 flowing.
Each formula follows the JAX package's operation order, so that f64 maps
agree to rounding.  Only the dense ``(..., 7, 7)`` layout is built here: the
JAX package's batch-last and sparse-table layouts are TPU layout devices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from lynx_tpu_torch.constants import REST_ENERGY_EV

Tensor = torch.Tensor


def build_rmatrix(
    entries: Dict[Tuple[int, int], Tensor],
    batch_shape: Tuple[int, ...],
    dtype: torch.dtype,
    device: torch.device,
) -> Tensor:
    """Assemble a batched ``(*batch_shape, 7, 7)`` matrix: identity plus the
    given entries."""
    zero = torch.zeros(batch_shape, dtype=dtype, device=device)
    one = torch.ones(batch_shape, dtype=dtype, device=device)
    rows = []
    for i in range(7):
        row = []
        for j in range(7):
            if (i, j) in entries:
                value = torch.as_tensor(entries[(i, j)], dtype=dtype, device=device)
                row.append(torch.broadcast_to(value, batch_shape))
            else:
                row.append(one if i == j else zero)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def _safe_div(num: Tensor, den: Tensor, fallback=0.0) -> Tensor:
    """num / den, with entries where den == 0 replaced by ``fallback``."""
    den_safe = torch.where(den == 0, 1.0, den)
    return torch.where(den == 0, fallback, num / den_safe)


def sandwich(left: Tensor, mid: Tensor, right: Tensor) -> Tensor:
    """``left @ mid @ right`` for ``(..., 7, 7)`` maps."""
    return torch.matmul(left, torch.matmul(mid, right))


def igamma2_from_energy(energy: Tensor, zero_value: float = 0.0) -> Tensor:
    """1/gamma^2 with gamma = E / (m_e c^2 / e); ``zero_value`` where E == 0."""
    gamma = energy / REST_ENERGY_EV
    gamma_safe = torch.where(gamma == 0, 1.0, gamma)
    return torch.where(gamma == 0, zero_value, 1.0 / gamma_safe**2)


def _cos_sinc(k2: Tensor, length: Tensor) -> Tuple[Tensor, Tensor]:
    """Return (cos(k L), sin(k L)/k) for k = sqrt(k2), valid for k2 of any
    sign: for k2 < 0 this is (cosh(|k| L), sinh(|k| L)/|k|).

    The hyperbolic branch uses the same exp identities and small-argument
    series as the JAX package (its TPU lowering has no cosh/sinh), so both
    packages evaluate one formula."""
    abs_k = torch.sqrt(torch.abs(k2))
    arg = abs_k * length
    focusing = k2 >= 0

    exp_pos = torch.exp(arg)
    exp_neg = torch.exp(-arg)
    small = arg < 0.1
    x2 = arg * arg
    cosh_value = torch.where(
        small,
        1.0 + x2 * (0.5 + x2 * (1.0 / 24.0 + x2 / 720.0)),
        0.5 * (exp_pos + exp_neg),
    )
    sinh_over_k = torch.where(
        small,
        length * (1.0 + x2 * (1.0 / 6.0 + x2 * (1.0 / 120.0 + x2 / 5040.0))),
        _safe_div(0.5 * (exp_pos - exp_neg), abs_k, fallback=length),
    )

    c = torch.where(focusing, torch.cos(arg), cosh_value)
    s_over_k = torch.where(
        focusing,
        _safe_div(torch.sin(arg), abs_k, fallback=length),
        sinh_over_k,
    )
    return c, s_over_k


def rotation_matrix(angle: Tensor) -> Tensor:
    """x-y plane rotation of the transfer map."""
    cs = torch.cos(angle)
    sn = torch.sin(angle)
    return build_rmatrix(
        {
            (0, 0): cs,
            (0, 2): sn,
            (1, 1): cs,
            (1, 3): sn,
            (2, 0): -sn,
            (2, 2): cs,
            (3, 1): -sn,
            (3, 3): cs,
        },
        batch_shape=angle.shape,
        dtype=angle.dtype,
        device=angle.device,
    )


def base_rmatrix(
    length: Tensor,
    k1: Tensor,
    hx: Tensor,
    tilt: Optional[Tensor] = None,
    energy: Optional[Tensor] = None,
) -> Tensor:
    """Universal linear R-matrix for quadrupoles and bends: quad strength
    ``k1``, curvature ``hx``, tilt rotation and the energy-dependent ``r56``
    term (Ocelot's ``uni_matrix``)."""
    dtype, device = length.dtype, length.device

    def cast(value):
        if value is None:
            return torch.zeros_like(length)
        return torch.as_tensor(value, dtype=dtype, device=device)

    k1, hx, tilt, energy = cast(k1), cast(hx), cast(tilt), cast(energy)
    batch_shape = torch.broadcast_shapes(
        length.shape, k1.shape, hx.shape, tilt.shape, energy.shape
    )
    length, k1, hx, tilt, energy = (
        torch.broadcast_to(a, batch_shape) for a in (length, k1, hx, tilt, energy)
    )

    # igamma2 = 1 (not 0) for E == 0 here, as in the reference.
    igamma2 = igamma2_from_energy(energy, zero_value=1.0)
    beta = torch.sqrt(1.0 - igamma2)

    # k1 == 0 is degenerate: perturb it additively to 1e-12 so that d/dk1
    # still flows there (a replacement would zero the gradient).
    k1 = torch.where(k1 == 0, k1 + 1e-12, k1)
    kx2 = k1 + hx**2
    ky2 = -k1

    cx, sx = _cos_sinc(kx2, length)
    cy, sy = _cos_sinc(ky2, length)

    dx = hx / kx2 * (1.0 - cx)
    beta_safe = torch.where(beta == 0, 1.0, beta)
    inv_beta = torch.where(beta == 0, torch.inf, 1.0 / beta_safe)
    r56 = hx**2 * (length - sx) / kx2 * inv_beta**2 - length * inv_beta**2 * igamma2

    entries = {
        (0, 0): cx,
        (0, 1): sx,
        (0, 5): dx * inv_beta,
        (1, 0): -kx2 * sx,
        (1, 1): cx,
        (1, 5): sx * hx * inv_beta,
        (2, 2): cy,
        (2, 3): sy,
        (3, 2): -ky2 * sy,
        (3, 3): cy,
        (4, 0): sx * hx * inv_beta,
        (4, 1): dx * inv_beta,
        (4, 5): r56,
    }
    R = build_rmatrix(entries, batch_shape, dtype, device)
    # Rotate for skew / vertical magnets: R <- rot(-tilt) @ R @ rot(tilt).
    # Applied unconditionally (exact for tilt == 0) to stay branch-free.
    return sandwich(rotation_matrix(-tilt), R, rotation_matrix(tilt))


def misalignment_matrix(misalignment: Tensor) -> Tuple[Tensor, Tensor]:
    """(entry, exit) affine shift matrices for a transversely misaligned
    element."""
    batch_shape = misalignment.shape[:-1]
    dtype, device = misalignment.dtype, misalignment.device
    mx = misalignment[..., 0]
    my = misalignment[..., 1]
    R_entry = build_rmatrix({(0, 6): -mx, (2, 6): -my}, batch_shape, dtype, device)
    R_exit = build_rmatrix({(0, 6): mx, (2, 6): my}, batch_shape, dtype, device)
    return R_entry, R_exit


def drift_rmatrix(length: Tensor, energy: Tensor) -> Tensor:
    """Drift transfer map with r56 = -L / (beta^2 gamma^2)."""
    energy = torch.as_tensor(energy, dtype=length.dtype, device=length.device)
    batch_shape = torch.broadcast_shapes(length.shape, energy.shape)
    length = torch.broadcast_to(length, batch_shape)
    energy = torch.broadcast_to(energy, batch_shape)

    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    beta2 = 1.0 - igamma2
    r56 = -length * _safe_div(igamma2, beta2, fallback=0.0)
    return build_rmatrix(
        {(0, 1): length, (2, 3): length, (4, 5): r56},
        batch_shape,
        length.dtype,
        length.device,
    )
