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

import math
from typing import Dict, Optional, Tuple

import torch

from lynx_tpu_torch.constants import ELECTRON_MASS_EV, REST_ENERGY_EV, SPEED_OF_LIGHT

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
    entries, batch_shape, dtype, tilt = base_rmatrix_entries(length, k1, hx, tilt, energy)
    R = build_rmatrix(entries, batch_shape, dtype, length.device)
    # Rotate for skew / vertical magnets: R <- rot(-tilt) @ R @ rot(tilt).
    # Applied unconditionally (exact for tilt == 0) to stay branch-free.
    return sandwich(rotation_matrix(-tilt), R, rotation_matrix(tilt))


def base_rmatrix_entries(
    length: Tensor,
    k1,
    hx,
    tilt=None,
    energy=None,
):
    """Entry dict of the universal R-matrix, *before* the tilt rotation.

    Returns ``(entries, batch_shape, dtype, tilt)``."""
    length = torch.as_tensor(length)
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
    # (A mask times 1e-12, not torch.where of two Python floats: that would
    # make a float32 tensor and round 1e-12.)
    k1 = k1 + (k1 == 0).to(k1.dtype) * 1e-12
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
    return entries, batch_shape, dtype, tilt


def rotation_entries(angle: Tensor) -> dict:
    """Entry dict of :func:`rotation_matrix`."""
    cs = torch.cos(angle)
    sn = torch.sin(angle)
    return {
        (0, 0): cs,
        (0, 2): sn,
        (1, 1): cs,
        (1, 3): sn,
        (2, 0): -sn,
        (2, 2): cs,
        (3, 1): -sn,
        (3, 3): cs,
    }


def base_rmatrix_table(length, k1, hx, tilt=None, energy=None):
    """Sparse-table form of :func:`base_rmatrix` (see ``ops/table.py``)."""
    from lynx_tpu_torch.ops import table as tbl

    entries, _, _, tilt = base_rmatrix_entries(length, k1, hx, tilt, energy)
    T = tbl.entries_to_table(entries)
    rot_fwd = tbl.entries_to_table(rotation_entries(tilt))
    rot_bwd = tbl.entries_to_table(rotation_entries(-tilt))
    return tbl.compose(rot_bwd, tbl.compose(T, rot_fwd))


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


def drift_rmatrix_entries(length: Tensor, energy) -> dict:
    """Entry dict of the drift map (table form)."""
    energy = torch.as_tensor(energy, dtype=length.dtype, device=length.device)
    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    beta2 = 1.0 - igamma2
    r56 = -length * _safe_div(igamma2, beta2, fallback=0.0)
    return {(0, 1): length, (2, 3): length, (4, 5): r56}


def cavity_rmatrix(length, voltage, phase, frequency, energy) -> Tensor:
    """Linear map of an accelerating RF cavity (see
    :func:`cavity_rmatrix_entries`)."""
    entries, batch_shape, dtype = cavity_rmatrix_entries(length, voltage, phase, frequency, energy)
    return build_rmatrix(entries, batch_shape, dtype, torch.as_tensor(length).device)


def cavity_rmatrix_entries(length, voltage, phase, frequency, energy):
    r"""Entry dict of an accelerating RF cavity's linear map (pi-standing-wave
    model): Rosenzweig-Serafini-style transverse focusing plus the
    longitudinal (r55, r56, r65, r66) block.  Returns ``(entries,
    batch_shape, dtype)``.

    The JAX package's branch-free reparametrisation, equal to the textbook
    form in real arithmetic, so that one expression covers V = 0, the
    zero-crossing phase (cos phi = 0) and mixed on/off batches without NaN:

    * ``alpha = sqrt(eta/8)/cos(phi) * ln(Ef/Ei)`` through ``ln(1+x)/x``
      with ``x = V cos(phi)/E``: no ``1/cos(phi)``;
    * ``r12 = sqrt(8/eta) L (Ei/V) sin(alpha)``: no division by the energy
      gain;
    * the ``(g0-g1)^2`` denominator of ``r55_cor`` cancelled analytically.
    """
    length = torch.as_tensor(length)
    dtype, device = length.dtype, length.device

    def cast(value):
        return torch.as_tensor(value, dtype=dtype, device=device)

    voltage, phase, frequency, energy = cast(voltage), cast(phase), cast(frequency), cast(energy)
    batch_shape = torch.broadcast_shapes(
        length.shape, voltage.shape, phase.shape, frequency.shape, energy.shape
    )
    length, voltage, phase, frequency, energy = (
        torch.broadcast_to(a, batch_shape) for a in (length, voltage, phase, frequency, energy)
    )

    eta = 1.0
    phi = torch.deg2rad(phase)
    cos_phi = torch.cos(phi)
    sin_phi = torch.sin(phi)

    has_beam = energy != 0
    Ei = torch.where(has_beam, energy, 1.0) / ELECTRON_MASS_EV  # gamma_in
    Vm = voltage / ELECTRON_MASS_EV

    x = Vm * cos_phi / Ei  # relative energy gain
    Ef = Ei * (1.0 + x)  # gamma_out
    # Valid: a beam is present and the outgoing energy is physical.
    valid = has_beam & (Ef > 1.0)
    Ef = torch.where(valid, Ef, Ei)
    x = torch.where(valid, x, 0.0)

    # ln(Ef/Ei)/x = ln(1+x)/x, -> 1 as x -> 0.
    x_safe = torch.where(x == 0, 1.0, x)
    lx = torch.where(x == 0, 1.0, torch.log1p(x) / x_safe)
    alpha = math.sqrt(eta / 8.0) * (Vm / Ei) * lx
    sin_alpha = torch.sin(alpha)
    cos_alpha = torch.cos(alpha)

    r11 = cos_alpha - math.sqrt(2.0 / eta) * cos_phi * sin_alpha
    # sin(alpha)/alpha -> 1 covers V -> 0 (r12 -> L, the drift limit).
    Vm_safe = torch.where(Vm == 0, 1.0, Vm)
    r12 = torch.where(Vm == 0, length, math.sqrt(8.0 / eta) * length * (Ei / Vm_safe) * sin_alpha)
    r21 = (
        -(Vm / (length * Ef))
        * sin_alpha
        * (cos_phi**2 / math.sqrt(2.0 * eta) + math.sqrt(eta / 8.0))
    )
    r22 = Ei / Ef * (cos_alpha + math.sqrt(2.0 / eta) * cos_phi * sin_alpha)

    beta0 = torch.sqrt(1.0 - 1.0 / Ei**2)
    beta1 = torch.sqrt(1.0 - 1.0 / Ef**2)

    k = 2.0 * math.pi * frequency / SPEED_OF_LIGHT
    # Equal to the drift's r56 when V == 0.
    r56 = -length / (Ef**2 * Ei * beta1) * (Ef + Ei) / (beta1 + beta0)
    # The r55 correction without cancellation (see the docstring).
    g0, g1 = Ei, Ef
    gb_sum = g0 * beta0 + g1 * beta1
    ratio = (g0 + g1) / torch.where(gb_sum == 0, 1.0, gb_sum)
    r55_cor = (
        -k * length * beta0 * Vm * sin_phi * (1.0 + ratio**2)
        / (2.0 * g0 * g1 * (1.0 + beta0 * beta1) * beta1 * g1)
    )

    r66 = Ei / Ef * beta0 / beta1
    r65 = k * sin_phi * Vm / (Ef * beta1)

    # Invalid entries (no beam, or fully decelerated): the drift's map.
    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    beta2 = 1.0 - igamma2
    drift_r56 = -length * _safe_div(igamma2, beta2, fallback=0.0)

    r11 = torch.where(valid, r11, 1.0)
    r12 = torch.where(valid, r12, length)
    r21 = torch.where(valid, r21, 0.0)
    r22 = torch.where(valid, r22, 1.0)
    r55 = torch.where(valid, 1.0 + r55_cor, 1.0)
    r56 = torch.where(valid, r56, drift_r56)
    r65 = torch.where(valid, r65, 0.0)
    r66 = torch.where(valid, r66, 1.0)

    entries = {
        (0, 0): r11,
        (0, 1): r12,
        (1, 0): r21,
        (1, 1): r22,
        (2, 2): r11,
        (2, 3): r12,
        (3, 2): r21,
        (3, 3): r22,
        (4, 4): r55,
        (4, 5): r56,
        (5, 4): r65,
        (5, 5): r66,
    }
    return entries, batch_shape, dtype


#: Terms of the series in :func:`tds_rmatrix_entries`: the first term left
#: out is below float64's rounding while ``u = kappa^2 eta L^2`` stays
#: under 1 (a PolariX streak at ARES's energy: u ~ 1e-3).
_TDS_SERIES_TERMS = 5


def tds_rmatrix(length, voltage, phase, frequency, tilt, energy) -> Tensor:
    """Linear map of a transverse deflecting cavity (see
    :func:`tds_rmatrix_entries`), rotated by ``tilt``."""
    entries, batch_shape, dtype, tilt = tds_rmatrix_entries(
        length, voltage, phase, frequency, tilt, energy)
    R = build_rmatrix(entries, batch_shape, dtype, torch.as_tensor(length).device)
    return sandwich(rotation_matrix(-tilt), R, rotation_matrix(tilt))


def tds_rmatrix_entries(length, voltage, phase, frequency, tilt, energy):
    r"""Entry dict of a vertically streaking transverse deflecting cavity
    before its tilt: ``(entries, batch_shape, dtype, tilt)``.

    A particle at ``s`` sees the phase ``phi - k s`` (the accelerating
    cavity's convention), ``k = 2 pi f / c``, so the kick law per unit
    length is ``y' += (V / (p0 c)) sin(phi - k s) / L`` and, by
    Panofsky-Wenzel, ``p += kappa y / L`` with
    ``kappa = k V cos(phi) / (p0 c)``.  With the drift's ``r56 = -eta L``
    the generator ``G`` of ``(y, y', s, p)`` closes a cycle, ``G^4 =
    (kappa / L)^2 eta``, so the thick map ``exp(G L)`` is the series
    ``g_j(u) = sum_m u^m / (4m + j)!`` in ``u = kappa^2 eta L^2``:

    * ``y  += L g1 y' - kappa L g2 s + kappa eta L^2 g3 p``
    * ``y' += kappa^2 eta L g3 y - kappa g1 s + kappa eta L g2 p``
    * ``s  += -eta kappa L g2 y - eta kappa L^2 g3 y' - eta L g1 p``
    * ``p  += kappa g1 y + kappa L g2 y' - kappa^2 L g3 s``

    and ``g0`` on the diagonal.  At ``eta = 0`` it is Emma, Frisch and
    Krejcik's thick deflector (LCLS-TN-00-12), ``y += L y' - (kappa L / 2)
    s``, ``y' -= kappa s``, ``p += kappa y + (kappa L / 2) y' - (kappa^2 L
    / 6) s`` (``s`` counted as this package counts it: the accelerating
    cavity's sign); the ``eta`` terms keep the map exactly symplectic.  The
    constant kick ``A = V sin(phi) / (p0 c)`` fills the affine column
    (``y' += A g1``, ``y += A L g2``, ``p += kappa A L g3``, ``s -= eta kappa
    A L^2 g4``).  Phase in degrees, voltage in volts, ``p0 c`` from
    ``energy`` (eV); no beam (``energy == 0``) gives the drift."""
    length = torch.as_tensor(length)
    dtype, device = length.dtype, length.device

    def cast(value):
        return torch.as_tensor(value, dtype=dtype, device=device)

    voltage, phase, frequency, tilt, energy = (
        cast(v) for v in (voltage, phase, frequency, tilt, energy))
    batch_shape = torch.broadcast_shapes(length.shape, voltage.shape, phase.shape,
                                         frequency.shape, tilt.shape, energy.shape)
    length, voltage, phase, frequency, tilt, energy = (
        torch.broadcast_to(a, batch_shape)
        for a in (length, voltage, phase, frequency, tilt, energy))

    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    beta2 = 1.0 - igamma2
    eta = _safe_div(igamma2, beta2, fallback=0.0)
    p0c = energy * torch.sqrt(beta2)
    phi = torch.deg2rad(phase)
    kick = _safe_div(voltage, p0c, fallback=0.0)
    kappa = 2.0 * math.pi * frequency / SPEED_OF_LIGHT * kick * torch.cos(phi)
    A = kick * torch.sin(phi)

    u = kappa**2 * eta * length**2
    g = []
    for j in range(5):
        total = 0.0
        for m in reversed(range(_TDS_SERIES_TERMS)):
            total = total * u + 1.0 / math.factorial(4 * m + j)
        g.append(total)
    g0, g1, g2, g3, g4 = g
    L = length
    Y, YP, S, P = 2, 3, 4, 5
    entries = {
        (0, 1): L,
        (Y, Y): g0, (Y, YP): L * g1, (Y, S): -kappa * L * g2, (Y, P): kappa * eta * L**2 * g3,
        (YP, Y): kappa**2 * eta * L * g3, (YP, YP): g0, (YP, S): -kappa * g1,
        (YP, P): kappa * eta * L * g2,
        (S, Y): -eta * kappa * L * g2, (S, YP): -eta * kappa * L**2 * g3, (S, S): g0,
        (S, P): -eta * L * g1,
        (P, Y): kappa * g1, (P, YP): kappa * L * g2, (P, S): -kappa**2 * L * g3, (P, P): g0,
        (YP, 6): A * g1, (Y, 6): A * L * g2, (P, 6): kappa * A * L * g3,
        (S, 6): -eta * kappa * A * L**2 * g4,
    }
    return entries, batch_shape, dtype, tilt
