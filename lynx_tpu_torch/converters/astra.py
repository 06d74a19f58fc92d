"""ASTRA particle-distribution reader (counterpart of
``lynx_tpu.converters.astra``).

Parses an ASTRA text distribution, drops lost particles and converts to the
trace-space coordinates ``(x, x', y, y', c*dt, (gamma/gamma_ref - 1)/beta_ref)``.
Pure numpy in float64 on the host; the arrays reach torch in the beam
constructors (``ParticleBeam.from_astra``, ``ParameterBeam.from_astra``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lynx_tpu_torch.constants import ELECTRON_MASS_EV


def from_astrabeam(path: str) -> Tuple[np.ndarray, float, np.ndarray]:
    """Read an ASTRA beam distribution file.

    :param path: Path to the ASTRA beam distribution file.
    :return: ``(particles (N, 6), energy_eV, charges (N,))``.
    """
    raw = np.loadtxt(path)

    # Column 9 is the particle status flag; > 0 means alive.
    raw = raw[raw[:, 9] > 0, :]
    n_particles = raw.shape[0]

    # ASTRA stores the reference particle first; its z and pz are absolute,
    # all other particles are relative to it.
    p_ref = raw[0, 5]
    xp = raw[:, :6].copy()
    xp[0, 2] = 0.0
    xp[0, 5] = 0.0

    gamma_ref = np.sqrt((p_ref / ELECTRON_MASS_EV) ** 2 + 1)
    energy = gamma_ref * ELECTRON_MASS_EV

    # Momentum vector of every particle in eV/c.
    u = np.c_[xp[:, 3], xp[:, 4], xp[:, 5] + p_ref]
    gamma = np.sqrt(1 + np.sum(u * u, axis=1) / ELECTRON_MASS_EV**2)
    beta = np.sqrt(1 - gamma**-2)
    beta_ref = np.sqrt(1 - gamma_ref**-2)

    norm = np.linalg.norm(u, 2, axis=1).reshape((n_particles, 1))
    u = u / norm
    cdt = -xp[:, 2] / (beta * u[:, 2])

    particles = np.zeros((n_particles, 6))
    particles[:, 0] = xp[:, 0] + beta * u[:, 0] * cdt
    particles[:, 2] = xp[:, 1] + beta * u[:, 1] * cdt
    particles[:, 4] = cdt
    particles[:, 1] = xp[:, 3] / p_ref
    particles[:, 3] = xp[:, 4] / p_ref
    particles[:, 5] = (gamma / gamma_ref - 1) / beta_ref

    charges = np.abs(raw[:, 7]) * 1e-9  # nC -> C
    return particles, energy, charges
