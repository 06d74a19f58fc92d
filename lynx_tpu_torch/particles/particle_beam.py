"""Macro-particle beam (counterpart of ``lynx_tpu.particles.particle_beam``).

``ParticleBeam`` carries ``(..., N, 7)`` particle vectors; a linear map R
propagates them as ``P' = P @ R^T``.  As in the JAX package, lost particles
are masked rather than culled: a beam may carry ``survival (..., N)``
weights, dead particles keep flowing with weight 0, and every statistic and
histogram is weighted, so shapes never change.
"""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.particles.beam import Beam, _common_shape, _resolve
from lynx_tpu_torch.particles.parameter_beam import _block_covariance


def _weighted_mean(values: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return values.mean(dim=-1)
    total = weights.sum(dim=-1)
    total = torch.where(total == 0, 1.0, total)
    return (values * weights).sum(dim=-1) / total


def _weighted_std(values: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Std with Bessel correction (ddof=1) for uniform weights."""
    if weights is None:
        return values.std(dim=-1, correction=1)
    mean = _weighted_mean(values, weights)[..., None]
    total = weights.sum(dim=-1)
    denom = torch.clamp(total - 1.0, min=1.0)
    var = (weights * (values - mean) ** 2).sum(dim=-1) / denom
    return torch.sqrt(var)


def _weighted_cov(a: torch.Tensor, b: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Cross-covariance with ddof=0."""
    mu_a = _weighted_mean(a, weights)[..., None]
    mu_b = _weighted_mean(b, weights)[..., None]
    if weights is None:
        return ((a - mu_a) * (b - mu_b)).mean(dim=-1)
    total = weights.sum(dim=-1)
    total = torch.where(total == 0, 1.0, total)
    return (weights * (a - mu_a) * (b - mu_b)).sum(dim=-1) / total


class ParticleBeam(Beam):
    """Beam of macro-particles.

    :param particles: ``(..., N, 7)`` particle vectors (7th component == 1).
    :param energy: ``(...)`` reference energy in eV.
    :param particle_charges: ``(..., N)`` per-particle charge in C.
    :param survival: optional ``(..., N)`` survival weights in [0, 1];
        ``None`` means all particles are alive.
    """

    def __init__(
        self,
        particles,
        energy,
        particle_charges=None,
        survival=None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> None:
        particles = torch.as_tensor(particles, dtype=dtype, device=device)
        if particles.ndim < 2 or particles.shape[-2] == 0 or particles.shape[-1] != 7:
            raise ValueError(
                f"Particles must be (..., N > 0, 7), got {tuple(particles.shape)}"
            )
        dtype, device = particles.dtype, particles.device
        self.particles = particles
        self.energy = torch.as_tensor(energy, dtype=dtype, device=device)
        self.particle_charges = (
            torch.as_tensor(particle_charges, dtype=dtype, device=device)
            if particle_charges is not None
            else torch.zeros(particles.shape[:-1], dtype=dtype, device=device)
        )
        self.survival = (
            torch.as_tensor(survival, dtype=dtype, device=device)
            if survival is not None
            else None
        )

    @classmethod
    def from_parameters(
        cls,
        num_particles: Optional[int] = None,
        mu_x=None,
        mu_y=None,
        mu_xp=None,
        mu_yp=None,
        sigma_x=None,
        sigma_y=None,
        sigma_xp=None,
        sigma_yp=None,
        sigma_s=None,
        sigma_p=None,
        cor_x=None,
        cor_y=None,
        cor_s=None,
        energy=None,
        total_charge=None,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "ParticleBeam":
        """Sample a Gaussian beam from the 15 scalar parameters (the JAX
        package's defaults, N = 100,000).

        ``generator`` takes the place of JAX's ``key``; it must live on
        ``device``.  The two frameworks draw different numbers from the same
        seed, so only the sample statistics agree between them.
        """
        shape = _common_shape(
            [mu_x, mu_xp, mu_y, mu_yp, sigma_x, sigma_xp, sigma_y, sigma_yp,
             sigma_s, sigma_p, cor_x, cor_y, cor_s, energy, total_charge]
        )
        num_particles = num_particles if num_particles is not None else 100_000

        def resolve(value, default):
            return _resolve(value, default, shape, dtype, device)

        mu_x, mu_xp = resolve(mu_x, 0.0), resolve(mu_xp, 0.0)
        mu_y, mu_yp = resolve(mu_y, 0.0), resolve(mu_yp, 0.0)
        sigma_x, sigma_xp = resolve(sigma_x, 175e-9), resolve(sigma_xp, 2e-7)
        sigma_y, sigma_yp = resolve(sigma_y, 175e-9), resolve(sigma_yp, 2e-7)
        sigma_s, sigma_p = resolve(sigma_s, 1e-6), resolve(sigma_p, 1e-6)
        cor_x, cor_y, cor_s = resolve(cor_x, 0.0), resolve(cor_y, 0.0), resolve(cor_s, 0.0)
        energy = resolve(energy, 1e8)
        total_charge = resolve(total_charge, 0.0)

        particle_charges = (
            torch.ones((*shape, num_particles), dtype=dtype, device=device)
            * total_charge[..., None]
            / num_particles
        )
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        mean = torch.stack([mu_x, mu_xp, mu_y, mu_yp, zeros, zeros], dim=-1)
        cov = _block_covariance(
            6, sigma_x, sigma_xp, sigma_y, sigma_yp, sigma_s, sigma_p, cor_x, cor_y, cor_s
        )

        z = torch.randn(
            (*shape, num_particles, 6), generator=generator, dtype=dtype, device=device
        )
        # x = mean + L z with L the (regularized) Cholesky factor; a
        # degenerate plane (zero variance) comes out as zeros, not NaN.
        eps = torch.finfo(dtype).tiny
        chol, _ = torch.linalg.cholesky_ex(
            cov + eps * torch.eye(6, dtype=dtype, device=device)
        )
        chol = torch.nan_to_num(chol, nan=0.0)
        phase_space = mean[..., None, :] + torch.einsum("...ij,...nj->...ni", chol, z)
        particles = torch.cat(
            [phase_space, torch.ones((*shape, num_particles, 1), dtype=dtype, device=device)],
            dim=-1,
        )
        return cls(particles, energy, particle_charges=particle_charges)

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "ParticleBeam":
        """The same beam with every tensor moved to ``device``/``dtype``."""

        def move(t):
            return None if t is None else t.to(device=device, dtype=dtype)

        return self.__class__(
            move(self.particles),
            move(self.energy),
            particle_charges=move(self.particle_charges),
            survival=move(self.survival),
        )

    def broadcast(self, shape: tuple) -> "ParticleBeam":
        """Tile the beam to a larger batch shape."""
        n = self.num_particles
        return self.__class__(
            particles=torch.broadcast_to(self.particles, (*shape, n, 7)),
            energy=torch.broadcast_to(self.energy, shape),
            particle_charges=torch.broadcast_to(self.particle_charges, (*shape, n)),
            survival=(
                torch.broadcast_to(self.survival, (*shape, n))
                if self.survival is not None
                else None
            ),
        )

    # -- charge / counts ---------------------------------------------------
    @property
    def total_charge(self) -> torch.Tensor:
        return self.particle_charges.sum(dim=-1)

    @property
    def num_particles(self) -> int:
        return self.particles.shape[-2]

    @property
    def num_particles_survived(self) -> torch.Tensor:
        """Number of alive particles (sum of survival weights)."""
        if self.survival is None:
            return torch.full(
                self.particles.shape[:-2],
                self.num_particles,
                dtype=self.particles.dtype,
                device=self.particles.device,
            )
        return self.survival.sum(dim=-1)

    # -- coordinates -------------------------------------------------------
    @property
    def xs(self) -> torch.Tensor:
        return self.particles[..., 0]

    @property
    def xps(self) -> torch.Tensor:
        return self.particles[..., 1]

    @property
    def ys(self) -> torch.Tensor:
        return self.particles[..., 2]

    @property
    def yps(self) -> torch.Tensor:
        return self.particles[..., 3]

    @property
    def ss(self) -> torch.Tensor:
        return self.particles[..., 4]

    @property
    def ps(self) -> torch.Tensor:
        return self.particles[..., 5]

    # -- statistics (survival-weighted) ------------------------------------
    @property
    def mu_x(self) -> torch.Tensor:
        return _weighted_mean(self.xs, self.survival)

    @property
    def mu_xp(self) -> torch.Tensor:
        return _weighted_mean(self.xps, self.survival)

    @property
    def mu_y(self) -> torch.Tensor:
        return _weighted_mean(self.ys, self.survival)

    @property
    def mu_yp(self) -> torch.Tensor:
        return _weighted_mean(self.yps, self.survival)

    @property
    def mu_s(self) -> torch.Tensor:
        return _weighted_mean(self.ss, self.survival)

    @property
    def mu_p(self) -> torch.Tensor:
        return _weighted_mean(self.ps, self.survival)

    @property
    def sigma_x(self) -> torch.Tensor:
        return _weighted_std(self.xs, self.survival)

    @property
    def sigma_xp(self) -> torch.Tensor:
        return _weighted_std(self.xps, self.survival)

    @property
    def sigma_y(self) -> torch.Tensor:
        return _weighted_std(self.ys, self.survival)

    @property
    def sigma_yp(self) -> torch.Tensor:
        return _weighted_std(self.yps, self.survival)

    @property
    def sigma_s(self) -> torch.Tensor:
        return _weighted_std(self.ss, self.survival)

    @property
    def sigma_p(self) -> torch.Tensor:
        return _weighted_std(self.ps, self.survival)

    @property
    def sigma_xxp(self) -> torch.Tensor:
        return _weighted_cov(self.xs, self.xps, self.survival)

    @property
    def sigma_yyp(self) -> torch.Tensor:
        return _weighted_cov(self.ys, self.yps, self.survival)
