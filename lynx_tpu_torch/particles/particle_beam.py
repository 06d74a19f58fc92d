"""Macro-particle beam (counterpart of ``lynx_tpu.particles.particle_beam``).

``ParticleBeam`` carries ``(..., N, 7)`` particle vectors; a linear map R
propagates them as ``P' = P @ R^T``.  As in the JAX package, lost particles
are masked rather than culled: a beam may carry ``survival (..., N)``
weights, dead particles keep flowing with weight 0, and every statistic and
histogram is weighted, so shapes never change.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lynx_tpu_torch._collectives import (
    particle_all_reduce,
    particle_count,
    particle_sum,
)
from lynx_tpu_torch.particles.beam import (
    Beam,
    _common_shape,
    _host_arrays_to_device,
    _resolve,
)
from lynx_tpu_torch.particles.parameter_beam import ParameterBeam, _block_covariance
from lynx_tpu_torch.utils import resolve_device


# Every sum over the particle axis goes through ``particle_sum`` (or
# ``particle_all_reduce``): the local sum, all-reduced over the active
# particle group where ``parallel.shard_beam`` split the axis (``with
# mesh:``), as XLA partitions these formulas.  Without a group it is the
# plain local sum.


def _weight_total(values: torch.Tensor, weights: Optional[torch.Tensor]):
    """The weight sum over the whole particle axis; without weights, the
    particle count (an int)."""
    if weights is None:
        return particle_count(values.shape[-1])
    return particle_sum(weights)


def _nonzero(total):
    """``total`` with a zero weight sum read as one."""
    return total if isinstance(total, int) else torch.where(total == 0, 1.0, total)


def _weighted_mean(values: torch.Tensor, weights: Optional[torch.Tensor], total=None) -> torch.Tensor:
    if total is None:
        total = _weight_total(values, weights)
    weighted = values if weights is None else values * weights
    return particle_sum(weighted) / _nonzero(total)


def _weighted_std(values: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Std with Bessel correction (ddof=1) for uniform weights, in two
    passes."""
    total = _weight_total(values, weights)
    squares = (values - _weighted_mean(values, weights, total)[..., None]) ** 2
    if weights is None:
        return torch.sqrt(particle_sum(squares) / (total - 1))
    denom = torch.clamp(total - 1.0, min=1.0)
    return torch.sqrt(particle_sum(weights * squares) / denom)


def _weighted_cov(a: torch.Tensor, b: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Cross-covariance with ddof=0."""
    total = _weight_total(a, weights)
    products = (a - _weighted_mean(a, weights, total)[..., None]) * (
        b - _weighted_mean(b, weights, total)[..., None]
    )
    if weights is not None:
        products = weights * products
    return particle_sum(products) / _nonzero(total)


class ParticleBeam(Beam):
    """Beam of macro-particles.

    :param particles: ``(..., N, 7)`` particle vectors (7th component == 1).
    :param energy: ``(...)`` reference energy in eV.
    :param particle_charges: ``(..., N)`` per-particle charge in C.
    :param survival: optional ``(..., N)`` survival weights in [0, 1];
        ``None`` means all particles are alive.
    :param device: ``device`` if given, else that of a tensor argument,
        else the card (``cuda``).
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
        device = resolve_device(device, particles, energy, particle_charges, survival)
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
        seed, so only the sample statistics agree between them.  Without
        ``device`` the beam lives on the generator's device if one is given,
        else on the card.
        """
        if device is None and generator is not None:
            device = generator.device
        device = resolve_device(device)
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

    @classmethod
    def from_twiss(
        cls,
        num_particles: Optional[int] = None,
        beta_x=None,
        alpha_x=None,
        emittance_x=None,
        beta_y=None,
        alpha_y=None,
        emittance_y=None,
        energy=None,
        sigma_s=None,
        sigma_p=None,
        cor_s=None,
        total_charge=None,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "ParticleBeam":
        """Sample a centred Gaussian beam from Twiss parameters (the JAX
        package's defaults, N = 1,000,000): the sigmas and correlations of
        :meth:`ParameterBeam.from_twiss`, then :meth:`from_parameters` with
        ``generator``."""
        if device is None and generator is not None:
            device = generator.device
        device = resolve_device(device)
        shape = _common_shape(
            [beta_x, alpha_x, emittance_x, beta_y, alpha_y, emittance_y,
             energy, sigma_s, sigma_p, cor_s, total_charge]
        )

        def resolve(value, default):
            return _resolve(value, default, shape, dtype, device)

        beta_x, alpha_x = resolve(beta_x, 0.0), resolve(alpha_x, 0.0)
        beta_y, alpha_y = resolve(beta_y, 0.0), resolve(alpha_y, 0.0)
        emittance_x, emittance_y = resolve(emittance_x, 0.0), resolve(emittance_y, 0.0)
        beta_x_safe = torch.where(beta_x == 0, 1.0, beta_x)
        beta_y_safe = torch.where(beta_y == 0, 1.0, beta_y)
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        return cls.from_parameters(
            num_particles=1_000_000 if num_particles is None else num_particles,
            mu_x=zeros,
            mu_xp=zeros,
            mu_y=zeros,
            mu_yp=zeros,
            sigma_x=torch.sqrt(beta_x * emittance_x),
            sigma_xp=torch.sqrt(emittance_x * (1 + alpha_x**2) / beta_x_safe),
            sigma_y=torch.sqrt(beta_y * emittance_y),
            sigma_yp=torch.sqrt(emittance_y * (1 + alpha_y**2) / beta_y_safe),
            sigma_s=resolve(sigma_s, 1e-6),
            sigma_p=resolve(sigma_p, 1e-6),
            energy=resolve(energy, 1e8),
            cor_s=resolve(cor_s, 0.0),
            cor_x=-emittance_x * alpha_x,
            cor_y=-emittance_y * alpha_y,
            total_charge=resolve(total_charge, 0.0),
            generator=generator,
            dtype=dtype,
            device=device,
        )

    @classmethod
    def uniform_3d_ellipsoid(
        cls,
        num_particles: Optional[int] = None,
        radius_x=None,
        radius_y=None,
        radius_s=None,
        sigma_xp=None,
        sigma_yp=None,
        sigma_p=None,
        energy=None,
        total_charge=None,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "ParticleBeam":
        """Waterbag beam: x, y and s uniform inside an ellipsoid of the given
        radii, the momenta an uncorrelated Gaussian (default N = 1,000,000).

        Sampled without rejection, as in the JAX package: a Gaussian
        direction times a cube-root radius is uniform in the unit ball.  The
        momenta, the directions and the radii come from ``generator`` in
        that order."""
        if device is None and generator is not None:
            device = generator.device
        device = resolve_device(device)
        shape = _common_shape(
            [radius_x, radius_y, radius_s, sigma_xp, sigma_yp, sigma_p, energy, total_charge]
        )
        num_particles = 1_000_000 if num_particles is None else num_particles
        radii = [
            _resolve(radius, 1e-3, shape, dtype, device)
            for radius in (radius_x, radius_y, radius_s)
        ]
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        beam = cls.from_parameters(
            num_particles=num_particles,
            mu_xp=zeros,
            mu_yp=zeros,
            sigma_xp=sigma_xp,
            sigma_yp=sigma_yp,
            sigma_p=sigma_p,
            energy=energy,
            total_charge=total_charge,
            generator=generator,
            dtype=dtype,
            device=device,
        )
        direction = torch.randn(
            (*shape, num_particles, 3), generator=generator, dtype=dtype, device=device
        )
        norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
        norm = torch.where(norm == 0, 1.0, norm)
        u = torch.rand((*shape, num_particles, 1), generator=generator, dtype=dtype, device=device)
        ball = direction / norm * u ** (1.0 / 3.0)
        columns = list(beam.particles.unbind(-1))
        for axis, column in enumerate((0, 2, 4)):
            columns[column] = ball[..., axis] * radii[axis][..., None]
        beam.particles = torch.stack(columns, dim=-1)
        return beam

    @classmethod
    def make_linspaced(
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
        energy=None,
        total_charge=None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "ParticleBeam":
        """Deterministic beam of N particles (default 10), each coordinate
        linspaced from mu - sigma to mu + sigma."""
        device = resolve_device(device)
        shape = _common_shape(
            [mu_x, mu_xp, mu_y, mu_yp, sigma_x, sigma_xp, sigma_y, sigma_yp,
             sigma_s, sigma_p, energy, total_charge]
        )
        num_particles = 10 if num_particles is None else num_particles

        def resolve(value, default):
            return _resolve(value, default, shape, dtype, device)

        # numpy's (and JAX's) linspace: i * (1 / (n - 1)), the last point 1.
        # torch.linspace steps back from the end over its second half, which
        # moves some points by an ulp.
        t = torch.arange(num_particles, dtype=dtype, device=device)
        if num_particles > 1:
            t = t * (torch.tensor(1.0, dtype=dtype, device=device) / (num_particles - 1))
            t[-1] = 1.0

        def linspaced(mu, sigma):
            lo = (mu - sigma)[..., None]
            hi = (mu + sigma)[..., None]
            return lo + (hi - lo) * t

        zeros = torch.zeros(shape, dtype=dtype, device=device)
        particles = torch.stack(
            [
                linspaced(resolve(mu_x, 0.0), resolve(sigma_x, 175e-9)),
                linspaced(resolve(mu_xp, 0.0), resolve(sigma_xp, 2e-7)),
                linspaced(resolve(mu_y, 0.0), resolve(sigma_y, 175e-9)),
                linspaced(resolve(mu_yp, 0.0), resolve(sigma_yp, 2e-7)),
                linspaced(zeros, resolve(sigma_s, 0.0)),
                linspaced(zeros, resolve(sigma_p, 0.0)),
                torch.ones((*shape, num_particles), dtype=dtype, device=device),
            ],
            dim=-1,
        )
        total_charge = resolve(total_charge, 0.0)
        particle_charges = (
            torch.ones((*shape, num_particles), dtype=dtype, device=device)
            * total_charge[..., None]
            / num_particles
        )
        return cls(particles, resolve(energy, 1e8), particle_charges=particle_charges)

    @classmethod
    def _from_host_particles(cls, phase_space, energy, charges, dtype, device):
        """A beam of ``(N, 6)`` float64 host particles, cast on the host and
        copied to the device once."""
        particles = np.ones((phase_space.shape[0], 7))
        particles[:, :6] = phase_space
        particles, energy, charges = _host_arrays_to_device(
            [particles[None], np.array([energy]), np.asarray(charges)[None]],
            dtype, resolve_device(device),
        )
        return cls(particles, energy, particle_charges=charges)

    @classmethod
    def from_ocelot(cls, parray, dtype: torch.dtype = torch.float32, device=None) -> "ParticleBeam":
        """The particles of an Ocelot ``ParticleArray`` (duck-typed: it needs
        ``rparticles`` (6, N), ``E`` in GeV and ``q_array``)."""
        return cls._from_host_particles(
            np.asarray(parray.rparticles).transpose(), 1e9 * parray.E, parray.q_array,
            dtype, device,
        )

    @classmethod
    def from_astra(
        cls, path: str, dtype: torch.dtype = torch.float32, device=None
    ) -> "ParticleBeam":
        """The particles of an ASTRA particle distribution file, read and
        converted in float64 on the host."""
        from lynx_tpu_torch.converters.astra import from_astrabeam

        particles, energy, particle_charges = from_astrabeam(path)
        return cls._from_host_particles(particles, energy, particle_charges, dtype, device)

    def transformed_to(
        self,
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
        energy=None,
        total_charge=None,
    ) -> "ParticleBeam":
        """The cloud renormalised, coordinate by coordinate, to new means
        and sigmas: (p - old mu) / old sigma * new sigma + new mu, with s and
        p centred on 0.  ``survival`` carries over; a new ``total_charge``
        is spread evenly over the particles."""
        shape = self.mu_x.shape
        dtype = self.particles.dtype
        device = self.particles.device

        def given(value, own):
            return own if value is None else torch.as_tensor(value, dtype=dtype, device=device)

        if total_charge is None:
            particle_charges = self.particle_charges
        else:
            total_charge = torch.broadcast_to(
                torch.as_tensor(total_charge, dtype=dtype, device=device), shape
            )
            particle_charges = (
                torch.ones_like(self.particle_charges)
                * total_charge[..., None]
                / self.particle_charges.shape[-1]
            )
        zeros = torch.zeros(shape, dtype=dtype, device=device)

        def stacked(*columns):
            return torch.stack(torch.broadcast_tensors(*columns), dim=-1)

        new_mu = stacked(given(mu_x, self.mu_x), given(mu_xp, self.mu_xp), given(mu_y, self.mu_y),
                         given(mu_yp, self.mu_yp), zeros, zeros)
        new_sigma = stacked(
            given(sigma_x, self.sigma_x), given(sigma_xp, self.sigma_xp),
            given(sigma_y, self.sigma_y), given(sigma_yp, self.sigma_yp),
            given(sigma_s, self.sigma_s), given(sigma_p, self.sigma_p),
        )
        old_mu = stacked(self.mu_x, self.mu_xp, self.mu_y, self.mu_yp, zeros, zeros)
        old_sigma = stacked(self.sigma_x, self.sigma_xp, self.sigma_y, self.sigma_yp,
                            self.sigma_s, self.sigma_p)
        old_sigma = torch.where(old_sigma == 0, 1.0, old_sigma)
        phase_space = (
            (self.particles[..., :6] - old_mu[..., None, :])
            / old_sigma[..., None, :]
            * new_sigma[..., None, :]
            + new_mu[..., None, :]
        )
        particles = torch.cat(
            [phase_space, torch.ones((*phase_space.shape[:-1], 1), dtype=dtype, device=device)],
            dim=-1,
        )
        return self.__class__(
            particles,
            given(energy, self.energy),
            particle_charges=particle_charges,
            survival=self.survival,
        )

    def __len__(self) -> int:
        return int(self.num_particles)

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
        return particle_sum(self.particle_charges)

    @property
    def num_particles(self) -> int:
        return self.particles.shape[-2]

    @property
    def num_particles_survived(self) -> torch.Tensor:
        """Number of alive particles (sum of survival weights), over the
        whole particle axis where it is sharded."""
        if self.survival is None:
            return torch.full(
                self.particles.shape[:-2],
                particle_count(self.num_particles),
                dtype=self.particles.dtype,
                device=self.particles.device,
            )
        return particle_sum(self.survival)

    # -- coordinates -------------------------------------------------------
    def _set_coordinate(self, index: int, value) -> None:
        """Replace column ``index`` of the particles (a new tensor, so that
        autograd sees the assignment)."""
        particles = self.particles.clone()
        particles[..., index] = torch.as_tensor(
            value, dtype=particles.dtype, device=particles.device
        )
        self.particles = particles

    @property
    def xs(self) -> torch.Tensor:
        return self.particles[..., 0]

    @xs.setter
    def xs(self, value) -> None:
        self._set_coordinate(0, value)

    @property
    def xps(self) -> torch.Tensor:
        return self.particles[..., 1]

    @xps.setter
    def xps(self, value) -> None:
        self._set_coordinate(1, value)

    @property
    def ys(self) -> torch.Tensor:
        return self.particles[..., 2]

    @ys.setter
    def ys(self, value) -> None:
        self._set_coordinate(2, value)

    @property
    def yps(self) -> torch.Tensor:
        return self.particles[..., 3]

    @yps.setter
    def yps(self, value) -> None:
        self._set_coordinate(3, value)

    @property
    def ss(self) -> torch.Tensor:
        return self.particles[..., 4]

    @ss.setter
    def ss(self, value) -> None:
        self._set_coordinate(4, value)

    @property
    def ps(self) -> torch.Tensor:
        return self.particles[..., 5]

    @ps.setter
    def ps(self, value) -> None:
        self._set_coordinate(5, value)

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

    def as_parameter_beam(self) -> ParameterBeam:
        """The beam's survival-weighted *sample* moments as a
        :class:`ParameterBeam`.

        For a purely linear section, tracked sample moments obey the same
        algebra as Gaussian moments (``mu' = R mu``, ``Sigma' = R Sigma
        R^T``), so tracking the result gives the particle path's downstream
        ``mu_*``/``sigma_*`` at moment cost (see
        ``functional.moment_sufficient``).  The covariance carries the same
        Bessel (ddof=1) scaling as :attr:`sigma_x` and the others, so the
        ``sigma_*`` agree exactly; ``sigma_xxp``/``sigma_yyp`` use ddof=0
        and differ by ``(sum w - 1) / sum w``."""
        particles, weights = self.particles, self.survival
        total = _weight_total(particles[..., 0], weights)
        if weights is None:
            mu = particle_sum(particles, dim=-2) / total
            denom = max(total - 1, 1)
        else:
            mu = particle_sum(particles * weights[..., None], dim=-2) / _nonzero(total)[..., None]
            denom = torch.clamp(total - 1.0, min=1.0)[..., None, None]
        centered = particles - mu[..., None, :]
        left = centered if weights is None else centered * weights[..., None]
        gram = particle_all_reduce(torch.matmul(left.transpose(-2, -1), centered))
        return ParameterBeam(mu, gram / denom, energy=self.energy, total_charge=self.total_charge)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(n={self.num_particles!r}, {self._repr_fields()})"
