"""Gaussian-moment beam (counterpart of ``lynx_tpu.particles.parameter_beam``).

``ParameterBeam`` carries the mean ``mu (..., 7)`` and covariance
``cov (..., 7, 7)`` of the phase-space distribution.  A linear map R
propagates it as ``mu' = R mu``, ``cov' = R cov R^T``.
"""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.particles.beam import Beam, _common_shape, _resolve


class ParameterBeam(Beam):
    """Beam described by its Gaussian moments.

    :param mu: ``(..., 7)`` mean of the distribution.
    :param cov: ``(..., 7, 7)`` covariance of the distribution.
    :param energy: ``(...)`` reference energy in eV.
    :param total_charge: ``(...)`` total bunch charge in C.
    """

    def __init__(
        self,
        mu,
        cov,
        energy,
        total_charge=None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> None:
        self._mu = torch.as_tensor(mu, dtype=dtype, device=device)
        dtype, device = self._mu.dtype, self._mu.device
        self._cov = torch.as_tensor(cov, dtype=dtype, device=device)
        self.energy = torch.as_tensor(energy, dtype=dtype, device=device)
        self.total_charge = (
            torch.as_tensor(total_charge, dtype=dtype, device=device)
            if total_charge is not None
            else torch.zeros_like(self.energy)
        )

    @classmethod
    def from_parameters(
        cls,
        mu_x=None,
        mu_xp=None,
        mu_y=None,
        mu_yp=None,
        sigma_x=None,
        sigma_xp=None,
        sigma_y=None,
        sigma_yp=None,
        sigma_s=None,
        sigma_p=None,
        cor_x=None,
        cor_y=None,
        cor_s=None,
        energy=None,
        total_charge=None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "ParameterBeam":
        """Assemble moments from the 15 scalar beam parameters (the JAX
        package's defaults)."""
        shape = _common_shape(
            [mu_x, mu_xp, mu_y, mu_yp, sigma_x, sigma_xp, sigma_y, sigma_yp,
             sigma_s, sigma_p, cor_x, cor_y, cor_s, energy, total_charge]
        )

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

        zeros = torch.zeros(shape, dtype=dtype, device=device)
        ones = torch.ones(shape, dtype=dtype, device=device)
        mu = torch.stack([mu_x, mu_xp, mu_y, mu_yp, zeros, zeros, ones], dim=-1)
        cov = _block_covariance(
            7, sigma_x, sigma_xp, sigma_y, sigma_yp, sigma_s, sigma_p, cor_x, cor_y, cor_s
        )
        return cls(mu=mu, cov=cov, energy=energy, total_charge=total_charge)

    # -- statistics --------------------------------------------------------
    def _sigma(self, i: int) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self._cov[..., i, i], min=1e-20))

    @property
    def mu_x(self) -> torch.Tensor:
        return self._mu[..., 0]

    @property
    def mu_xp(self) -> torch.Tensor:
        return self._mu[..., 1]

    @property
    def mu_y(self) -> torch.Tensor:
        return self._mu[..., 2]

    @property
    def mu_yp(self) -> torch.Tensor:
        return self._mu[..., 3]

    @property
    def mu_s(self) -> torch.Tensor:
        return self._mu[..., 4]

    @property
    def mu_p(self) -> torch.Tensor:
        return self._mu[..., 5]

    @property
    def sigma_x(self) -> torch.Tensor:
        return self._sigma(0)

    @property
    def sigma_xp(self) -> torch.Tensor:
        return self._sigma(1)

    @property
    def sigma_y(self) -> torch.Tensor:
        return self._sigma(2)

    @property
    def sigma_yp(self) -> torch.Tensor:
        return self._sigma(3)

    @property
    def sigma_s(self) -> torch.Tensor:
        return self._sigma(4)

    @property
    def sigma_p(self) -> torch.Tensor:
        return self._sigma(5)

    @property
    def sigma_xxp(self) -> torch.Tensor:
        return self._cov[..., 0, 1]

    @property
    def sigma_yyp(self) -> torch.Tensor:
        return self._cov[..., 2, 3]

    def broadcast(self, shape: tuple) -> "ParameterBeam":
        return self.__class__(
            mu=torch.broadcast_to(self._mu, (*shape, 7)),
            cov=torch.broadcast_to(self._cov, (*shape, 7, 7)),
            energy=torch.broadcast_to(self.energy, shape),
            total_charge=torch.broadcast_to(self.total_charge, shape),
        )


def _block_covariance(
    size, sigma_x, sigma_xp, sigma_y, sigma_yp, sigma_s, sigma_p, cor_x, cor_y, cor_s
) -> torch.Tensor:
    """``(..., size, size)`` covariance of the three uncoupled planes
    (``size`` is 7 for moments, 6 for sampling)."""
    cells = {
        (0, 0): sigma_x**2, (0, 1): cor_x, (1, 0): cor_x, (1, 1): sigma_xp**2,
        (2, 2): sigma_y**2, (2, 3): cor_y, (3, 2): cor_y, (3, 3): sigma_yp**2,
        (4, 4): sigma_s**2, (4, 5): cor_s, (5, 4): cor_s, (5, 5): sigma_p**2,
    }
    zeros = torch.zeros_like(sigma_x)
    return torch.stack(
        [
            torch.stack([cells.get((i, j), zeros) for j in range(size)], dim=-1)
            for i in range(size)
        ],
        dim=-2,
    )
