"""Beam base class (counterpart of ``lynx_tpu.particles.beam``).

Beams are plain classes that hold tensors.  ``Beam.empty`` is the sentinel
for a beam that is entirely lost or absorbed; elements pass it through.
The derived statistics (relativistic factors, emittances, Twiss
parameters) are shared by both representations and are tensor expressions
of the subclasses' moments, so autograd flows through them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from lynx_tpu_torch.constants import ELECTRON_MASS_EV


class Beam:
    #: Sentinel returned when a beam is entirely lost or absorbed.
    empty = "I'm an empty beam!"

    # -- constructors (implemented by the subclasses) -----------------------
    @classmethod
    def from_parameters(cls, **kwargs) -> "Beam":
        raise NotImplementedError

    @classmethod
    def from_twiss(cls, **kwargs) -> "Beam":
        raise NotImplementedError

    @classmethod
    def from_ocelot(cls, parray, **kwargs) -> "Beam":
        raise NotImplementedError

    @classmethod
    def from_astra(cls, path: str, **kwargs) -> "Beam":
        raise NotImplementedError

    def transformed_to(
        self,
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
        energy=None,
        total_charge=None,
    ) -> "Beam":
        """This beam rebuilt through ``from_parameters`` with the given
        parameters, the others this beam's, in its dtype and on its device.
        As in the JAX package only the parameters carry over: a
        ParameterBeam's x-x', y-y' and s-p correlations are dropped."""
        given = dict(
            mu_x=mu_x, mu_xp=mu_xp, mu_y=mu_y, mu_yp=mu_yp, sigma_x=sigma_x,
            sigma_xp=sigma_xp, sigma_y=sigma_y, sigma_yp=sigma_yp, sigma_s=sigma_s,
            sigma_p=sigma_p, energy=energy, total_charge=total_charge,
        )
        return self.__class__.from_parameters(
            **{key: getattr(self, key) if value is None else value for key, value in given.items()},
            dtype=self.energy.dtype,
            device=self.energy.device,
        )

    @property
    def parameters(self) -> dict:
        return {
            key: getattr(self, key)
            for key in ("mu_x", "mu_xp", "mu_y", "mu_yp", "sigma_x", "sigma_xp",
                        "sigma_y", "sigma_yp", "sigma_s", "sigma_p", "energy")
        }

    # -- relativistics -----------------------------------------------------
    @property
    def relativistic_gamma(self) -> torch.Tensor:
        return self.energy / ELECTRON_MASS_EV

    @property
    def relativistic_beta(self) -> torch.Tensor:
        gamma = self.relativistic_gamma
        nonzero = torch.abs(gamma) > 0
        gamma_safe = torch.where(nonzero, gamma, 1.0)
        return torch.where(nonzero, torch.sqrt(1.0 - 1.0 / gamma_safe**2), 1.0)

    # -- Twiss / emittance -------------------------------------------------
    @staticmethod
    def _emittance(sigma, sigma_prime, correlation) -> torch.Tensor:
        """Geometric emittance in m*rad, clamped at the dtype's ``tiny``."""
        squared = sigma**2 * sigma_prime**2 - correlation**2
        return torch.sqrt(torch.clamp(squared, min=torch.finfo(squared.dtype).tiny))

    @property
    def emittance_x(self) -> torch.Tensor:
        return self._emittance(self.sigma_x, self.sigma_xp, self.sigma_xxp)

    @property
    def emittance_y(self) -> torch.Tensor:
        return self._emittance(self.sigma_y, self.sigma_yp, self.sigma_yyp)

    @property
    def normalized_emittance_x(self) -> torch.Tensor:
        return self.emittance_x * self.relativistic_beta * self.relativistic_gamma

    @property
    def normalized_emittance_y(self) -> torch.Tensor:
        return self.emittance_y * self.relativistic_beta * self.relativistic_gamma

    @property
    def beta_x(self) -> torch.Tensor:
        return self.sigma_x**2 / self.emittance_x

    @property
    def beta_y(self) -> torch.Tensor:
        return self.sigma_y**2 / self.emittance_y

    @property
    def alpha_x(self) -> torch.Tensor:
        return -self.sigma_xxp / self.emittance_x

    @property
    def alpha_y(self) -> torch.Tensor:
        return -self.sigma_yyp / self.emittance_y

    def broadcast(self, shape: tuple) -> "Beam":
        raise NotImplementedError

    def _repr_fields(self) -> str:
        return ", ".join(
            f"{key}={getattr(self, key)!r}"
            for key in ("mu_x", "mu_xp", "mu_y", "mu_yp", "sigma_x", "sigma_xp", "sigma_y",
                        "sigma_yp", "sigma_s", "sigma_p", "energy", "total_charge")
        )

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self._repr_fields()})"


def _common_shape(args: Sequence, default: Tuple[int, ...] = (1,)) -> Tuple[int, ...]:
    shapes = [torch.as_tensor(a).shape for a in args if a is not None]
    return tuple(torch.broadcast_shapes(*shapes)) if shapes else default


def _resolve(value, default, shape, dtype, device) -> torch.Tensor:
    value = default if value is None else value
    if isinstance(value, (int, float)):
        # Filled on the device: no host copy, which a graph capture refuses.
        return torch.full(shape, value, dtype=dtype, device=device)
    return torch.broadcast_to(torch.as_tensor(value, dtype=dtype, device=device), shape)


def _host_arrays_to_device(
    arrays: Sequence[np.ndarray], dtype: torch.dtype, device: Optional[torch.device]
) -> list:
    """Float64 host arrays as tensors of ``dtype`` on ``device``: cast on the
    host (the rounding JAX's ``jnp.asarray(..., dtype)`` does), packed into
    one buffer and copied to the device once."""
    flat = [np.asarray(a, dtype=np.float64).ravel() for a in arrays]
    packed = torch.from_numpy(np.concatenate(flat)).to(dtype).to(device)
    out, start = [], 0
    for array, values in zip(arrays, flat):
        out.append(packed[start:start + values.size].reshape(np.shape(array)))
        start += values.size
    return out
