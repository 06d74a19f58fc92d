"""Physical aperture (collimator) (counterpart of
``lynx_tpu.accelerator.aperture``).

Lost particles are masked, not culled: they get survival weight 0 and charge
0, and no shape changes.  Survivor counts, downstream statistics and screen
images are those of a culling aperture, and a beam that loses every particle
comes back as ``Beam.empty``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lynx_tpu_torch._collectives import all_lost
from lynx_tpu_torch.accelerator.element import Element, as_field, draw_patch
from lynx_tpu_torch.particles import Beam, ParticleBeam
from lynx_tpu_torch.utils import resolve_device


def aperture_survival_mask(xs, ys, x_max, y_max, shape: str) -> torch.Tensor:
    """Boolean mask of the particles that pass the aperture: rectangular is
    strict, elliptical inclusive."""
    if shape == "rectangular":
        return (xs > -x_max) & (xs < x_max) & (ys > -y_max) & (ys < y_max)
    if shape == "elliptical":
        return (xs**2 / x_max**2 + ys**2 / y_max**2) <= 1.0
    raise ValueError(f"Unknown aperture shape {shape!r}")


def _per_particle(bound: torch.Tensor) -> torch.Tensor:
    """A batched bound gets a trailing particle axis."""
    return bound[..., None] if bound.ndim else bound


class Aperture(Element):
    """Particle-culling aperture.

    :param x_max: Horizontal half-aperture in meters (default: no limit).
    :param y_max: Vertical half-aperture in meters (default: no limit).
    :param shape: ``"rectangular"`` or ``"elliptical"``.
    :param is_active: Whether the aperture blocks particles.
    :param name: Unique identifier of the element.
    """

    # Plain attributes that an element rebuilt by ``from_fields`` falls back
    # to: the last track's loss mask and what the lost-particle accessors read.
    lost_mask = None
    _last_particles = None
    _last_charges = None

    def __init__(
        self,
        x_max=None,
        y_max=None,
        shape: str = "rectangular",
        is_active: bool = True,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        device = resolve_device(device, x_max, y_max)
        super().__init__(name=name, dtype=dtype, device=device)
        self.register_buffer("x_max", as_field(x_max if x_max is not None else math.inf, dtype, device))
        self.register_buffer("y_max", as_field(y_max if y_max is not None else math.inf, dtype, device))
        self.shape = shape
        self.is_active = is_active

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        energy = torch.as_tensor(energy)
        eye = torch.eye(7, dtype=self.x_max.dtype, device=self.x_max.device)
        return torch.broadcast_to(eye, (*energy.shape, 7, 7))

    def masked(self, incoming: ParticleBeam) -> ParticleBeam:
        """``incoming`` with the particles outside the aperture at survival 0
        and charge 0; shapes unchanged."""
        mask = aperture_survival_mask(
            incoming.xs, incoming.ys, _per_particle(self.x_max), _per_particle(self.y_max),
            self.shape,
        ).to(incoming.particles.dtype)
        return ParticleBeam(
            incoming.particles,
            incoming.energy,
            particle_charges=incoming.particle_charges * mask,
            survival=mask if incoming.survival is None else incoming.survival * mask,
        )

    def track(self, incoming: Beam) -> Beam:
        # Only particle beams are culled, and only by an active aperture.
        if not (isinstance(incoming, ParticleBeam) and self.is_active):
            return incoming
        outgoing = self.masked(incoming)
        self.lost_mask = outgoing.survival == 0
        self._last_particles = incoming.particles
        self._last_charges = incoming.particle_charges
        if all_lost(outgoing.survival):
            return Beam.empty  # every particle lost (of every shard)
        return outgoing

    @property
    def lost_particles(self) -> Optional[torch.Tensor]:
        """Particles lost in the last track (boolean indexing: the count is
        data-dependent)."""
        if self.lost_mask is None:
            return None
        return self._last_particles[self.lost_mask]

    @property
    def lost_particle_charges(self) -> Optional[torch.Tensor]:
        """Charges of the particles lost in the last track."""
        if self.lost_mask is None:
            return None
        return self._last_charges[self.lost_mask]

    def broadcast(self, shape: tuple) -> Element:
        new_aperture = self.__class__(
            x_max=torch.broadcast_to(self.x_max, shape).clone(),
            y_max=torch.broadcast_to(self.y_max, shape).clone(),
            shape=self.shape,
            is_active=self.is_active,
            name=self.name,
            dtype=self.x_max.dtype,
            device=self.x_max.device,
        )
        new_aperture.length = torch.broadcast_to(self.length, shape).clone()
        return new_aperture

    def split(self, resolution: float) -> list:
        return [self]

    def plot(self, ax, s: float) -> None:
        draw_patch(ax, (s, 0), 0.0, 0.4, "tab:pink", self.is_active)

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["x_max", "y_max", "shape", "is_active"]

    def extra_repr(self) -> str:
        return f"shape={self.shape!r}, is_active={self.is_active!r}, name={self.name!r}"
