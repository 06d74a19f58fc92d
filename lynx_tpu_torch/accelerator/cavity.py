"""Accelerating RF cavity, the one nonlinear, energy-changing element
(counterpart of ``lynx_tpu.accelerator.cavity``).

Tracking applies:

1. the cavity's linear map (``ops.rmatrix.cavity_rmatrix``),
2. the reference-energy update ``E -> E + V cos(phi)``,
3. the phase-dependent update of each particle's energy deviation ``p``,
4. the second-order longitudinal terms T566, T556 and T555 on ``s``.

Every condition is a per-entry ``torch.where``, so a batch that mixes
voltages of 0 and V stays finite.  A ParameterBeam's covariance takes the
linear map only (the JAX package's choice, adjudicated in its tests); its
mean takes the same nonlinear refinements as a particle.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, as_field, draw_patch, first_value
from lynx_tpu_torch.constants import ELECTRON_MASS_EV, SPEED_OF_LIGHT
from lynx_tpu_torch.ops.rmatrix import cavity_rmatrix
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam
from lynx_tpu_torch.utils import resolve_device


class Cavity(Element):
    """Accelerating cavity.

    :param length: Length in meters.
    :param voltage: Voltage of the cavity in volts.
    :param phase: Phase of the cavity in degrees.
    :param frequency: Frequency of the cavity in Hz.
    :param name: Unique identifier of the element.
    """

    def __init__(
        self,
        length,
        voltage=None,
        phase=None,
        frequency=None,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        device = resolve_device(device, length, voltage, phase, frequency)
        super().__init__(name=name, length=length, dtype=dtype, device=device)

        def param(value):
            if value is None:
                return torch.zeros_like(self.length)
            return as_field(value, dtype, device)

        self.register_buffer("voltage", param(voltage))
        self.register_buffer("phase", param(phase))
        self.register_buffer("frequency", param(frequency))

    @property
    def is_active(self) -> bool:
        return bool(torch.any(self.voltage != 0))

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        return cavity_rmatrix(self.length, self.voltage, self.phase, self.frequency, energy)

    def track(self, incoming: Beam) -> Beam:
        if incoming is Beam.empty:
            return incoming
        if isinstance(incoming, (ParameterBeam, ParticleBeam)):
            return self._track_beam(incoming)
        raise TypeError(f"Parameter incoming is of invalid type {type(incoming)}")

    def _track_beam(self, incoming: Beam) -> Beam:
        dtype, device = self.length.dtype, self.length.device
        energy = torch.as_tensor(incoming.energy, dtype=dtype, device=device)

        has_energy = energy != 0
        g0 = torch.where(has_energy, energy / ELECTRON_MASS_EV, 1e10)
        igamma2 = torch.where(has_energy, 1.0 / g0**2, 0.0)
        beta0 = torch.where(has_energy, torch.sqrt(1.0 - igamma2), 1.0)

        phi = torch.deg2rad(self.phase)
        cos_phi = torch.cos(phi)
        delta_energy = self.voltage * cos_phi
        outgoing_energy = energy + delta_energy

        # 1. The linear part.
        tm = self.transfer_map(energy)
        if isinstance(incoming, ParameterBeam):
            out_dtype = torch.promote_types(tm.dtype, incoming._mu.dtype)
            tm_o = tm.to(out_dtype)
            outgoing_mu = torch.matmul(tm_o, incoming._mu.to(out_dtype)[..., None])[..., 0]
            outgoing_cov = torch.matmul(
                tm_o, torch.matmul(incoming._cov.to(out_dtype), tm_o.transpose(-2, -1))
            )
        else:
            out_dtype = torch.promote_types(tm.dtype, incoming.particles.dtype)
            outgoing_particles = torch.matmul(
                incoming.particles.to(out_dtype), tm.to(out_dtype).transpose(-2, -1)
            )

        # 2./3. The energy gain and the nonlinear p update, per entry; gated
        # on delta_energy != 0 too, so that an inactive cavity is a drift.
        k = 2.0 * math.pi * self.frequency / SPEED_OF_LIGHT
        accelerated = (outgoing_energy > 0) & (delta_energy != 0)
        out_E_safe = torch.where(accelerated, outgoing_energy, 1.0)
        g1 = out_E_safe / ELECTRON_MASS_EV
        g1 = torch.where(g1 > 1.0, g1, 2.0)  # keeps beta1 well defined
        beta1 = torch.sqrt(1.0 - 1.0 / g1**2)

        # Second-order longitudinal coefficients: drift-like defaults,
        # refined where the cavity accelerates (delta_energy > 0).  A gain
        # below the energy's resolution (g1 == g0: cos(phi) = 0 in float64)
        # keeps the defaults, where the JAX package divides by g0 - g1 = 0.
        length = self.length
        T566_default = 1.5 * length * igamma2 / beta0**3
        accel = (delta_energy > 0) & (g1 != g0)
        dg = torch.where(accel, g0 - g1, 1.0)
        dgamma = self.voltage / ELECTRON_MASS_EV
        sin_phi = torch.sin(phi)
        T566 = torch.where(
            accel,
            length * (beta0**3 * g0**3 - beta1**3 * g1**3)
            / (2 * beta0 * beta1**3 * g0 * dg * g1**3),
            T566_default,
        )
        T556 = torch.where(
            accel,
            beta0 * k * length * dgamma * g0 * (beta1**3 * g1**3 + beta0 * (g0 - g1**3))
            * sin_phi / (beta1**3 * g1**3 * dg**2),
            0.0,
        )
        T555 = torch.where(
            accel,
            beta0**2 * k**2 * length * dgamma / 2.0
            * (
                dgamma
                * (2 * g0 * g1**3 * (beta0 * beta1**3 - 1) + g0**2 + 3 * g1**2 - 2)
                / (beta1**3 * g1**3 * dg**3)
                * sin_phi**2
                - (g1 * g0 * (beta1 * beta0 - 1) + 1) / (beta1 * g1 * dg**2) * cos_phi
            ),
            0.0,
        )

        if isinstance(incoming, ParameterBeam):
            mu_in = incoming._mu
            p_updated = mu_in[..., 5] * energy * beta0 / (out_E_safe * beta1) + (
                self.voltage * beta0 / (out_E_safe * beta1)
                * (torch.cos(-mu_in[..., 4] * beta0 * k + phi) - cos_phi)
            )
            p_out = torch.where(accelerated, p_updated, outgoing_mu[..., 5])
            s_second_order = outgoing_mu[..., 4] + (
                T566 * mu_in[..., 5] ** 2
                + T556 * mu_in[..., 4] * mu_in[..., 5]
                + T555 * mu_in[..., 4] ** 2
            )
            s_out = torch.where(accelerated, s_second_order, outgoing_mu[..., 4])
            shape = torch.broadcast_shapes(outgoing_mu.shape[:-1], s_out.shape, p_out.shape)
            outgoing_mu = torch.cat(
                [
                    torch.broadcast_to(outgoing_mu[..., :4], (*shape, 4)),
                    torch.broadcast_to(s_out, shape)[..., None].to(outgoing_mu.dtype),
                    torch.broadcast_to(p_out, shape)[..., None].to(outgoing_mu.dtype),
                    torch.broadcast_to(outgoing_mu[..., 6:], (*shape, 1)),
                ],
                dim=-1,
            )
            return ParameterBeam(
                outgoing_mu, outgoing_cov, outgoing_energy, total_charge=incoming.total_charge
            )

        # ParticleBeam: per particle, leading dims broadcast.
        s_in = incoming.particles[..., 4]
        p_in = incoming.particles[..., 5]
        p_updated = p_in * (energy * beta0 / (out_E_safe * beta1))[..., None] + (
            (self.voltage * beta0 / (out_E_safe * beta1))[..., None]
            * (torch.cos(-s_in * (beta0 * k)[..., None] + phi[..., None]) - cos_phi[..., None])
        )
        acc_mask = accelerated[..., None]
        p_out = torch.where(acc_mask, p_updated, outgoing_particles[..., 5])
        s_second_order = outgoing_particles[..., 4] + (
            T566[..., None] * p_in**2 + T556[..., None] * s_in * p_in + T555[..., None] * s_in**2
        )
        s_out = torch.where(acc_mask, s_second_order, outgoing_particles[..., 4])
        shape = outgoing_particles.shape[:-1]
        outgoing_particles = torch.cat(
            [
                outgoing_particles[..., :4],
                torch.broadcast_to(s_out, shape)[..., None].to(outgoing_particles.dtype),
                torch.broadcast_to(p_out, shape)[..., None].to(outgoing_particles.dtype),
                outgoing_particles[..., 6:],
            ],
            dim=-1,
        )
        return ParticleBeam(
            outgoing_particles,
            outgoing_energy,
            particle_charges=incoming.particle_charges,
            survival=incoming.survival,
        )

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            length=torch.broadcast_to(self.length, shape).clone(),
            voltage=torch.broadcast_to(self.voltage, shape).clone(),
            phase=torch.broadcast_to(self.phase, shape).clone(),
            frequency=torch.broadcast_to(self.frequency, shape).clone(),
            name=self.name,
            dtype=self.length.dtype,
            device=self.length.device,
        )

    def split(self, resolution: float) -> list:
        """Slices carrying a length-proportional share of the voltage (the
        same phase and frequency): an approximation that converges to the
        unsplit map as O(1/n^2), not exact like the linear elements'."""
        total = float(torch.max(self.length))
        if total <= 1e-6:
            return [self]
        pieces = []
        remaining = total
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            pieces.append(
                Cavity(
                    torch.full_like(self.length, piece),
                    voltage=self.voltage * (piece / total),
                    phase=self.phase,
                    frequency=self.frequency,
                )
            )
            remaining -= piece
        return pieces

    def plot(self, ax, s: float) -> None:
        draw_patch(ax, (s, 0), first_value(self.length), 0.4, "gold", self.is_active)

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["length", "voltage", "phase", "frequency"]
