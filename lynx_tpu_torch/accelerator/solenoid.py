"""Solenoid magnet (counterpart of ``lynx_tpu.accelerator.solenoid``)."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, as_field
from lynx_tpu_torch.constants import REST_ENERGY_EV
from lynx_tpu_torch.ops.rmatrix import build_rmatrix, misalignment_matrix, sandwich
from lynx_tpu_torch.utils import resolve_device


def solenoid_entries(length, k, energy) -> dict:
    """Entry dict of the solenoid's body map (A. W. Chao, p. 74), branch-free
    at k == 0 (sin(kL)/k -> L) and at E == 0 (r56 -> 0)."""
    gamma = energy / REST_ENERGY_EV
    c = torch.cos(length * k)
    s = torch.sin(length * k)
    k_safe = torch.where(k == 0, 1.0, k)
    s_k = torch.where(k == 0, length, s / k_safe)
    gamma_safe = torch.where(gamma == 0, 1.0, gamma)
    beta2_gamma2 = gamma_safe**2 - 1.0
    r56 = torch.where(
        gamma == 0, 0.0, -length / torch.where(beta2_gamma2 == 0, 1.0, beta2_gamma2)
    )
    return {
        (0, 0): c**2, (0, 1): c * s_k, (0, 2): s * c, (0, 3): s * s_k,
        (1, 0): -k * s * c, (1, 1): c**2, (1, 2): -k * s**2, (1, 3): s * c,
        (2, 0): -s * c, (2, 1): -s * s_k, (2, 2): c**2, (2, 3): c * s_k,
        (3, 0): k * s**2, (3, 1): -s * c, (3, 2): -k * s * c, (3, 3): c**2,
        (4, 5): r56,
    }


class Solenoid(Element):
    """Solenoid magnet.

    :param length: Length in meters.
    :param k: Normalised strength B0 / (2 Brho) in 1/m.
    :param misalignment: ``(..., 2)`` x/y misalignment in meters.
    :param name: Unique identifier of the element.
    """

    def __init__(
        self,
        length=None,
        k=None,
        misalignment=None,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        device = resolve_device(device, length, k, misalignment)
        super().__init__(name=name, length=length, dtype=dtype, device=device)
        length = self.length
        self.register_buffer(
            "k", as_field(k, dtype, device) if k is not None else torch.zeros_like(length)
        )
        self.register_buffer(
            "misalignment",
            as_field(misalignment, dtype, device)
            if misalignment is not None
            else torch.zeros((*length.shape, 2), dtype=dtype, device=length.device),
        )

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        energy = torch.as_tensor(energy, dtype=self.length.dtype, device=self.length.device)
        batch_shape = torch.broadcast_shapes(self.length.shape, self.k.shape, energy.shape)
        entries = solenoid_entries(
            *(torch.broadcast_to(a, batch_shape) for a in (self.length, self.k, energy))
        )
        R = build_rmatrix(entries, batch_shape, self.length.dtype, self.length.device)
        R_entry, R_exit = misalignment_matrix(self.misalignment)
        return sandwich(R_exit, R, R_entry)

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            length=torch.broadcast_to(self.length, shape).clone(),
            k=torch.broadcast_to(self.k, shape).clone(),
            misalignment=torch.broadcast_to(self.misalignment, (*shape, 2)).clone(),
            name=self.name,
            dtype=self.length.dtype,
            device=self.length.device,
        )

    @property
    def is_active(self) -> bool:
        return bool(torch.any(self.k != 0))

    @property
    def is_skippable(self) -> bool:
        return True

    def split(self, resolution: float) -> list:
        """Slices of equal k compose exactly (the interior exit and entry
        shifts cancel)."""
        pieces = []
        remaining = float(torch.max(self.length))
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            pieces.append(
                Solenoid(torch.full_like(self.length, piece), k=self.k,
                         misalignment=self.misalignment)
            )
            remaining -= piece
        return pieces or [self]

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["length", "k", "misalignment"]
