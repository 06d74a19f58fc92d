"""Quadrupole magnet (counterpart of ``lynx_tpu.accelerator.quadrupole``)."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, as_field, draw_patch, first_value
from lynx_tpu_torch.ops.rmatrix import base_rmatrix, misalignment_matrix, sandwich
from lynx_tpu_torch.utils import resolve_device


class Quadrupole(Element):
    """Quadrupole magnet.

    :param length: Length in meters.
    :param k1: Strength of the quadrupole in 1/m^2.
    :param misalignment: ``(..., 2)`` misalignment in x/y in meters.
    :param tilt: Tilt in the x-y plane in rad (pi/4 for a skew quadrupole).
    :param name: Unique identifier of the element.
    """

    def __init__(
        self,
        length,
        k1=None,
        misalignment=None,
        tilt=None,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        device = resolve_device(device, length, k1, misalignment, tilt)
        super().__init__(name=name, length=length, dtype=dtype, device=device)
        length = self.length
        self.register_buffer(
            "k1", as_field(k1, dtype, device) if k1 is not None else torch.zeros_like(length)
        )
        self.register_buffer(
            "misalignment",
            as_field(misalignment, dtype, device)
            if misalignment is not None
            else torch.zeros((*length.shape, 2), dtype=dtype, device=length.device),
        )
        self.register_buffer(
            "tilt", as_field(tilt, dtype, device) if tilt is not None else torch.zeros_like(length)
        )

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        R = base_rmatrix(
            length=self.length,
            k1=self.k1,
            hx=torch.zeros_like(self.length),
            tilt=self.tilt,
            energy=energy,
        )
        # Misalignment sandwich R_exit @ R @ R_entry; exact identity when the
        # misalignment is zero, so applied unconditionally (branch-free).
        R_entry, R_exit = misalignment_matrix(self.misalignment)
        return sandwich(R_exit, R, R_entry)

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            length=torch.broadcast_to(self.length, shape).clone(),
            k1=torch.broadcast_to(self.k1, shape).clone(),
            misalignment=torch.broadcast_to(self.misalignment, (*shape, 2)).clone(),
            tilt=torch.broadcast_to(self.tilt, shape).clone(),
            name=self.name,
            dtype=self.length.dtype,
            device=self.length.device,
        )

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def is_active(self) -> bool:
        return bool(torch.any(self.k1 != 0))

    def split(self, resolution: float) -> list:
        pieces = []
        remaining = float(torch.max(self.length))
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            pieces.append(
                Quadrupole(torch.full_like(self.length, piece), self.k1,
                           misalignment=self.misalignment, tilt=self.tilt)
            )
            remaining -= piece
        return pieces

    def plot(self, ax, s: float) -> None:
        sign = float(torch.sign(self.k1.reshape(-1)[0])) if self.is_active else 1.0
        draw_patch(ax, (s, 0), first_value(self.length), 0.8 * sign, "tab:red", self.is_active)

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["length", "k1", "misalignment", "tilt"]
