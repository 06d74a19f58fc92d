"""Undulator (counterpart of ``lynx_tpu.accelerator.undulator``)."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element
from lynx_tpu_torch.ops.rmatrix import build_rmatrix, igamma2_from_energy


class Undulator(Element):
    """Undulator: a drift with r56 = +L / gamma^2 (the reference's sign,
    without its beta^2 factor).

    :param length: Length in meters.
    :param is_active: Whether the undulator is active (no physics effect).
    :param name: Unique identifier of the element.
    """

    def __init__(
        self,
        length,
        is_active: bool = False,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__(name=name, length=length, dtype=dtype, device=device)
        self.is_active = is_active

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        energy = torch.as_tensor(energy, dtype=self.length.dtype, device=self.length.device)
        batch_shape = torch.broadcast_shapes(self.length.shape, energy.shape)
        length = torch.broadcast_to(self.length, batch_shape)
        igamma2 = igamma2_from_energy(torch.broadcast_to(energy, batch_shape), zero_value=0.0)
        return build_rmatrix(
            {(0, 1): length, (2, 3): length, (4, 5): length * igamma2},
            batch_shape, self.length.dtype, self.length.device,
        )

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            length=torch.broadcast_to(self.length, shape).clone(),
            is_active=self.is_active,
            name=self.name,
            dtype=self.length.dtype,
            device=self.length.device,
        )

    @property
    def is_skippable(self) -> bool:
        return True

    def split(self, resolution: float) -> list:
        """The map is linear in the length, so slices compose exactly."""
        pieces = []
        remaining = float(torch.max(self.length))
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            pieces.append(Undulator(torch.full_like(self.length, piece), is_active=self.is_active))
            remaining -= piece
        return pieces or [self]

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["length"]
