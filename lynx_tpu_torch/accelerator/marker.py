"""Marker no-op element (counterpart of ``lynx_tpu.accelerator.marker``)."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element
from lynx_tpu_torch.particles import Beam


class Marker(Element):
    """General marker: identity map, passes the beam through unchanged.

    :param name: Unique identifier of the element.
    """

    def __init__(
        self, name: Optional[str] = None, dtype: torch.dtype = torch.float32, device=None
    ) -> None:
        super().__init__(name=name, dtype=dtype, device=device)

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        energy = torch.as_tensor(energy)
        eye = torch.eye(7, dtype=energy.dtype, device=energy.device)
        return torch.broadcast_to(eye, (*energy.shape, 7, 7))

    def track(self, incoming: Beam) -> Beam:
        return incoming

    def broadcast(self, shape: tuple) -> Element:
        new_marker = self.__class__(
            name=self.name, dtype=self.length.dtype, device=self.length.device
        )
        new_marker.length = torch.broadcast_to(self.length, shape).clone()
        return new_marker

    @property
    def is_skippable(self) -> bool:
        return True

    def split(self, resolution: float) -> list:
        return [self]
