"""Drift section (counterpart of ``lynx_tpu.accelerator.drift``)."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element
from lynx_tpu_torch.ops.rmatrix import drift_rmatrix


class Drift(Element):
    """Drift section: linear approximation with r56 = -L / (beta^2 gamma^2).

    :param length: Length in meters.
    :param name: Unique identifier of the element.
    """

    def __init__(
        self,
        length,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__(name=name, length=length, dtype=dtype, device=device)

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        return drift_rmatrix(self.length, energy)

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            length=torch.broadcast_to(self.length, shape).clone(),
            name=self.name,
            dtype=self.length.dtype,
            device=self.length.device,
        )

    @property
    def is_skippable(self) -> bool:
        return True

    def split(self, resolution: float) -> list:
        pieces = []
        remaining = float(torch.max(self.length))
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            pieces.append(Drift(torch.full_like(self.length, piece)))
            remaining -= piece
        return pieces

    def plot(self, ax, s: float) -> None:
        pass

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["length"]
