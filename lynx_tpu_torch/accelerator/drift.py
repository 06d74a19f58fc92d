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
