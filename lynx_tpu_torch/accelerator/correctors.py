"""Thin-kick corrector magnets (counterpart of
``lynx_tpu.accelerator.correctors``): a drift with a thin kick applied via
the affine (7th) column."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, as_field
from lynx_tpu_torch.ops.rmatrix import _safe_div, build_rmatrix, igamma2_from_energy


class _Corrector(Element):
    """Shared implementation; the kick lands on row ``_kick_row``."""

    _kick_row: int = 1

    def __init__(
        self,
        length,
        angle=None,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__(name=name, length=length, dtype=dtype, device=device)
        self.register_buffer(
            "angle",
            as_field(angle, dtype, device) if angle is not None else torch.zeros_like(self.length),
        )

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        length = self.length
        energy = torch.as_tensor(energy, dtype=length.dtype, device=length.device)
        batch_shape = torch.broadcast_shapes(length.shape, self.angle.shape, energy.shape)
        length = torch.broadcast_to(length, batch_shape)
        igamma2 = igamma2_from_energy(
            torch.broadcast_to(energy, batch_shape), zero_value=0.0
        )
        beta2 = 1.0 - igamma2
        r56 = -length * _safe_div(igamma2, beta2, fallback=0.0)
        return build_rmatrix(
            {
                (0, 1): length,
                (self._kick_row, 6): torch.broadcast_to(self.angle, batch_shape),
                (2, 3): length,
                (4, 5): r56,
            },
            batch_shape,
            length.dtype,
            length.device,
        )

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            length=torch.broadcast_to(self.length, shape).clone(),
            angle=torch.broadcast_to(self.angle, shape).clone(),
            name=self.name,
            dtype=self.length.dtype,
            device=self.length.device,
        )

    @property
    def is_skippable(self) -> bool:
        return True


class HorizontalCorrector(_Corrector):
    """Horizontal corrector: drift + thin kick x' += angle."""

    _kick_row = 1


class VerticalCorrector(_Corrector):
    """Vertical corrector: drift + thin kick y' += angle."""

    _kick_row = 3
