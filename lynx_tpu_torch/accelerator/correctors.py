"""Thin-kick corrector magnets (counterpart of
``lynx_tpu.accelerator.correctors``): a drift with a thin kick applied via
the affine (7th) column."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, as_field, draw_patch, first_value
from lynx_tpu_torch.ops.rmatrix import _safe_div, build_rmatrix, igamma2_from_energy
from lynx_tpu_torch.utils import resolve_device


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
        device = resolve_device(device, length, angle)
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

    @property
    def is_active(self) -> bool:
        return bool(torch.any(self.angle != 0))

    def split(self, resolution: float) -> list:
        """Slices sharing the kick in proportion to their length."""
        pieces = []
        total = float(torch.max(self.length))
        remaining = total
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            pieces.append(
                self.__class__(torch.full_like(self.length, piece), self.angle * piece / total)
            )
            remaining -= piece
        return pieces

    def plot(self, ax, s: float) -> None:
        sign = float(torch.sign(self.angle.reshape(-1)[0])) if self.is_active else 1.0
        draw_patch(ax, (s, 0), first_value(self.length), 0.8 * sign, self._plot_color, self.is_active)

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["length", "angle"]


class HorizontalCorrector(_Corrector):
    """Horizontal corrector: drift + thin kick x' += angle."""

    _kick_row = 1
    _plot_color = "tab:blue"


class VerticalCorrector(_Corrector):
    """Vertical corrector: drift + thin kick y' += angle."""

    _kick_row = 3
    _plot_color = "tab:cyan"
