"""Transverse deflecting cavity (TDS): an RF structure whose deflecting mode
streaks the bunch, mapping each particle's longitudinal position onto y
(onto x at a tilt of pi / 2).

The JAX package has no counterpart of this element: its map is the port's
own (``ops.rmatrix.tds_rmatrix``), first order in the coordinates and
linear, so it is skippable and folds into its run like a magnet.  It has no
map builder of the fused kernels (``accelerator.fused.element_map_builder``
returns None), so a run that holds it takes the dense route.
"""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, as_field, draw_patch, first_value
from lynx_tpu_torch.ops.rmatrix import tds_rmatrix
from lynx_tpu_torch.utils import resolve_device


class TransverseDeflectingCavity(Element):
    """Transverse deflecting cavity, streaking vertically at zero tilt.

    :param length: Length in meters.
    :param voltage: Deflecting voltage in volts.
    :param phase: Phase in degrees; 0 is the zero crossing (no net kick).
    :param frequency: Frequency in Hz.
    :param tilt: Tilt in the x-y plane in rad (pi/2 streaks horizontally).
    :param name: Unique identifier of the element.
    """

    def __init__(
        self,
        length,
        voltage=None,
        phase=None,
        frequency=None,
        tilt=None,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        device = resolve_device(device, length, voltage, phase, frequency, tilt)
        super().__init__(name=name, length=length, dtype=dtype, device=device)
        for field, value in (("voltage", voltage), ("phase", phase), ("frequency", frequency),
                             ("tilt", tilt)):
            self.register_buffer(field, torch.zeros_like(self.length) if value is None
                                 else as_field(value, dtype, device))

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        return tds_rmatrix(self.length, self.voltage, self.phase, self.frequency, self.tilt,
                           energy)

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            **{field: torch.broadcast_to(getattr(self, field), shape).clone()
               for field in ("length", "voltage", "phase", "frequency", "tilt")},
            name=self.name,
            dtype=self.length.dtype,
            device=self.length.device,
        )

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def is_active(self) -> bool:
        return bool(torch.any(self.voltage != 0))

    def split(self, resolution: float) -> list:
        """Slices carrying a length-proportional share of the voltage: the
        map's generator is the same per unit length, so the slices' maps
        compose to the whole map."""
        total = float(torch.max(self.length))
        pieces = []
        remaining = total
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            pieces.append(TransverseDeflectingCavity(
                torch.full_like(self.length, piece), voltage=self.voltage * (piece / total),
                phase=self.phase, frequency=self.frequency, tilt=self.tilt,
                dtype=self.length.dtype, device=self.length.device))
            remaining -= piece
        return pieces

    def plot(self, ax, s: float) -> None:
        draw_patch(ax, (s, 0), first_value(self.length), 0.4, "olive", self.is_active)

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["length", "voltage", "phase", "frequency", "tilt"]
