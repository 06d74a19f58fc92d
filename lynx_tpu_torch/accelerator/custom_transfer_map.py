"""An arbitrary transfer map wrapped as an element (counterpart of
``lynx_tpu.accelerator.custom_transfer_map``)."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, as_field
from lynx_tpu_torch.particles import Beam
from lynx_tpu_torch.utils import resolve_device


class CustomTransferMap(Element):
    """Element of a fixed ``(..., 7, 7)`` transfer map.

    :param transfer_map: The map.
    :param length: Length in meters (default 0).
    :param name: Unique identifier of the element.
    """

    def __init__(
        self,
        transfer_map,
        length=None,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        device = resolve_device(device, transfer_map, length)
        tm = as_field(transfer_map, dtype, device)
        assert tm.shape[-2:] == (7, 7)
        super().__init__(
            name=name,
            length=length if length is not None else torch.zeros(tm.shape[:-2], device=device),
            dtype=dtype,
            device=device,
        )
        self.register_buffer("_transfer_map", tm)

    @classmethod
    def from_merging_elements(cls, elements: list, incoming_beam: Beam) -> "CustomTransferMap":
        """Fold consecutive skippable elements into one map.  The beam is
        tracked through them for each element's entrance energy."""
        assert all(element.is_skippable for element in elements), (
            "Combining the elements in a Segment that is not skippable will"
            " result in incorrect tracking results."
        )
        energy = torch.as_tensor(incoming_beam.energy)
        tm = torch.broadcast_to(
            torch.eye(7, dtype=energy.dtype, device=energy.device), (*energy.shape, 7, 7)
        )
        beam = incoming_beam
        for element in elements:
            step = element.transfer_map(beam.energy)
            dtype = torch.promote_types(step.dtype, tm.dtype)
            tm = torch.matmul(step.to(dtype), tm.to(dtype))
            beam = element.track(beam)
        combined_length = sum(element.length for element in elements)
        combined_name = "combined_" + "_".join(element.name for element in elements)
        return cls(tm, length=combined_length, name=combined_name, device=tm.device)

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        return self._transfer_map

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            torch.broadcast_to(self._transfer_map, (*shape, 7, 7)).clone(),
            length=torch.broadcast_to(self.length, shape).clone(),
            name=self.name,
            dtype=self._transfer_map.dtype,
            device=self._transfer_map.device,
        )

    @property
    def is_skippable(self) -> bool:
        return True

    def split(self, resolution: float) -> list:
        return [self]

    def plot(self, ax, s: float) -> None:
        pass

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["transfer_map"]
