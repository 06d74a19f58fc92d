"""Beam position monitor (counterpart of ``lynx_tpu.accelerator.bpm``)."""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, draw_patch
from lynx_tpu_torch.graphs import capturing
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam


def bpm_reading(beam: Beam) -> torch.Tensor:
    """Stacked ``[mu_x, mu_y]`` reading."""
    return torch.stack([beam.mu_x, beam.mu_y])


class BPM(Element):
    """Beam position monitor: records ``[mu_x, mu_y]`` and passes the beam on.

    :param is_active: If ``True`` the BPM is tracked on its own (not fused
        into its neighbours' maps) and records the beam position.
    :param name: Unique identifier of the element.
    """

    # The plain attribute that an element rebuilt by ``from_fields`` falls
    # back to.
    reading = None

    def __init__(
        self,
        is_active: bool = False,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__(name=name, dtype=dtype, device=device)
        self.is_active = is_active

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        energy = torch.as_tensor(energy)
        eye = torch.eye(7, dtype=energy.dtype, device=energy.device)
        return torch.broadcast_to(eye, (*energy.shape, 7, 7))

    def track(self, incoming: Beam) -> Beam:
        if incoming is Beam.empty:
            self.reading = None
        elif isinstance(incoming, (ParameterBeam, ParticleBeam)):
            reading = bpm_reading(incoming)
            if not capturing():
                self.reading = reading
            elif self.is_active:
                # As Screen.track: a captured reading is a static buffer.
                warnings.warn(
                    f"BPM {self.name!r} was tracked inside a captured function"
                    " (graphs.graphed, functional.track_jit): the stateful '.reading'"
                    " is NOT updated. Use lynx_tpu_torch.functional.track_jit's"
                    " diagnostics output instead.",
                    stacklevel=2,
                )
        else:
            raise TypeError(f"Parameter incoming is of invalid type {type(incoming)}")
        return incoming

    def broadcast(self, shape: tuple) -> Element:
        new_bpm = self.__class__(
            is_active=self.is_active, name=self.name,
            dtype=self.length.dtype, device=self.length.device,
        )
        new_bpm.length = torch.broadcast_to(self.length, shape).clone()
        return new_bpm

    def plot(self, ax, s: float) -> None:
        draw_patch(ax, (s, -0.3), 0, 0.3 * 2, "darkkhaki", self.is_active)

    def split(self, resolution: float) -> list:
        return [self]
