"""Sector bending magnet with fringe fields, and the rectangular bend
(counterpart of ``lynx_tpu.accelerator.dipole``)."""

from __future__ import annotations

from typing import Optional

import torch

from lynx_tpu_torch.accelerator.element import Element, as_field
from lynx_tpu_torch.ops.rmatrix import base_rmatrix, build_rmatrix, rotation_matrix, sandwich
from lynx_tpu_torch.utils import resolve_device

_FIELDS = ("angle", "e1", "e2", "tilt", "fringe_integral", "fringe_integral_exit", "gap")


def dipole_hx(length: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Curvature angle / length, 0 for a zero-length dipole."""
    length_safe = torch.where(length == 0, 1.0, length)
    return torch.where(length == 0, 0.0, angle / length_safe)


class Dipole(Element):
    """Dipole magnet (by default a sector bend).

    :param length: Length in meters.
    :param angle: Deflection angle in rad.
    :param e1: Inclination of the entrance face in rad.
    :param e2: Inclination of the exit face in rad.
    :param tilt: Tilt in the x-y plane in rad.
    :param fringe_integral: Fringe field integral of the entrance face.
    :param fringe_integral_exit: Fringe field integral of the exit face
        (defaults to the entrance value).
    :param gap: Magnet gap in meters.
    :param name: Unique identifier of the element.
    """

    def __init__(
        self,
        length,
        angle=None,
        e1=None,
        e2=None,
        tilt=None,
        fringe_integral=None,
        fringe_integral_exit=None,
        gap=None,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        device = resolve_device(
            device, length, angle, e1, e2, tilt, fringe_integral, fringe_integral_exit, gap
        )
        super().__init__(name=name, length=length, dtype=dtype, device=device)

        def param(value):
            if value is None:
                return torch.zeros_like(self.length)
            return as_field(value, dtype, device)

        self.register_buffer("angle", param(angle))
        self.register_buffer("gap", param(gap))
        self.register_buffer("tilt", param(tilt))
        self.register_buffer("fringe_integral", param(fringe_integral))
        self.register_buffer(
            "fringe_integral_exit",
            self.fringe_integral if fringe_integral_exit is None
            else as_field(fringe_integral_exit, dtype, device),
        )
        self.register_buffer("e1", param(e1))
        self.register_buffer("e2", param(e2))

    @property
    def hx(self) -> torch.Tensor:
        """Curvature angle / length, 0 for a zero-length dipole."""
        return dipole_hx(self.length, self.angle)

    @property
    def is_skippable(self) -> bool:
        return True

    @property
    def is_active(self) -> bool:
        return bool(torch.any(self.angle != 0))

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        R_enter = self._edge_map(self.e1, self.fringe_integral)
        R_exit = self._edge_map(self.e2, self.fringe_integral_exit)
        # A zero-length entry takes the thin-kick map, chosen per entry so
        # that mixed batches work; the tilt comes after the edge maps.
        body = base_rmatrix(
            length=torch.where(self.length == 0, 1.0, self.length),
            k1=torch.zeros_like(self.length),
            hx=self.hx,
            tilt=torch.zeros_like(self.length),
            energy=energy,
        )
        batch_shape = body.shape[:-2]
        thin = build_rmatrix(
            {(0, 1): self.length, (2, 6): self.angle, (2, 3): self.length},
            batch_shape, body.dtype, body.device,
        )
        zero_length = torch.broadcast_to(self.length == 0, batch_shape)
        R = torch.where(zero_length[..., None, None], thin, body)
        R = sandwich(R_exit, R, R_enter)
        return sandwich(rotation_matrix(-self.tilt), R, rotation_matrix(self.tilt))

    def _edge_map(self, e: torch.Tensor, fringe_integral: torch.Tensor) -> torch.Tensor:
        """Thin-wedge fringe map."""
        hx = self.hx
        sec_e = 1.0 / torch.cos(e)
        phi = fringe_integral * hx * self.gap * sec_e * (1 + torch.sin(e) ** 2)
        batch_shape = torch.broadcast_shapes(phi.shape, self.length.shape)
        return build_rmatrix(
            {(1, 0): hx * torch.tan(e), (3, 2): -hx * torch.tan(e - phi)},
            batch_shape, self.length.dtype, self.length.device,
        )

    def broadcast(self, shape: tuple) -> Element:
        new = Dipole(
            length=torch.broadcast_to(self.length, shape).clone(),
            **{f: torch.broadcast_to(getattr(self, f), shape).clone() for f in _FIELDS},
            name=self.name, dtype=self.length.dtype, device=self.length.device,
        )
        new.__class__ = self.__class__  # an RBend's faces are already shifted
        return new

    def split(self, resolution: float) -> list:
        """Sector-bend slices, the edge fringe maps kept only at the true
        entrance and exit (the JAX package's split)."""
        total = float(torch.max(self.length))
        if total <= 1e-6:  # a zero-length thin kick cannot be split
            return [self]
        pieces = []
        remaining = total
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            pieces.append(piece)
            remaining -= piece
        zero = torch.zeros_like(self.angle)
        last = len(pieces) - 1
        return [
            Dipole(
                length=torch.full_like(self.length, piece),
                angle=self.angle * (piece / total),
                e1=self.e1 if i == 0 else zero,
                e2=self.e2 if i == last else zero,
                tilt=self.tilt,
                fringe_integral=self.fringe_integral if i == 0 else zero,
                fringe_integral_exit=self.fringe_integral_exit if i == last else zero,
                gap=self.gap,
            )
            for i, piece in enumerate(pieces)
        ]

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["length", *_FIELDS]


class RBend(Dipole):
    """Rectangular bend: a Dipole with e1 and e2 shifted by angle / 2."""

    def __init__(self, length, angle=None, e1=None, e2=None, tilt=None, fringe_integral=None,
                 fringe_integral_exit=None, gap=None, name: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__(
            length=length, angle=angle, e1=e1, e2=e2, tilt=tilt,
            fringe_integral=fringe_integral, fringe_integral_exit=fringe_integral_exit,
            gap=gap, name=name, dtype=dtype, device=device,
        )
        self.e1 = self.e1 + self.angle / 2
        self.e2 = self.e2 + self.angle / 2
