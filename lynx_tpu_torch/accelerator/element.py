"""Element base class and the generic linear tracking rule (counterpart of
``lynx_tpu._module`` and ``lynx_tpu.accelerator.element``).

Elements are ``nn.Module``s whose array fields are registered buffers, so
``.to(device)`` / ``.to(torch.float64)`` move or cast a whole lattice and a
field stays reassignable (``segment.AREAMQZM1.k1 = t``).  A map is a pure
function of the buffers, so autograd flows through it.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional

import torch
from torch import nn

from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam
from lynx_tpu_torch.utils import UniqueNameGenerator, resolve_device

generate_unique_name = UniqueNameGenerator(prefix="unnamed_element")

#: Defining features whose value lives under another attribute name.
_FEATURE_ATTRS = {"transfer_map": "_transfer_map"}


def as_field(value, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """A tensor for an element field (lists, numbers and numpy arrays too)."""
    return torch.as_tensor(value, dtype=dtype, device=device)


def apply_transfer_map(tm: torch.Tensor, beam: Beam) -> Beam:
    """Propagate a beam through a ``(..., 7, 7)`` linear map.

    * ``ParameterBeam``: mu' = R mu ; cov' = R cov R^T
    * ``ParticleBeam``:  P' = P R^T

    ``torch.matmul`` refuses mixed dtypes where JAX promotes, so both
    operands are promoted explicitly, as JAX would.
    """
    if beam is Beam.empty:
        return beam
    if isinstance(beam, ParameterBeam):
        dtype = torch.promote_types(tm.dtype, beam._mu.dtype)
        tm = tm.to(dtype)
        mu = torch.matmul(tm, beam._mu.to(dtype)[..., None])[..., 0]
        cov = torch.matmul(tm, torch.matmul(beam._cov.to(dtype), tm.transpose(-2, -1)))
        return ParameterBeam(mu, cov, beam.energy, total_charge=beam.total_charge)
    if isinstance(beam, ParticleBeam):
        dtype = torch.promote_types(tm.dtype, beam.particles.dtype)
        particles = torch.matmul(
            beam.particles.to(dtype), tm.to(dtype).transpose(-2, -1)
        )
        return ParticleBeam(
            particles,
            beam.energy,
            particle_charges=beam.particle_charges,
            survival=beam.survival,
        )
    raise TypeError(f"Parameter incoming is of invalid type {type(beam)}")


def promoted_dtype(*tensors: torch.Tensor) -> torch.dtype:
    return reduce(torch.promote_types, (t.dtype for t in tensors))


class Element(nn.Module):
    """Base class for accelerator lattice elements.

    :param name: Unique identifier of the element.
    :param length: Length in meters.
    :param device: Where the fields live: ``device`` if given, else the
        device of a tensor argument, else the card (``cuda``).
    """

    def __init__(
        self,
        name: Optional[str] = None,
        length=None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        super().__init__()
        device = resolve_device(device, length)
        self.name = name if name is not None else generate_unique_name()
        self.register_buffer(
            "length", as_field(length if length is not None else [0.0], dtype, device)
        )

    def __setattr__(self, name: str, value) -> None:
        # A number or list assigned to a buffer field becomes a tensor of the
        # field's dtype and device (nn.Module would refuse it).
        buffers = self.__dict__.get("_buffers")
        if (
            buffers is not None
            and name in buffers
            and value is not None
            and not isinstance(value, torch.Tensor)
        ):
            old = buffers[name]
            value = as_field(value, old.dtype, old.device)
        super().__setattr__(name, value)

    @classmethod
    def from_fields(cls, name: str, data: dict, static: dict) -> "Element":
        """Build an element straight from its data fields (tensors, which
        become buffers) and static fields, bypassing ``__init__`` the way
        the JAX package rebuilds a pytree."""
        element = cls.__new__(cls)
        nn.Module.__init__(element)
        element.name = name
        for field, value in data.items():
            element.register_buffer(field, value)
        for field, value in static.items():
            setattr(element, field, value)
        return element

    def replace(self, **updates) -> "Element":
        """Functional update: a new element with the named fields replaced
        and every other buffer and attribute shared (no copy).  A buffer
        takes any tensor, so a replaced field may carry a batch the others
        do not; a number or list becomes a tensor of the field's type."""
        cls = type(self)
        buffers = self.__dict__["_buffers"]
        unknown = sorted(
            name for name in updates
            if name not in buffers and not hasattr(self, name)
        )
        if unknown:
            raise ValueError(f"Unknown fields for {cls.__name__}: {unknown}")
        new = cls.__new__(cls)
        new.__dict__.update(self.__dict__)
        for name in ("_parameters", "_buffers", "_modules"):
            new.__dict__[name] = type(self.__dict__[name])(self.__dict__[name])
        for name, value in updates.items():
            if name in buffers:
                if not isinstance(value, torch.Tensor):
                    old = buffers[name]
                    value = as_field(value, old.dtype, old.device)
                new._buffers[name] = value
            else:
                setattr(new, name, value)
        return new

    # -- physics -----------------------------------------------------------
    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        r"""The element's ``(..., 7, 7)`` map over trace space
        ``(x, x', y, y', s, p, 1)``."""
        raise NotImplementedError

    def track(self, incoming: Beam) -> Beam:
        """Track a beam through the element (generic linear rule)."""
        if incoming is Beam.empty:
            return incoming
        return apply_transfer_map(self.transfer_map(incoming.energy), incoming)

    def forward(self, incoming: Beam) -> Beam:
        return self.track(incoming)

    # -- structure ---------------------------------------------------------
    def broadcast(self, shape: tuple) -> "Element":
        """Broadcast the element's parameters to higher batch dimensions."""
        raise NotImplementedError

    @property
    def is_skippable(self) -> bool:
        """Whether the element is purely linear, so that its map can be
        fused with its neighbours' during tracking."""
        raise NotImplementedError

    def split(self, resolution: float) -> list:
        """Split into slices no longer than ``resolution`` meters."""
        raise NotImplementedError

    # -- equality ------------------------------------------------------------
    @property
    def defining_features(self) -> list:
        """Names of the features that define the element (for equality)."""
        return []

    def feature(self, name: str):
        """The value of a defining feature (``transfer_map`` is a
        CustomTransferMap's map, not its method)."""
        return getattr(self, _FEATURE_ATTRS.get(name, name))

    def __eq__(self, other) -> bool:
        """Equal type and equal defining features, tensors by shape and
        value (the JAX package's rule); names are not compared."""
        if type(self) is not type(other):
            return NotImplemented
        for name in self.defining_features:
            a, b = self.feature(name), other.feature(name)
            if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
                a, b = torch.as_tensor(a), torch.as_tensor(b)
                if a.shape != b.shape or not bool(torch.all(a == b.to(a.device))):
                    return False
            elif a != b:
                return False
        return True

    def __hash__(self) -> int:
        # By identity, as in the JAX package: nn.Module's bookkeeping keeps
        # modules in sets and dicts.
        return id(self)

    def extra_repr(self) -> str:
        return f"name={self.name!r}"
