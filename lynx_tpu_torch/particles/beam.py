"""Beam base class (counterpart of ``lynx_tpu.particles.beam``).

Beams are plain classes that hold tensors.  ``Beam.empty`` is the sentinel
for a beam that is entirely lost or absorbed; elements pass it through.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


class Beam:
    #: Sentinel returned when a beam is entirely lost or absorbed.
    empty = "I'm an empty beam!"

    def broadcast(self, shape: tuple) -> "Beam":
        raise NotImplementedError


def _common_shape(args: Sequence, default: Tuple[int, ...] = (1,)) -> Tuple[int, ...]:
    shapes = [torch.as_tensor(a).shape for a in args if a is not None]
    return tuple(torch.broadcast_shapes(*shapes)) if shapes else default


def _resolve(value, default, shape, dtype, device) -> torch.Tensor:
    out = torch.as_tensor(default if value is None else value, dtype=dtype, device=device)
    return torch.broadcast_to(out, shape)
