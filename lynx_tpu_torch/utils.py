"""Small utilities (counterpart of ``lynx_tpu.utils``)."""

from __future__ import annotations

import torch


def resolve_device(device=None, *values) -> torch.device:
    """The device an entry point builds on: ``device`` if given, else that
    of the first tensor among ``values`` (a constructor's arguments), else
    the card, ``cuda``.  It neither probes nor falls back: without CUDA,
    building a tensor on the result raises torch's own error, so CPU callers
    pass ``device="cpu"`` or CPU tensors."""
    if device is not None:
        return torch.device(device)
    for value in values:
        if isinstance(value, torch.Tensor):
            return value.device
    return torch.device("cuda")


class UniqueNameGenerator:
    """Generates a unique name given a prefix."""

    def __init__(self, prefix: str):
        self._prefix = prefix
        self._counter = 0

    def __call__(self) -> str:
        name = f"{self._prefix}_{self._counter}"
        self._counter += 1
        return name
