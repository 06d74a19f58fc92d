"""Small utilities (counterpart of ``lynx_tpu.utils``)."""

from __future__ import annotations


class UniqueNameGenerator:
    """Generates a unique name given a prefix."""

    def __init__(self, prefix: str):
        self._prefix = prefix
        self._counter = 0

    def __call__(self) -> str:
        name = f"{self._prefix}_{self._counter}"
        self._counter += 1
        return name
