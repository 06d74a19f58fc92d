"""Logging (counterpart of ``lynx_tpu.log``).

Everything the port reports goes through a standard :mod:`logging` logger
under the ``lynx_tpu_torch`` namespace (converter warnings, for example),
so applications and tests can route, filter and capture it.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger("lynx_tpu_torch")


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """The package logger, or a child of it (``get_logger("converters.bmad")``)."""
    return logger if name is None else logger.getChild(name)
