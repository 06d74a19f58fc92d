"""Seeding (counterpart of ``lynx_tpu.random``).

The port keeps no key of its own: every sampling entry point takes a
``generator=`` (a ``torch.Generator``) where the JAX package takes
``key=``, and one that is passed always wins.  Without one, torch's
default generator of the tensor's device draws, and :func:`seed` seeds the
default generators of every device (``torch.manual_seed``).

JAX and torch draw different numbers from the same seed: a beam sampled
with ``seed(0)`` here has the same distribution as the JAX package's, not
the same particles.
"""

from __future__ import annotations

import torch


def seed(value: int) -> None:
    """Seed torch's default generators (CPU and every CUDA device)."""
    torch.manual_seed(value)
