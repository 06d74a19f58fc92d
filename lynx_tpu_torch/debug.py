"""Debugging and validation (counterpart of ``lynx_tpu.debug``): NaN
provenance and physical-consistency checks on beams."""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam

#: Ops whose outputs are uninitialised memory, which may hold NaN bits.
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                            "new_empty_strided", "empty_permuted"})


class _NanCheck(TorchDispatchMode):
    """Raise at the first op whose floating-point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # A view shows what is already there, and an allocation holds
        # whatever the memory held: neither produces a value.
        if func.is_view or func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for tensor in (out if isinstance(out, (list, tuple)) else (out,)):
            if (isinstance(tensor, torch.Tensor) and tensor.is_floating_point()
                    and bool(torch.isnan(tensor).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextmanager
def nan_debug():
    """Raise ``FloatingPointError`` at the first torch op inside the block
    whose floating output holds a NaN (a ``TorchDispatchMode``, one host
    sync per op), and turn on autograd's anomaly mode with its NaN check, so
    that a backward function returning a NaN raises too.  The previous
    anomaly state is restored on exit.

    The mode sees torch ops only: a kernel launched through ``ctypes``
    (``csrc/*.cu``) writes its outputs unseen, so a NaN that a kernel
    produces is caught at the first torch op that consumes it.
    """
    previous = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        with _NanCheck():
            yield
    finally:
        torch.autograd.set_detect_anomaly(*previous)


def validate_beam(beam: Beam, *, name: str = "beam") -> None:
    """Raise ``ValueError`` on non-finite or unphysical beam state.

    Checks: finite moments/particles, non-negative energy, non-negative
    covariance diagonal (ParameterBeam), survival weights in [0, 1]
    (ParticleBeam).
    """
    if beam is Beam.empty:
        return
    problems = []

    def check(condition, message: str) -> None:
        if not bool(condition):
            problems.append(message)

    energy = torch.as_tensor(beam.energy)
    check(torch.isfinite(energy).all(), "non-finite energy")
    check((energy >= 0).all(), "negative energy")

    if isinstance(beam, ParameterBeam):
        check(torch.isfinite(beam._mu).all(), "non-finite mu")
        check(torch.isfinite(beam._cov).all(), "non-finite cov")
        diag = torch.diagonal(beam._cov, dim1=-2, dim2=-1)
        check((diag >= -1e-12).all(), "negative covariance diagonal")
    elif isinstance(beam, ParticleBeam):
        check(torch.isfinite(beam.particles).all(), "non-finite particles")
        if beam.survival is not None:
            check(((beam.survival >= 0) & (beam.survival <= 1)).all(),
                  "survival weights outside [0, 1]")

    if problems:
        raise ValueError(f"Invalid {name}: " + "; ".join(problems))
