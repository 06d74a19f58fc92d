"""Per-step beam-statistics metrics (counterpart of ``lynx_tpu.metrics``).

Scalar beam statistics are emitted as one structured ``key=value`` line
through the ``lynx_tpu_torch.metrics`` logger, from host code or from a
training or env step::

    from lynx_tpu_torch.metrics import beam_stats, log_metrics
    log_metrics(step=i, **beam_stats(outgoing))

    emit_metrics({"reward": reward.mean(), ...}, step=state.step_count)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lynx_tpu_torch.log import get_logger

logger = get_logger("metrics")


def beam_stats(beam) -> Dict[str, torch.Tensor]:
    """Scalar summary statistics of a beam (means over any batch dims)."""
    return {
        "mu_x": torch.mean(beam.mu_x),
        "sigma_x": torch.mean(beam.sigma_x),
        "mu_y": torch.mean(beam.mu_y),
        "sigma_y": torch.mean(beam.sigma_y),
        "energy": torch.mean(beam.energy),
    }


def format_metrics(metrics: Dict[str, float], step: Optional[int] = None) -> str:
    """One structured ``key=value`` line, keys in sorted order."""
    parts = [] if step is None else [f"step={int(step)}"]
    parts += [f"{k}={float(v):.6g}" for k, v in sorted(metrics.items())]
    return " ".join(parts)


def log_metrics(step: Optional[int] = None, **metrics) -> None:
    """Host-side structured metrics emission through the package logger."""
    logger.info(format_metrics(metrics, step))


def emit_metrics(metrics: Dict[str, torch.Tensor], step=None) -> None:
    """Log ``metrics`` (scalar tensors) with ``step`` (a number, or a
    tensor whose first element is the step) as one line.

    The scalars, and a tensor step, are stacked into one float64 tensor and
    copied to the host once, so a call costs one device sync.  It is
    synchronous: the JAX package's ``jax.debug.callback`` logs
    asynchronously, once the values are computed.
    """
    keys = list(metrics)
    values = [torch.as_tensor(metrics[k]).reshape(()).to(torch.float64) for k in keys]
    step_is_tensor = isinstance(step, torch.Tensor)
    if step_is_tensor:
        values.append(step.reshape(-1)[0].to(torch.float64))
    host = torch.stack(values).cpu().tolist() if values else []
    if step_is_tensor:
        step = int(host.pop())
    logger.info(format_metrics(dict(zip(keys, host)), step))
