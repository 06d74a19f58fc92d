"""Per-step beam-statistics metrics (counterpart of ``lynx_tpu.metrics``).

Scalar beam statistics are emitted as one structured ``key=value`` line
through the ``lynx_tpu_torch.metrics`` logger, from host code or from a
training or env step::

    from lynx_tpu_torch.metrics import beam_stats, log_metrics
    log_metrics(step=i, **beam_stats(outgoing))

    emit_metrics({"reward": reward.mean(), ...}, step=state.step_count)
"""

from __future__ import annotations

import atexit
import collections
import contextlib
from typing import Dict, List, Optional

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

    The scalars, and a tensor step, are stacked into one float64 record.
    Eagerly the record is copied to the host at once (one device sync).
    Inside a graphed function (``graphs.capturing()``), the counterpart of
    JAX's ``jax.debug.callback``: the record is a tensor the capture owns,
    which each replay rewrites, and the host logs it after the replay, in
    emission order, asynchronously to the computation (:func:`flush` waits
    for the lines still pending, as ``jax.effects_barrier``; it runs at
    exit and in ``graphs.release()``, so that no replay's line is lost, as
    JAX waits on its callbacks' effects at exit).  On the CPU
    the graph form logs the records when the function returns.  A graph's
    warm-ups run the function eagerly on the card and log nothing: a call
    logs once, as a JAX execution does.
    """
    from lynx_tpu_torch import graphs

    keys = list(metrics)
    values = [torch.as_tensor(metrics[k]).reshape(()).to(torch.float64) for k in keys]
    step_is_tensor = isinstance(step, torch.Tensor)
    if step_is_tensor:
        values.append(step.reshape(-1)[0].to(torch.float64))
    record = torch.stack(values) if values else None
    step = _TENSOR_STEP if step_is_tensor else step
    if _RECORDING:  # a capture, or a graph-form run on the CPU
        _RECORDING[-1].append((keys, step, record))
        return
    if graphs.capturing() and record is not None and record.is_cuda:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("emit_metrics: captured outside graphs' capture of a step or"
                               " function, which would never log the record")
        return  # a warm-up
    _log_record(keys, step, record.cpu().tolist() if record is not None else [])


#: Marks a record whose last value is its step.
_TENSOR_STEP = object()
#: The record lists of the captures (or CPU graph-form runs) in progress.
_RECORDING: List[list] = []
#: Records copied to the host after a replay and not yet logged:
#: ``(keys, step, host values, event)``, in emission order.
_PENDING: collections.deque = collections.deque()


def _log_record(keys, step, host) -> None:
    if step is _TENSOR_STEP:
        step = int(host.pop())
    logger.info(format_metrics(dict(zip(keys, host)), step))


@contextlib.contextmanager
def recording():
    """Collect the records that :func:`emit_metrics` makes inside the block
    (a capture, or a graph-form run on the CPU) into the list it yields;
    the warm-ups' records on the card are dropped (see emit_metrics)."""
    records: list = []
    _RECORDING.append(records)
    try:
        yield records
    finally:
        _RECORDING.pop()


def log_records(records) -> None:
    """Log a CPU graph-form run's records now, in emission order."""
    for keys, step, record in records:
        _log_record(keys, step, record.tolist() if record is not None else [])


def enqueue(records) -> None:
    """After a replay: copy each of the graph's records to pinned host
    memory on the current stream (no sync) and queue it for logging; lines
    whose copies have already arrived are logged first."""
    flush(wait=False)
    for keys, step, record in records:
        host, event = None, None  # a record of no values is logged in its turn
        if record is not None:
            host = torch.empty(record.shape, dtype=record.dtype, pin_memory=True)
            host.copy_(record, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        _PENDING.append((keys, step, host, event))


def flush(wait: bool = True) -> None:
    """Log the replayed records whose values have reached the host, in
    emission order; with ``wait``, wait for all of them (the counterpart of
    ``jax.effects_barrier``)."""
    while _PENDING:
        keys, step, host, event = _PENDING[0]
        if event is not None:
            if wait:
                event.synchronize()
            elif not event.query():
                return
        _PENDING.popleft()
        _log_record(keys, step, [] if host is None else host.tolist())


atexit.register(flush)
