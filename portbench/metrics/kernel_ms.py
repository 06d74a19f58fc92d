"""Device milliseconds a call in the program's ``kernel.*`` spans (B1-B6's
launches, B1's zeroed image with them), from the stamps inside the replays;
the mean over the instrumented window (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    phase = spans.phase(ctx)
    return None if phase is None else phase.metrics().get("kernel_ms")
