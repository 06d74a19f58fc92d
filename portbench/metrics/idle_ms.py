"""Device milliseconds a call idle between consecutive replays, from one
replay's last stamp to the next one's first, on the host's clock; the mean
over the instrumented window (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    phase = spans.phase(ctx)
    return None if phase is None else phase.metrics().get("idle_ms")
