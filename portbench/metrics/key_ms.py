"""Host milliseconds a call in the program's ``graphs.key`` spans (flattening
the arguments into leaves and a structure key, and the cache lookup), their
self time, the mean over the instrumented window (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    phase = spans.phase(ctx)
    return None if phase is None else phase.metrics().get("key_ms")
