"""Host milliseconds a call in the program's ``graphs.replay`` spans (the copy
into the static inputs, ``graph.replay()``, the metric records queued, the
outputs cloned), their self time, the mean over the instrumented window
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    phase = spans.phase(ctx)
    return None if phase is None else phase.metrics().get("launch_ms")
