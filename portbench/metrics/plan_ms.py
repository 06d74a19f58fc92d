"""Device milliseconds a call in the program's ``track.plan`` stage (a run of
linear elements flushed: the maps' builders and the plan's algebra), from the
stamps inside the replays, its kernels' spans excluded; the mean over the
instrumented window (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    phase = spans.phase(ctx)
    return None if phase is None else phase.metrics().get("plan_ms")
