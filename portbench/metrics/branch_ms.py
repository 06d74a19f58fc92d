"""Device milliseconds a call in the program's ``track.branch.<screen>``
spans: each screen's tail of a several-screen reconstruction, from the
point where the measurements' lines part to the screen, with its children
(the tail's plan and its push of the particles; the screen's read is
outside it), from the stamps inside the replays; the mean over the
instrumented window (``portbench/spans.py``).  Nothing where the program
has no such spans."""

from portbench import spans

PREFIX = "track.branch."


def read(ctx):
    phase = spans.phase(ctx)
    if phase is None or not phase.replays():
        return None
    found = [d.end - d.start for d in phase.device if d.name.startswith(PREFIX)]
    return sum(found) / 1e6 / phase.replays() if found else None
