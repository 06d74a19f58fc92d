"""Device milliseconds a call in the program's KDE: its ``kernel.kde`` span
(the forward's particle blocks) and its ``kernel.kde_bwd`` span (the
backward's), from the stamps inside the replays; the mean over the
instrumented window (``portbench/spans.py``).  Nothing where the program
has no such spans."""

from portbench import spans

KDE_SPANS = ("kernel.kde", "kernel.kde_bwd")


def read(ctx):
    phase = spans.phase(ctx)
    if phase is None or not phase.replays():
        return None
    found = [d.end - d.start for d in phase.device if d.name in KDE_SPANS]
    return sum(found) / 1e6 / phase.replays() if found else None
