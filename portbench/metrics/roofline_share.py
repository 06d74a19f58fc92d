"""The least time a call's work needs on the card (``portbench/roofline.py``:
the configuration's bytes over the H100's bandwidth or its operations over
its float32 rate, the larger) over the device's busy time a call in the
traced window, in percent.  Whatever kernels do the work, it counts the
same work."""

from portbench import roofline


def read(ctx):
    work = ctx.work()
    if work is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(*work) / (ctx.trace.busy_s / ctx.calls)
