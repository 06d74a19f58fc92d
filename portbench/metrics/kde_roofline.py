"""The KDE's share of its roofline: the least time of the call's work
(``ctx.work()``: the KDE's three products, 2 N H W operations a setting
each, at the H100's float32 rate outside the tensor cores, or its bytes at
the memory's bandwidth, the larger; ``portbench/roofline.py``) over the
KDE's device time a call (``kde_ms``), in percent.  It counts the same work
whatever implements the KDE."""

from portbench import harness, roofline


def read(ctx):
    work = ctx.work()
    kde_ms = harness.reader(ctx.loop.cell.root, "kde_ms")(ctx)
    if work is None or not kde_ms:
        return None
    return 100.0 * roofline.least_seconds(*work) / (kde_ms / 1e3)
