"""The packed Gram's share of its roofline: the least time of the Gram's
work a call (the loop's ``gram_work()``: the cloud read once, and one Gram
of it a step, 36 multiply-adds a particle, since no aperture makes a
setting's Gram differ; counted at the H100's dense bf16 tensor-core rate of
989 TFLOP/s, passed scaled by 67/989 because ``roofline.least_seconds``
divides by the float32 rate) over the device time a call of the program's
``kernel.*`` spans (``kernel_ms``: in this cell B6's alone), in percent.
It counts the same work whatever implements the Gram; nothing where the
program has no kernel span."""

from portbench import harness, roofline


def read(ctx):
    kernel_ms = harness.reader(ctx.loop.cell.root, "kernel_ms")(ctx)
    if not kernel_ms:
        return None
    return 100.0 * roofline.least_seconds(*ctx.loop.gram_work()) / (kernel_ms / 1e3)
