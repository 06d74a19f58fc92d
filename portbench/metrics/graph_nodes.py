"""Kernel nodes of the CUDA graph one call replays (the program's
``graphs.graph_kernel_count`` of its DOT dump): a count that repeats
exactly."""


def read(ctx):
    return ctx.graph_nodes()
