"""Device milliseconds a call of every traced device operation that is not
one of the port's own kernels B1-B7 (PyTorch's kernels, copies and memsets):
the map building, the plan's algebra and the PyTorch work around the
kernels."""

#: Name fragments of the port's kernels (``lynx_tpu_torch/csrc``): B1's read
#: and count core, B2, B3, B4, B5, B6 with its reduction, B7.
PORT_KERNELS = ("windowed_read_", "window_histogram_kernel", "particle_apply_kernel",
                "moment_sweep_kernel", "moment_sweep_bwd_kernel", "moment_walk_kernel",
                "packed_gram_kernel", "reduce_partials_kernel", "onehot_", "twolevel_kernel")


def read(ctx):
    seconds = sum(s for name, s in ctx.trace.device_ops
                  if not any(k in name for k in PORT_KERNELS))
    return 1e3 * seconds / ctx.calls
