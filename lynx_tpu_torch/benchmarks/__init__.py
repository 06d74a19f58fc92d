"""A/B harnesses of the port's kernels, run on the card."""
