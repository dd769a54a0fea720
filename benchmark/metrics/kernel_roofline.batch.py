"""The port's kernels' share of their byte roofline in an image-set window."""
from fvbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
