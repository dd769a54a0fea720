"""The port's kernels' share of their byte roofline in a clip window."""
from fvbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
