"""The port's kernels' share of their byte roofline, each of the four processes
scoring its share of the set (the mean of their kernel times)."""
from fvbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
