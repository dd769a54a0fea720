"""Device ms per scored pair of everything but the port's kernels."""
from fvbench import readers


def read(ctx):
    return readers.other_device_ms(ctx, ctx.pairs)
