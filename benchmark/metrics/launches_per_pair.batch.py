"""The port's kernel launches per scored pair (launch_counts)."""
from fvbench import readers


def read(ctx):
    return readers.launches_per(ctx, ctx.pairs)
