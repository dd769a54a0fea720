"""The card's idle share of a traced clip window: 1 - the union of its
kernels and copies over the window."""
from fvbench import readers


def read(ctx):
    return readers.mean_idle_share(ctx)
