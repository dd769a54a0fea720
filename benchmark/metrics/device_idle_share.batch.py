"""The card's idle share of a traced image-set window."""
from fvbench import readers


def read(ctx):
    return readers.mean_idle_share(ctx)
