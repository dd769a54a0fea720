"""The mean of the four cards' idle shares, each process tracing its own card."""
from fvbench import readers


def read(ctx):
    return readers.mean_idle_share(ctx)
