"""The whole call's share of the card's peak in the four-process window: the
least time of the traffic's ``step`` stages for one process's pairs at the
card's memory bandwidth, over the mean traced window."""
from fvbench import readers


def read(ctx):
    return readers.step_share(ctx)
