"""The whole call's share of the card's peak in a image-set window: the least
time the traffic's ``step`` stages could take at the card's memory
bandwidth, over the window's wall time."""
from fvbench import readers


def read(ctx):
    return readers.step_share(ctx)
