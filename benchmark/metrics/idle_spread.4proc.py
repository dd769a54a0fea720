"""The highest minus the lowest of the cards' idle shares."""
from fvbench import readers


def read(ctx):
    shares = readers.idle_shares(ctx)
    return max(shares) - min(shares) if len(shares) > 1 else None
