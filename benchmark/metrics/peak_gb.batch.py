"""Device memory the window's calls took above the resident image set, in GB."""
from fvbench import readers


def read(ctx):
    return readers.peak_gb(ctx)
