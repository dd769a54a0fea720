"""Recompute chunks of the kernels' backwards per call, over every kernel
wrapper (``ops.cuda._autograd.vjp_counts``, exact); None where the program
has no such counter."""


def read(ctx):
    counts = getattr(ctx, "vjp_counts", None)
    if not counts or ctx.calls <= 0:
        return None
    return sum(c["chunks"] for c in counts.values()) / ctx.calls
