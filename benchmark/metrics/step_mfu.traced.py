"""The whole training step's share of the card's peak: the least time the
forward and the backward of the window's calls could take at the card's
memory bandwidth (``roofline_vjp``), over the traced window's wall time.
The calls are the program's own ``fvvdp.predict_traced`` entry spans that
began in the window; None where the program marks none."""
from fvbench import readers, roofline_vjp


def read(ctx):
    procs = readers.on_device(ctx)
    spans = getattr(ctx, "spans", None)
    if not procs or not spans or ctx.work is None:
        return None
    entry = spans[0]["spans"].get("fvvdp.predict_traced")
    if entry is None or entry["count"] == 0:
        return None
    return 100.0 * roofline_vjp.least_seconds(ctx.work, entry["count"]) / procs[0].window_s
