"""Device ms per frame of the kernels and copies launched inside the
program's ``fvvdp.vjp`` spans: the backwards of the kernels' autograd
Functions, each its plain version's VJP recomputed in chunks of frames."""
from fvbench import span_context


def read(ctx):
    return span_context.span_device_ms(ctx, "fvvdp.vjp", ctx.frames)
