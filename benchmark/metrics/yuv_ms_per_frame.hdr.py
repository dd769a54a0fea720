"""Device ms per scored frame launched inside the program's ``fvvdp.yuv``
spans: the raw Y'CbCr frames' conversion to luminance."""
from fvbench import span_context


def read(ctx):
    return span_context.span_device_ms(ctx, "fvvdp.yuv", ctx.frames)
