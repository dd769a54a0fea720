"""The program's spans for the per-layer readers.

A driver that reduces its traced window with ``spans.reduce`` hands the
reduction to its readers on a :class:`SpanContext`; a reader of a span
metric finds None where the program marked no such span (a program that
lacks it, or a run on the CPU).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from fvbench import readers


class SpanContext(readers.Context):
    """A ``readers.Context`` that also holds ``spans``: the
    ``spans.reduce`` of each process's traced window."""

    def __init__(self, *args, spans: Optional[List[Dict]] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.spans = [s for s in (spans or []) if s is not None]


def span_device_ms(ctx: readers.Context, name: str, per: int) -> Optional[float]:
    """Device ms of the kernels and copies launched inside the span
    ``name`` (the innermost span of their launch), per ``per`` frames or
    pairs scored, in the first process; None where no such span began in
    the window or the window ran no device work."""
    spans = getattr(ctx, "spans", None)
    if not spans or per <= 0 or not readers.on_device(ctx):
        return None
    st = spans[0]["spans"].get(name)
    if st is None or st["count"] == 0:
        return None
    return 1e3 * st["device_s"] / per
