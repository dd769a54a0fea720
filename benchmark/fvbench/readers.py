"""What the per-layer readers (``metrics/*.py``) share.

A reader gets a :class:`Context` and returns a number, or None where it
finds nothing to read; the harness then leaves the metric out.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from fvbench import roofline


class Context:
    """One run's readings for the per-layer readers.

    ``summaries``: the trace summary of each process (``trace.Summary``);
    ``work``: the shapes of one call (``roofline``'s work description);
    ``calls``: the calls of the traced window (of each process, where
    several make the same calls); ``frames``, ``pairs``: what it scored; ``launches``: the port's kernel launches in
    the window (``ops.cuda._lib.launch_counts``); ``peak_bytes``: the
    window's device memory peak above what was allocated when it opened;
    ``stages``: the stage table; ``step``: the roofline's stages that one
    whole call needs (the traffic's ``step``)."""

    def __init__(self, summaries: List, stages: Dict[str, Dict], work: Optional[Dict] = None,
                 calls: int = 0, frames: int = 0, pairs: int = 0,
                 launches: Optional[Dict[str, int]] = None, peak_bytes: Optional[int] = None,
                 step: Optional[List[str]] = None):
        self.summaries = [s for s in summaries if s is not None]
        self.stages = stages
        self.work = work
        self.calls = calls
        self.frames = frames
        self.pairs = pairs
        self.launches = launches
        self.peak_bytes = peak_bytes
        self.step = step


def on_device(ctx: Context) -> List:
    """The summaries of the processes whose trace holds device work (none
    on the CPU, where no device reading is made)."""
    return [s for s in ctx.summaries if s.busy_s > 0 and s.window_s > 0]


def idle_shares(ctx: Context) -> List[float]:
    """Per process: 1 - the device's busy share of the traced window, in %."""
    return [100.0 * (1.0 - s.busy_s / s.window_s) for s in on_device(ctx)]


def mean_idle_share(ctx: Context) -> Optional[float]:
    v = idle_shares(ctx)
    return sum(v) / len(v) if v else None


def port_symbols(ctx: Context) -> set:
    return {sym for st in ctx.stages.values() for sym in st["symbols"]}


def kernel_roofline(ctx: Context) -> Optional[float]:
    """The least time the work of the stages that ran could take at the
    card's memory bandwidth, over the device time of the port's kernels,
    in %.  None when no kernel of the port ran."""
    procs = on_device(ctx)
    if not procs or ctx.work is None:
        return None
    ran = {sym for s in procs for sym, t in s.device_s_by_symbol.items() if t > 0}
    # each process does the same work: its mean time is the denominator
    port_s = sum(s.device_s_by_symbol.get(sym, 0.0) for s in procs
                 for sym in port_symbols(ctx)) / len(procs)
    work = [w for st in ctx.stages.values() if ran & set(st["symbols"]) for w in st["work"]]
    if port_s <= 0 or not work:
        return None
    return 100.0 * roofline.least_seconds(work, ctx.work, ctx.calls) / port_s


def step_share(ctx: Context) -> Optional[float]:
    """The least time the whole calls' work (the ``step`` stages) could take
    at the card's memory bandwidth, over the traced window's wall time, in
    %."""
    procs = on_device(ctx)
    if not procs or ctx.work is None or not ctx.step or ctx.calls <= 0:
        return None
    window_s = sum(s.window_s for s in procs) / len(procs)
    return 100.0 * roofline.least_seconds(ctx.step, ctx.work, ctx.calls) / window_s


def other_device_ms(ctx: Context, per: int) -> Optional[float]:
    """Device time of everything the stage table does not name as the
    port's (ATen kernels, copies), in ms per frame or pair scored."""
    if not on_device(ctx) or per <= 0:
        return None
    ours = port_symbols(ctx)
    s = on_device(ctx)[0]
    return 1e3 * sum(t for sym, t in s.device_s_by_symbol.items() if sym not in ours) / per


def launches_per(ctx: Context, per: int) -> Optional[float]:
    if ctx.launches is None or per <= 0:
        return None
    return sum(ctx.launches.values()) / per


def peak_gb(ctx: Context) -> Optional[float]:
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 1e9
