"""The device trace of a measured window: ``torch.profiler`` (CUPTI)
around the window, reduced to device intervals, kernel times by name, the
device's busy time and the longest idle gaps named by what the host was
doing meanwhile.

The window is marked by a span of the harness's own (``WINDOW``); device
activity is clipped to it.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW = "fvbench.window"
CALL = "fvbench.call"


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    on_device: bool


def events(prof) -> List[Event]:
    """Every host event and every device operation (kernels, copies,
    fills) of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).split(".")[-1].upper() == "CUDA"
        # a span's shadow on the device's timeline is no device work
        if dev and (e.is_user_annotation() or e.name().startswith("fvbench.")):
            continue
        out.append(Event(e.name(), int(e.start_ns()), int(e.end_ns()), dev))
    return out


def short_name(name: str) -> str:
    """A device event's name without namespaces of no name, return type,
    template and argument lists: "void at::native::vectorized_elementwise_
    kernel<4, ...>(int, ...)" -> "at::native::vectorized_elementwise_kernel",
    "(anonymous namespace)::reduce_kernel(float const*, ...)" ->
    "reduce_kernel"."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    cut = min([i for i in (s.find("<"), s.find("(")) if i > 0] or [len(s)])
    return s[:cut].strip()


def kernel_symbol(name: str) -> str:
    """The function's own identifier: "fvvdp::sum_partials_kernel" ->
    "sum_partials_kernel"."""
    return short_name(name).split("::")[-1]


def union_ns(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of intervals, and the union itself."""
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


class Summary(NamedTuple):
    """What the readers read of one traced window."""
    window_s: float                  # the marked window on the host's clock
    busy_s: float                    # union of device activity within it
    device_s_by_symbol: Dict[str, float]   # summed device time per kernel symbol
    device_ops: List[Tuple[str, float]]    # the top device operations
    idle_gaps: List[Tuple[str, float]]     # the longest idle gaps, by host activity
    calls: int                       # calls that began inside the window


def summarise(evs: List[Event], top: int = 10) -> Optional[Summary]:
    """Reduce the events of one process's traced window; None when no
    window was marked."""
    marks = [e for e in evs if e.name == WINDOW and not e.on_device]
    if not marks:
        return None
    w0, w1 = marks[0].start_ns, marks[0].end_ns
    dev = [(max(e.start_ns, w0), min(e.end_ns, w1), e.name) for e in evs
           if e.on_device and e.end_ns > w0 and e.start_ns < w1]
    busy, merged = union_ns([(a, b) for a, b, _ in dev if b > a])
    by_sym: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        by_sym[kernel_symbol(name)] = by_sym.get(kernel_symbol(name), 0.0) + (b - a) * 1e-9
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps inside the window, each named by the innermost host event
    # (an ATen op, a runtime call or a harness span) covering its middle
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda ab: -(ab[1] - ab[0]))
    host = [e for e in evs if not e.on_device and e.name != WINDOW]
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        cover = [e for e in host if e.start_ns <= mid <= e.end_ns]
        label = min(cover, key=lambda e: e.end_ns - e.start_ns).name if cover \
            else "host: no traced op"
        named.append((label, (b - a) * 1e-9))
    calls = sum(1 for e in host if e.name == CALL and w0 <= e.start_ns < w1)
    return Summary((w1 - w0) * 1e-9, busy * 1e-9, by_sym, ops, named, calls)
