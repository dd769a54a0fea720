"""The program's spans in a traced window.

``fovvideovdp_tpu_torch.tracing`` marks the stages of a call with
``record_function`` ranges named ``fvvdp.<stage>``; the profiler stamps them
on the clock it puts the device's kernels and copies on.  This module
reduces them, for each span name, to: the spans that began in the window,
their host seconds and the seconds the device sat idle inside them (both
clipped to the window), and the device seconds of the kernels and copies
launched inside the innermost span of that name.  A device operation is put
down to the host event that launched it: the op its ``linked_correlation_id``
names (an ATen op, or a span itself where the launch was made straight
from it), or else the runtime call of its correlation id; that event is then
placed in the innermost program span covering it on its thread (on the
H100 with torch 2.11 every kernel and copy of the benchmark's cells links
one way or the other).  ``trace_spans.py`` prints the reduction of each
traced window.

``trace.events`` drops every span's shadow on the device's timeline (an
annotation), as it drops the harness's own, so the program's spans add no
device time to the readings of ``trace.summarise``.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

from fvbench import trace

PREFIX = "fvvdp."            # the program's spans; "fvvdp::" is its kernels' namespace
# a CUDA runtime or driver call, by its name (torch 2.11 gives no activity
# type): cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    on_device: bool
    thread: int = 0          # the host thread that recorded a host event
    corr: int = 0            # the profiler's correlation id
    linked: int = 0          # the correlation id of the host op a launch was made in
    annotation: bool = False  # a span, or a span's shadow on the device's timeline


def events(prof) -> List[Event]:
    """Every event of a finished ``torch.profiler.profile``, with what links
    a device operation to the host event that launched it."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).split(".")[-1].upper() == "CUDA"
        out.append(Event(e.name(), int(e.start_ns()), int(e.end_ns()), dev,
                         int(e.start_thread_id()), int(e.correlation_id()),
                         int(e.linked_correlation_id()), bool(e.is_user_annotation())))
    return out


def is_span(e: Event) -> bool:
    return not e.on_device and e.name.startswith(PREFIX)


def is_runtime(e: Event) -> bool:
    """A CUDA runtime or driver call on the host."""
    return not e.on_device and RUNTIME_CALL.match(e.name) is not None


def device_work(e: Event) -> bool:
    """A kernel, copy or fill: what ``trace.events`` keeps of the device."""
    return e.on_device and not e.annotation and not e.name.startswith(("fvbench.", PREFIX))


class _Nest:
    """The spans of one thread, sorted by start, each with the index of its
    innermost enclosing span: the innermost span covering a time in two
    bisections and a walk up at most the nesting's depth."""

    def __init__(self, spans: List[Event]):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
        self.starts = [s.start_ns for s in self.spans]
        self.parent: List[int] = []
        open_: List[int] = []
        for i, s in enumerate(self.spans):
            while open_ and self.spans[open_[-1]].end_ns < s.start_ns:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def innermost(self, t: int) -> Optional[Event]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i].end_ns < t:
            i = self.parent[i]
        return self.spans[i] if i >= 0 else None


class _Busy:
    """The device's busy time inside any interval, from the merged busy
    intervals of the window."""

    def __init__(self, merged: List[Tuple[int, int]]):
        self.merged = merged
        self.starts = [a for a, _ in merged]
        self.before = [0]
        for a, b in merged:
            self.before.append(self.before[-1] + b - a)

    def _upto(self, t: int) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0
        a, b = self.merged[i]
        return self.before[i] + min(t, b) - a

    def within(self, a: int, b: int) -> int:
        return self._upto(b) - self._upto(a)


def _launch_sites(evs: List[Event], spans: List[Event], work: List[Event]):
    """Per device operation of ``work``, the name of the innermost program
    span it was launched in, or None; and how many were placed through a
    linked op, through a runtime call, or not at all."""
    nests = {}
    for s in spans:
        nests.setdefault(s.thread, []).append(s)
    nests = {t: _Nest(v) for t, v in nests.items()}
    # the two number their events apart: an op's id may be a runtime call's too
    ops = {e.corr: e for e in evs if not e.on_device and not is_runtime(e)}
    runtime = {e.corr: e for e in evs if is_runtime(e)}
    names, routes = [], {"op": 0, "runtime": 0, "none": 0}
    for d in work:
        host, route = (ops.get(d.linked), "op") if d.linked > 0 else (None, "none")
        if host is None:
            host, route = runtime.get(d.corr), "runtime"
        nest = None if host is None else nests.get(host.thread)
        s = None if nest is None else nest.innermost(host.start_ns)
        names.append(None if s is None else s.name)
        routes[route if host is not None else "none"] += 1
    return names, routes


def _stats() -> Dict:
    return {"count": 0, "host_s": 0.0, "idle_s": 0.0, "device_s": 0.0}


def reduce(evs: List[Event], top: int = 10) -> Optional[Dict]:
    """The program's spans of one process's traced window (None when no
    window was marked): ``spans``, per span name, ``count`` (spans that
    began in the window), ``host_s``, ``idle_s`` and ``device_s``;
    ``routes``, how the device operations were placed; ``gaps``, the
    ``top`` longest idle gaps, each as (the innermost program span over its
    middle or None, seconds, the name ``trace.summarise`` gives it);
    ``mem_queries``, the ``top`` longest ``fvvdp.mem_query`` spans as (ms,
    ms of it the device sat idle); ``shadows``, the spans' shadows on the
    device's timeline that are annotations (which ``trace.events`` drops)
    and that are not; and the window's ``window_s``, ``busy_s`` and
    ``calls``."""
    marks = [e for e in evs if e.name == trace.WINDOW and not e.on_device]
    if not marks:
        return None
    w0, w1 = marks[0].start_ns, marks[0].end_ns
    spans = [e for e in evs if is_span(e)]
    work = [e for e in evs if device_work(e) and e.end_ns > w0 and e.start_ns < w1]
    busy_ns, merged = trace.union_ns([(max(e.start_ns, w0), min(e.end_ns, w1)) for e in work
                                      if min(e.end_ns, w1) > max(e.start_ns, w0)])
    busy = _Busy(merged)
    out: Dict[str, Dict] = {}
    queries = []
    for s in spans:
        a, b = max(s.start_ns, w0), min(s.end_ns, w1)
        began = w0 <= s.start_ns < w1
        if b <= a and not began:
            continue
        st = out.setdefault(s.name, _stats())
        st["count"] += began
        if b > a:
            idle = (b - a) - busy.within(a, b)
            st["host_s"] += (b - a) * 1e-9
            st["idle_s"] += idle * 1e-9
            if s.name == PREFIX + "mem_query":
                queries.append(((b - a) * 1e-6, idle * 1e-6))
    names, routes = _launch_sites(evs, spans, work)
    for d, name in zip(work, names):
        if name is not None:
            st = out.setdefault(name, _stats())
            st["device_s"] += (min(d.end_ns, w1) - max(d.start_ns, w0)) * 1e-9
    # the idle gaps as trace.summarise finds and names them, and the program
    # span each falls in
    host = [e for e in evs if not e.on_device and e.name != trace.WINDOW]
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  key=lambda ab: -(ab[1] - ab[0]))[:top]
    named = [(_innermost(spans, (a + b) // 2), (b - a) * 1e-9,
              _innermost(host, (a + b) // 2) or "host: no traced op") for a, b in gaps]
    shadows = [e.annotation for e in evs if e.on_device and e.name.startswith(PREFIX)]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "calls": sum(1 for e in host if e.name == trace.CALL and w0 <= e.start_ns < w1),
            "spans": out, "routes": routes, "gaps": named,
            "mem_queries": sorted(queries, reverse=True)[:top],
            "shadows": {"annotated": sum(shadows), "not_annotated": len(shadows) - sum(shadows)}}


def _innermost(evs: List[Event], t: int) -> Optional[str]:
    """The name of the shortest of ``evs`` covering ``t``, or None."""
    cover = [e for e in evs if e.start_ns <= t <= e.end_ns]
    return min(cover, key=lambda e: e.end_ns - e.start_ns).name if cover else None
