"""The program's spans in a traced window (``fvbench/spans.py``): exact
readings on a synthetic trace, the harness's own readings left as they
were, and a traced run of ``drivers/batch.py`` on the CPU."""
import json

import pytest

from conftest import SMALL_SET, small_cell
from fvbench import cells, registry, spans, trace


class _Kineto:
    """What ``spans.events`` and ``trace.events`` read of a profiler event."""

    def __init__(self, e: spans.Event):
        self.e = e

    def name(self):
        return self.e.name

    def start_ns(self):
        return self.e.start_ns

    def end_ns(self):
        return self.e.end_ns

    def device_type(self):
        return "DeviceType.CUDA" if self.e.on_device else "DeviceType.CPU"

    def start_thread_id(self):
        return self.e.thread

    def correlation_id(self):
        return self.e.corr

    def linked_correlation_id(self):
        return self.e.linked

    def is_user_annotation(self):
        return self.e.annotation


class _Profile:
    def __init__(self, evs):
        results = type("R", (), {"events": lambda _: [_Kineto(e) for e in evs]})()
        self.profiler = type("P", (), {"kineto_results": results})()


def E(name, a, b, dev=False, thread=1, corr=0, linked=0, annotation=False):
    return spans.Event(name, a, b, dev, thread, corr, linked, annotation)


def U(name, a, b, corr, dev=False):
    """A record_function range, or its shadow on the device's timeline."""
    return E(name, a, b, dev, corr=corr, annotation=True)


HARNESS = [
    U(trace.WINDOW, 0, 1000, 90), U(trace.CALL, 10, 990, 1), U(trace.CALL, 15, 985, 1, dev=True),
    E("aten::add", 170, 200, corr=7),
    E("cudaMemGetInfo", 40, 120, thread=99, corr=100, linked=3),
    E("cudaLaunchKernel", 175, 180, thread=99, corr=101, linked=7),
    E("aten::mul", 710, 720, corr=8),
    # the runtime numbers its calls apart from the ops: this one shares aten::mul's id
    E("cudaLaunchKernel", 840, 845, corr=8),
    # k1 from aten::add, inside fvvdp.luminance
    E("void at::native::vectorized_elementwise_kernel<4>(int)", 200, 260, True, 0, 101, 7),
    # k2 launched straight from fvvdp.chunk (a kernel wrapper, no ATen op)
    E("(anonymous namespace)::reduce_kernel(float const*)", 400, 500, True, 0, 104, 4),
    # k3 from aten::mul, inside fvvdp.pool
    E("void at::native::vectorized_elementwise_kernel<4>(int)", 720, 740, True, 0, 105, 8),
    # k4: no linked op, its runtime call inside the entry span only
    E("Memcpy DtoH (Device -> Pageable)", 850, 870, True, 0, 8, 0),
    # k5: no link and no runtime call
    E("void fvvdp::sum_partials_kernel<64>(float const*)", 950, 960, True, 0, 103, 0),
]
PROGRAM = [
    U("fvvdp.predict_batch", 20, 900, 2), U("fvvdp.mem_query", 30, 130, 3),
    U("fvvdp.chunk", 150, 600, 4), U("fvvdp.luminance", 160, 300, 5),
    U("fvvdp.pool", 700, 800, 6),
    # their shadows on the device's timeline
    U("fvvdp.chunk", 200, 500, 4, dev=True), U("fvvdp.pool", 720, 740, 6, dev=True),
]


def test_spans_read_exactly():
    r = spans.reduce(spans.events(_Profile(HARNESS + PROGRAM)))
    ns = 1e-9
    expect = {  # count, host, idle, device (ns)
        "fvvdp.predict_batch": (1, 880, 680, 20),
        "fvvdp.mem_query": (1, 100, 100, 0),
        "fvvdp.chunk": (1, 450, 290, 100),
        "fvvdp.luminance": (1, 140, 80, 60),
        "fvvdp.pool": (1, 100, 80, 20),
    }
    assert set(r["spans"]) == set(expect)
    for name, (count, host, idle, device) in expect.items():
        st = r["spans"][name]
        assert st["count"] == count
        assert st["host_s"] == pytest.approx(host * ns, abs=1e-15)
        assert st["idle_s"] == pytest.approx(idle * ns, abs=1e-15)
        assert st["device_s"] == pytest.approx(device * ns, abs=1e-15)
    assert r["routes"] == {"op": 3, "runtime": 1, "none": 1}
    assert r["busy_s"] == pytest.approx(210 * ns) and r["window_s"] == pytest.approx(1000 * ns)
    assert r["calls"] == 1
    assert r["shadows"] == {"annotated": 2, "not_annotated": 0}
    assert [(g[0], round(g[1] / ns), g[2]) for g in r["gaps"][:3]] == [
        ("fvvdp.predict_batch", 220, "fvvdp.predict_batch"),
        ("fvvdp.mem_query", 200, "cudaMemGetInfo"),
        ("fvvdp.chunk", 140, "fvvdp.chunk")]
    assert r["mem_queries"] == [pytest.approx((100e-6, 100e-6))]
    assert json.loads(json.dumps(r))["spans"] == r["spans"]


def test_the_harness_readings_stay_as_they_were():
    """``trace.events`` drops the spans' device shadows, so every reading of
    ``trace.summarise`` is the same with and without the program's spans;
    only the name of a gap may now be the program span that covers it."""
    kernels = [e for e in trace.events(_Profile(HARNESS + PROGRAM)) if e.on_device]
    assert not any(e.name.startswith("fvvdp.") for e in kernels)
    assert any("fvvdp::sum_partials_kernel" in e.name for e in kernels)
    without = trace.summarise(trace.events(_Profile(HARNESS)))
    with_ = trace.summarise(trace.events(_Profile(HARNESS + PROGRAM)))
    for field in ("window_s", "busy_s", "device_s_by_symbol", "device_ops", "calls"):
        assert getattr(with_, field) == getattr(without, field), field
    assert [g[1] for g in with_.idle_gaps] == [g[1] for g in without.idle_gaps]
    for (a, _), (b, _) in zip(with_.idle_gaps, without.idle_gaps):
        assert a == b or a.startswith(spans.PREFIX)


def test_a_traced_batch_run_reads_its_spans(monkeypatch):
    """``drivers/batch.py`` on the CPU, reduced as ``trace_spans.py`` reduces a
    run: one entry span, chunk, luminance pass and pooling per call, no
    memory query and no device time."""
    got = []
    harness_events = trace.events

    def events(prof):
        got.append(spans.reduce(spans.events(prof)))
        return harness_events(prof)
    monkeypatch.setattr(trace, "events", events)
    cell = small_cell("kadid-batch", **SMALL_SET)
    out = registry.driver("batch")(cell, 2**31 + 9, 0.3, True, "cpu", cells.process_start())
    (r,) = got
    calls = out["attempted"]
    assert r["calls"] == calls >= 1
    counts = {k: v["count"] for k, v in r["spans"].items()}
    assert counts == {"fvvdp.predict_batch": calls, "fvvdp.chunk": calls,
                      "fvvdp.luminance": calls, "fvvdp.pool": calls}
    assert all(v["device_s"] == 0 for v in r["spans"].values())
    assert r["busy_s"] == 0
