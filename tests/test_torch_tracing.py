"""The port's spans (``fovvideovdp_tpu_torch.tracing``) on the CPU: a shared
no-op without a profiler, ``record_function`` ranges on the profiler's clock
with one, the stages of an entry call, the one free-memory query
(``memory.usable_bytes``), and scores that a profiler leaves bit for bit as
they are."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu_torch import memory, tracing
from fovvideovdp_tpu_torch.ops.cuda import _autograd

torch.set_num_threads(2)

FPS = 30
H = W = 64


def _spans(prof):
    """The port's spans of a finished profile: (name, start_ns, end_ns,
    thread), in order of start."""
    got = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("fvvdp.") and str(e.device_type()).endswith("CPU")]
    return sorted(got, key=lambda s: (s[1], -s[2]))


def _names(spans):
    return [s[0] for s in spans]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def _content(shape, seed=3):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(*shape) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-30, 30, shape), 0, 255).astype(np.uint8)
    return tst, ref


def test_no_profiler_no_record_function(monkeypatch):
    """Without a recording profiler every span is the one shared no-op and
    ``record_function`` is never entered."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("fvvdp.chunk"), tracing.span("fvvdp.pool")
    assert a is b
    with a, b:
        pass


def test_spans_nest_on_the_profilers_clock():
    """Under ``torch.profiler`` the spans record by name, nested by time in
    their thread, stamped in Unix-epoch nanoseconds: the clock the profiler
    puts the device's events on."""
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("fvvdp.predict_batch"):
            with tracing.span("fvvdp.chunk"):
                with tracing.span("fvvdp.luminance"):
                    torch.ones(8).sum()
            with tracing.span("fvvdp.pool"):
                torch.ones(8).sum()
    after = time.time_ns()
    spans = _spans(prof)
    assert _names(spans) == ["fvvdp.predict_batch", "fvvdp.chunk", "fvvdp.luminance",
                             "fvvdp.pool"]
    entry, chunk, lum, pool = spans
    assert _inside(chunk, entry) and _inside(lum, chunk) and _inside(pool, entry)
    assert pool[1] >= chunk[2]
    for _, start, end, _ in spans:
        assert before <= start <= end <= after


def _video_call(fv, tst, ref):
    return fv.predict(tst, ref, dim_order="FHWC", frames_per_second=FPS)


def _batch_call(fv, tst, ref):
    return fv.predict_batch(tst, ref, dim_order="BHWC")


# name: (entry span, content shape, call, chunks, luminance spans)
CALLS = {
    # blocks of 4 + 4 + 2 frames; the carried frames of the padding are read
    # once before the first block
    "video": ("fvvdp.predict_video_source", (10, H, W, 3), _video_call, 3, 4),
    # chunks of 2 + 2 + 1 images, one luminance pass each
    "image_batch": ("fvvdp.predict_batch", (5, H, W, 3), _batch_call, 3, 3),
}


@pytest.mark.parametrize("case", list(CALLS))
def test_an_entry_call_records_its_stages(case):
    """One entry span over the call; a ``fvvdp.chunk`` per block or chunk,
    each inside it; the luminance passes; one ``fvvdp.pool``; nothing else
    (no free-memory query on the CPU)."""
    entry, shape, call, chunks, passes = CALLS[case]
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu",
                       block_frames=4 if case == "video" else 2)
    tst, ref = _content(shape)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(fv, tst, ref)
    spans = _spans(prof)
    names = _names(spans)
    assert names[0] == entry and names.count(entry) == 1
    assert names.count("fvvdp.chunk") == chunks
    assert names.count("fvvdp.luminance") == passes
    assert names.count("fvvdp.pool") == 1
    assert set(names) == {entry, "fvvdp.chunk", "fvvdp.luminance", "fvvdp.pool"}
    assert all(_inside(s, spans[0]) for s in spans[1:])
    in_chunks = [s for s in spans if s[0] == "fvvdp.luminance"
                 and any(_inside(s, c) for c in spans if c[0] == "fvvdp.chunk")]
    assert len(in_chunks) == chunks


@pytest.mark.parametrize("case", list(CALLS))
def test_a_profiler_leaves_the_scores_bit_for_bit(case):
    _, shape, call, _, _ = CALLS[case]
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu",
                       block_frames=4 if case == "video" else 2)
    tst, ref = _content(shape, seed=7)
    plain = call(fv, tst, ref)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = call(fv, tst, ref)
    np.testing.assert_array_equal(np.asarray(traced[0]), np.asarray(plain[0]))
    if "Q_per_ch" in plain[1]:
        np.testing.assert_array_equal(traced[1]["Q_per_ch"], plain[1]["Q_per_ch"])


class _CardTensor:
    """What ``_autograd.recompute_frames`` reads of a framed argument on a
    card: frames of 2 x 3 float32 values."""
    device = torch.device("cuda", 0)
    shape = (5, 2, 3)

    def dim(self):
        return 3

    def element_size(self):
        return 4

    def __getitem__(self, i):
        return torch.zeros(2, 3)


FREE, RESERVED, ALLOCATED = 3 << 30, 5 << 20, 2 << 20
USABLE = FREE + RESERVED - ALLOCATED
CARD = torch.device("cuda", 0)
# name: (query, what it returns for FREE, RESERVED and ALLOCATED)
SITES = {
    "memory.usable_bytes": (lambda: memory.usable_bytes(CARD), USABLE),
    "memory.block_size": (lambda: memory.block_size(2160, 3840, 60, 40, CARD),
                          int(0.5 * USABLE // (40 * 2160 * 3840))),
    "memory.chunk_items": (lambda: memory.chunk_items(384, 512, 10125, 1, 48, CARD),
                           int(0.5 * USABLE // (48 * 384 * 512))),
    "memory.heatmap_budget": (lambda: memory.heatmap_budget(CARD), USABLE // 2),
    "memory.preload_limit": (lambda: memory.preload_limit(CARD), 0.25 * USABLE),
    "memory.pixel_table_chunk": (lambda: memory.pixel_table_chunk(32, CARD),
                                 (USABLE // 8) // (4 * 32 * 32 + 16 * 32)),
    "_autograd.recompute_frames": (
        lambda: _autograd.recompute_frames(
            _autograd.KernelOp(None, None, (0,), (0,), 2.0), [_CardTensor()]),
        int(0.5 * USABLE // (2.0 * 24))),
}


@pytest.mark.parametrize("site", list(SITES))
def test_every_free_memory_query_is_one_span(monkeypatch, site):
    """Each of the port's memory budgets reads the card through
    ``memory.usable_bytes``: one ``fvvdp.mem_query`` span, one
    ``torch.cuda.mem_get_info`` call, and the site's own arithmetic on the
    free bytes plus what the caching allocator holds unused."""
    queries = []

    def mem_get_info(device):
        queries.append(torch.device(device))
        return FREE, 80 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: RESERVED)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: ALLOCATED)
    query, expected = SITES[site]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = query()
    assert got == expected
    assert queries == [CARD]
    assert _names(_spans(prof)) == ["fvvdp.mem_query"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CALLS))
def test_on_the_card_one_memory_query_and_no_device_work_of_the_spans(cuda, case):
    """Content on the card: one free-memory query per call (the block or
    chunk size; resident content makes no residency query); each span's
    shadow on the device's timeline is an annotation, no kernel or copy;
    and a profiler leaves the scores bit for bit."""
    entry, shape, call, _, _ = CALLS[case]
    fv = fv_port.fvvdp(display_name="standard_fhd", device=cuda)
    tst, ref = (torch.from_numpy(x).to(cuda) for x in _content(shape))
    plain = call(fv, tst, ref)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = call(fv, tst, ref)
        torch.cuda.synchronize()
    names = _names(_spans(prof))
    assert names.count(entry) == 1 and names.count("fvvdp.mem_query") == 1
    shadows = [e for e in prof.profiler.kineto_results.events()
               if e.name().startswith("fvvdp.") and not str(e.device_type()).endswith("CPU")]
    assert all(e.is_user_annotation() for e in shadows)
    np.testing.assert_array_equal(np.asarray(traced[0]), np.asarray(plain[0]))
    if "Q_per_ch" in plain[1]:
        np.testing.assert_array_equal(traced[1]["Q_per_ch"], plain[1]["Q_per_ch"])
