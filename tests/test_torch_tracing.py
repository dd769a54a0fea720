"""The port's spans (``fovvideovdp_tpu_torch.tracing``) on the CPU: a shared
no-op without a profiler, ``record_function`` ranges on the profiler's clock
with one, the stages of an entry call, the one free-memory query
(``memory.usable_bytes``) and the reading it keeps of each card, and scores
that a profiler leaves bit for bit as they are."""
import sys
import threading
import time
from collections import Counter

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


@pytest.fixture(autouse=True)
def no_kept_readings(monkeypatch):
    """Each test starts with no kept reading of any card: each ``SITES``
    case queries the driver once."""
    monkeypatch.setattr(memory, "_readings", {})


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


class _Cards:
    """Stand-ins for the counters ``memory.usable_bytes`` reads of CUDA cards:
    per card index, the driver's free bytes and the caching allocator's
    reserved and allocated bytes, each card's three replaced together; and
    the cards the driver was queried for, in order.  ``current`` is the
    index an un-indexed ``"cuda"`` means."""

    def __init__(self, monkeypatch, cards):
        self.state = dict(cards)
        self.queries = []
        self.current = 0
        monkeypatch.setattr(torch.cuda, "mem_get_info", self._mem_get_info)
        monkeypatch.setattr(torch.cuda, "memory_reserved",
                            lambda device=None: self.state[self._card(device)][1])
        monkeypatch.setattr(torch.cuda, "memory_allocated",
                            lambda device=None: self.state[self._card(device)][2])
        monkeypatch.setattr(torch.cuda, "current_device", lambda: self.current)

    def _card(self, device):
        index = None if device is None else torch.device(device).index
        return self.current if index is None else index

    def _mem_get_info(self, device):
        card = self._card(device)
        self.queries.append(card)
        return self.state[card][0], 80 << 30

    def usable(self, card):
        free, reserved, allocated = self.state[card]
        return free + reserved - allocated

    def allocate(self, card, n):
        """Tensors take ``n`` bytes (give back ``-n``) of the allocator's
        reserved blocks."""
        free, reserved, allocated = self.state[card]
        self.state[card] = (free, reserved, allocated + n)

    def reserve(self, card, n):
        """The allocator takes ``n`` bytes from the driver (gives back
        ``-n``): the driver's free bytes move by as much."""
        free, reserved, allocated = self.state[card]
        self.state[card] = (free - n, reserved + n, allocated)


def _usable_traced(device):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = memory.usable_bytes(device)
    return got, _names(_spans(prof))


@pytest.mark.parametrize("allocated", [1 << 20, 0, -(1 << 20)])
def test_a_kept_reading_answers_while_reserved_is_unchanged(monkeypatch, allocated):
    """Reserved bytes unchanged since the last query: no driver call, one
    empty ``fvvdp.mem_reuse`` span, and the reading less what tensors took
    since (more what they gave back)."""
    cards = _Cards(monkeypatch, {0: (FREE, RESERVED, ALLOCATED)})
    assert _usable_traced(CARD) == (USABLE, ["fvvdp.mem_query"])
    cards.allocate(0, allocated)
    assert _usable_traced(CARD) == (USABLE - allocated, ["fvvdp.mem_reuse"])
    assert cards.usable(0) == USABLE - allocated
    assert cards.queries == [0]


# name: (bytes the allocator takes from the driver or gives back, bytes the
# driver's free memory moves by besides)
RESERVED_MOVES = {
    "a new segment": (20 << 20, 0),
    "empty_cache": (-(3 << 20), 0),
    "a new segment while another process took memory": (20 << 20, -(1 << 30)),
}


@pytest.mark.parametrize("move", list(RESERVED_MOVES))
def test_a_changed_reserved_queries_again(monkeypatch, move):
    """The allocator took memory from the driver or gave some back: the
    next answer is a new query, which the call after it reuses."""
    cards = _Cards(monkeypatch, {0: (FREE, RESERVED, ALLOCATED)})
    assert memory.usable_bytes(CARD) == USABLE
    reserved, elsewhere = RESERVED_MOVES[move]
    cards.reserve(0, reserved)
    free, res, alloc = cards.state[0]
    cards.state[0] = (free + elsewhere, res, alloc)
    assert _usable_traced(CARD) == (USABLE + elsewhere, ["fvvdp.mem_query"])
    assert cards.queries == [0, 0]
    cards.allocate(0, 1 << 20)
    assert _usable_traced(CARD) == (USABLE + elsewhere - (1 << 20), ["fvvdp.mem_reuse"])
    assert cards.queries == [0, 0]


def test_two_cards_keep_separate_readings(monkeypatch):
    """Each card keeps its own reading: a query of one neither serves nor
    drops the other's, and an un-indexed ``"cuda"`` is the current card."""
    cards = _Cards(monkeypatch, {0: (FREE, RESERVED, ALLOCATED),
                                 1: (2 * FREE, 2 * RESERVED, ALLOCATED)})
    one = torch.device("cuda", 1)
    assert memory.usable_bytes(CARD) == cards.usable(0)
    assert memory.usable_bytes(one) == cards.usable(1)
    assert cards.queries == [0, 1]
    cards.reserve(1, 4 << 20)
    cards.allocate(0, 1 << 20)
    assert _usable_traced(CARD) == (cards.usable(0), ["fvvdp.mem_reuse"])
    assert _usable_traced(one) == (cards.usable(1), ["fvvdp.mem_query"])
    assert cards.queries == [0, 1, 1]
    cards.current = 1
    cards.allocate(1, 1 << 20)
    assert _usable_traced(torch.device("cuda")) == (cards.usable(1), ["fvvdp.mem_reuse"])
    assert cards.queries == [0, 1, 1]


def test_threads_on_their_cards_each_get_their_cards_answer(monkeypatch):
    """Eight threads, one per card, each moving its card's counters between
    calls (a new segment every third call, tensors taken between), with the
    interpreter switching threads as often as it can: every answer is its
    own card's, and each card is queried exactly on its first call and after
    each new segment."""
    n, calls = 8, 300
    cards = _Cards(monkeypatch, {k: (FREE + (k << 24), RESERVED, ALLOCATED)
                                 for k in range(n)})
    wrong = []

    def work(k):
        device = torch.device("cuda", k)
        try:
            for i in range(calls):
                if i % 3 == 0:
                    cards.reserve(k, 2 << 20)
                else:
                    cards.allocate(k, 1 << 19)
                got = memory.usable_bytes(device)
                if got != cards.usable(k):
                    wrong.append((k, i, got, cards.usable(k)))
        except Exception as e:  # reported below, with the thread's card
            wrong.append((k, repr(e)))

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []
    assert Counter(cards.queries) == {k: calls // 3 for k in range(n)}
    assert sorted(memory._readings) == list(range(n))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CALLS))
def test_on_the_card_one_memory_query_and_no_device_work_of_the_spans(cuda, case):
    """Content on the card, three calls back to back under a profiler: each
    opens exactly one ``fvvdp.mem_query`` or ``fvvdp.mem_reuse`` (the block
    or chunk size; resident content makes no residency query), and the
    third no query, the allocator having reached its size; each span's
    shadow on the device's timeline is an annotation, no kernel or copy; and
    the scores are bit for bit the first call's, and a fourth call's with no
    profiler."""
    entry, shape, call, _, _ = CALLS[case]
    fv = fv_port.fvvdp(display_name="standard_fhd", device=cuda)
    tst, ref = (torch.from_numpy(x).to(cuda) for x in _content(shape))
    traced = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced.append(call(fv, tst, ref))
            torch.cuda.synchronize()
        names = _names(_spans(prof))
        assert names.count(entry) == 1
        assert names.count("fvvdp.mem_query") + names.count("fvvdp.mem_reuse") == 1
        shadows = [e for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("fvvdp.") and not str(e.device_type()).endswith("CPU")]
        assert all(e.is_user_annotation() for e in shadows)
    assert names.count("fvvdp.mem_query") == 0
    plain = call(fv, tst, ref)
    for got in traced[1:] + [plain]:
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(traced[0][0]))
        if "Q_per_ch" in plain[1]:
            np.testing.assert_array_equal(got[1]["Q_per_ch"], traced[0][1]["Q_per_ch"])


def _record_sizes(monkeypatch):
    """What ``memory.block_size`` and ``memory.chunk_items`` return, in
    order, as (name, size)."""
    sizes = []
    for name in ("block_size", "chunk_items"):
        def recorded(*args, _size=getattr(memory, name), _name=name, **kwargs):
            sizes.append((_name, _size(*args, **kwargs)))
            return sizes[-1][1]
        monkeypatch.setattr(memory, name, recorded)
    return sizes


def _on_card(shape, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    ref = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda, generator=g)
    noise = torch.randint(-30, 30, shape, dtype=torch.int16, device=cuda, generator=g)
    return (ref.to(torch.int16) + noise).clamp_(0, 255).to(torch.uint8), ref


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["4k_clip", "512x384_batch"])
def test_on_the_card_back_to_back_calls_keep_their_sizes_and_scores(cuda, monkeypatch, case):
    """A warm call, then three back-to-back calls on resident content: a 60-
    frame 4K clip through ``predict_video_source``, or KADID-10k's 10,125
    pairs of 512x384 through ``predict_batch``.  Whether a call queries the
    card or reuses the kept reading, it gets the first call's block or chunk
    sizes, as many ``fvvdp.chunk`` spans, and its JODs bit for bit."""
    fv = fv_port.fvvdp(display_name="standard_4k", device=cuda)
    if case == "4k_clip":
        tst, ref = _on_card((60, 2160, 3840, 3), cuda, seed=11)
        source = fv_port.fvvdp_video_source_array(
            tst, ref, FPS, dim_order="FHWC", display_photometry=fv.display_photometry,
            device=cuda)

        def call():
            return fv.predict_video_source(source)
    else:
        tst, ref = _on_card((10125, 384, 512, 3), cuda, seed=12)

        def call():
            return fv.predict_batch(tst, ref, dim_order="BHWC")
    call()
    sizes = _record_sizes(monkeypatch)
    runs = []
    for _ in range(3):
        start = len(sizes)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            jod = np.asarray(call()[0])
            torch.cuda.synchronize()
        runs.append((sizes[start:], _names(_spans(prof)).count("fvvdp.chunk"), jod))
    assert runs[0][0] and runs[0][1] >= 1
    for got in runs[1:]:
        assert got[:2] == runs[0][:2]
        np.testing.assert_array_equal(got[2], runs[0][2])
