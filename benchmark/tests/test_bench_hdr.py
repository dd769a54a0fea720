"""The HDR10 Y'CbCr cell on the CPU at a small size: a run of the ``yuv_clip``
driver is correct, traced runs carry the program's spans to the
readers, the control fails the limits, and ``correct`` comes out false
for each fault of the front stage the plain reference must catch."""
import pytest
import torch

import control_hdr
from conftest import SMALL_CLIP, small_cell
from fvbench import cells, cli, registry, span_context, trace
from fvbench.readers import Context

import fovvideovdp_tpu_torch as fv
from fovvideovdp_tpu_torch import display_model, video_source_yuv
from fovvideovdp_tpu_torch.io import resize
from fovvideovdp_tpu_torch.io import yuv as yuv_io

CELL = "hdr10-4k-yuv"


def _run(tracing=False, seconds=0.2, seed=2**31 + 9):
    cell = small_cell(CELL, **SMALL_CLIP)
    out = registry.driver(cell.traffic["driver"])(cell, seed, seconds, tracing, "cpu",
                                                  cells.process_start())
    return cell, out, cli.assemble(cell, out, tracing)


def test_sound_run_is_correct():
    _, out, res = _run(seconds=1.0)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "clip_p95_ms", "setup_s"}
    assert res["compared"]["jod_gap"]["value"] < 1e-5
    assert all(q < 9.9 for q in out["notes"]["jod_by_pair"].values())


def test_traced_run_hands_the_spans_to_the_readers():
    cell, out, res = _run(tracing=True)
    ctx = out["per_layer"]
    assert isinstance(ctx, span_context.SpanContext) and res["correct"]
    yuv = ctx.spans[0]["spans"]["fvvdp.yuv"]
    # test and reference converted apart: two spans per luminance stage
    assert yuv["count"] == 2 * ctx.spans[0]["spans"]["fvvdp.luminance"]["count"] > 0
    # no device on the CPU: the device readers find nothing, and the span's neither
    assert "yuv_ms_per_frame.hdr" in {m["name"] for m in cell.per_layer}
    assert set(res["metrics"]) == {"launches_per_frame.clip"}


def test_span_reader():
    """Device ms launched inside ``fvvdp.yuv`` per frame; None without the
    span (a program that lacks it), without device work, or on a context
    that carries no spans."""
    read = registry.reader("yuv_ms_per_frame.hdr")
    busy = trace.Summary(10.0, 8.0, {}, [], [], 4)
    spans = {"spans": {"fvvdp.yuv": {"count": 8, "host_s": 1.0, "idle_s": 0.0,
                                     "device_s": 0.6}}}
    ctx = span_context.SpanContext([busy], {}, frames=240, spans=[spans])
    assert read(ctx) == pytest.approx(2.5)
    assert read(span_context.SpanContext([busy], {}, frames=240, spans=[{"spans": {}}])) is None
    idle = trace.Summary(10.0, 0.0, {}, [], [], 4)
    assert read(span_context.SpanContext([idle], {}, frames=240, spans=[spans])) is None
    assert read(Context([busy], {}, frames=240)) is None


def test_parent_without_the_source_fails_at_once(monkeypatch):
    """A program without ``fvvdp_video_source_yuv_array`` fails before any
    content is made."""
    monkeypatch.delattr(fv, "fvvdp_video_source_yuv_array")
    made = []
    monkeypatch.setattr("fvbench.hdr_content.clip_pair", lambda *a: made.append(a))
    with pytest.raises(AttributeError):
        _run()
    assert not made


def test_reference_loads_nothing_of_the_port():
    from test_bench_imports import _loaded
    got = _loaded("import reference.fvvdp_plain_hdr")
    assert not got & {"jax", "jaxlib", "flax", "fovvideovdp_tpu", "fovvideovdp_tpu_torch",
                      "fvbench"}


def test_bfloat16_control_fails():
    cell = small_cell(CELL, **SMALL_CLIP)
    got = control_hdr.readings(cell, 2**31 + 3, "cpu")
    assert any(got[k] > lim for k, lim in cell.limits.items()), (got, cell.limits)


def _srgb_for_pq(monkeypatch):
    forward = display_model.fvvdp_display_photo_eotf.forward

    def srgb(self, V):
        if self.EOTF != "PQ":
            return forward(self, V)
        self.EOTF = "sRGB"
        try:
            return forward(self, V)
        finally:
            self.EOTF = "PQ"
    monkeypatch.setattr(display_model.fvvdp_display_photo_eotf, "forward", srgb)


def _bt709(monkeypatch):
    monkeypatch.setattr(yuv_io, "conversion_matrix", lambda bt2020: yuv_io.YCBCR2RGB_REC709)


def _nearest_chroma(monkeypatch):
    monkeypatch.setattr(yuv_io, "upscale_chroma", lambda uv, hw: resize(uv, tuple(hw), "nearest"))


def _full_range(monkeypatch):
    def y(Y, bd):
        return torch.clamp(yuv_io.as_float(Y) / (2 ** bd - 1), 0.0, 1.0)

    def uv(c, bd):
        return torch.clamp(yuv_io.as_float(c) / (2 ** bd - 1) - 0.5, -0.5, 0.5)
    monkeypatch.setattr(yuv_io, "fixed2float_y", y)
    monkeypatch.setattr(yuv_io, "fixed2float_uv", uv)


def _one_chroma_plane(monkeypatch):
    """The first pair's test clip reaches the program with its Cr plane
    shifted by 16 codes."""
    init = video_source_yuv.fvvdp_video_source_yuv_array.__init__
    built = []

    def altered(self, test, *a, **k):
        init(self, test, *a, **k)
        built.append(self)
        if len(built) == 1:
            n_y = self._formats[0].width * self._formats[0].height
            n_c = (self._t.shape[1] - n_y) // 2
            self._t = self._t.clone()
            self._t[:, n_y + n_c:] += 16
    monkeypatch.setattr(video_source_yuv.fvvdp_video_source_yuv_array, "__init__", altered)


@pytest.mark.parametrize("fault", [_srgb_for_pq, _bt709, _nearest_chroma, _full_range,
                                   _one_chroma_plane],
                         ids=["srgb_for_pq", "bt709_matrix", "nearest_chroma", "full_range",
                              "one_chroma_plane"])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, _, res = _run()
    assert not res["correct"] and res["failed"] >= 1
    over = [k for k, v in res["compared"].items() if v["value"] > v["limit"]]
    assert over, res["compared"]
