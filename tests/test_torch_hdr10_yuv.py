"""HDR10 video on the port's Y'CbCr path: ``fvvdp_video_source_yuv_array``
(raw 10-bit 4:2:0 BT.2020 PQ frames held in memory) against the benchmark's
plain reference (``benchmark/reference/fvvdp_plain_hdr.py``) and against
the .yuv file source on the same bytes, the reference's decode and PQ
display against the port's on every 10-bit code, and the ``fvvdp.yuv``
span.  On the CPU at 128x96 and 12 frames, on the benchmark configuration
``hdr10_4k_yuv420`` cut to that size."""
import json
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from fvbench import content, hdr_content, registry  # noqa: E402
from reference import fvvdp_plain_hdr as plain_hdr  # noqa: E402

import fovvideovdp_tpu_torch as fv  # noqa: E402
from fovvideovdp_tpu_torch import display_model  # noqa: E402
from fovvideovdp_tpu_torch.io import yuv as yuv_io  # noqa: E402
from fovvideovdp_tpu_torch.video_source_yuv import create_yuv_fname  # noqa: E402

W, H, FRAMES = 128, 96, 12
SEEDS = [3, 2**31 + 77]


@pytest.fixture(scope="module")
def cfg():
    """The HDR10 configuration at the tests' size."""
    bench = registry.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "hdr10_4k_yuv420")
    with open(os.path.join(registry.ROOT, entry["file"])) as f:
        c = json.load(f)
    c.update(width=W, height=H, frames=FRAMES)
    return c


@pytest.fixture(scope="module")
def metric():
    return fv.fvvdp(display_name="standard_hdr_pq", device="cpu")


def _source(metric, t, r, **kw):
    return fv.fvvdp_video_source_yuv_array(t, r, 30, W, H,
                                           display_photometry=metric.display_photometry,
                                           color_space_name="BT.2020", device="cpu", **kw)


@pytest.mark.parametrize("pair", range(4), ids=["noise", "blur", "bits", "mix"])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_against_plain_reference(cfg, metric, seed, pair):
    """JOD within 2e-6 and Q_per_ch within 1e-5 of the largest |Q_ref|, as
    the sRGB clips are held to the plain reference."""
    t, r = hdr_content.clip_pair(cfg, pair, seed, torch.device("cpu"))
    assert t.dtype == torch.int16 and t.shape == (FRAMES, W * H * 3 // 2)
    q, stats = metric.predict_video_source(_source(metric, t, r))
    qr, Qr = plain_hdr.PlainFvvdpHDR(cfg, "cpu").score_clip(t, r, 30)
    assert q < 9.9                          # every pair is visibly distorted
    assert abs(q - qr) <= 2e-6
    assert np.max(np.abs(stats["Q_per_ch"] - Qr)) <= 1e-5 * np.max(np.abs(Qr))


def test_content_reaches_the_peak_and_the_dark_end(cfg):
    """The scene spans the PQ display: codes near black and highlights at
    the 1500 cd/m^2 peak, and chroma off neutral."""
    _, r = hdr_content.clip_pair(cfg, 0, SEEDS[0], torch.device("cpu"))
    p = plain_hdr.PlainFvvdpHDR(cfg, "cpu")
    L = p.luminance(r)
    assert float(L.min()) < 0.2 and float(L.max()) >= 1000.0
    y, cb, cr = p.layout.planes(r)
    assert int(y.min()) >= 64 and int(y.max()) <= 940
    assert float((cb.float() - 512).abs().mean()) > 2 and float((cr.float() - 512).abs().mean()) > 2


@pytest.mark.parametrize("access", ["block", "indexed", "frame"])
def test_array_source_is_the_file_source(cfg, metric, tmp_path, access):
    """The same raw samples, in memory and written to a
    ``_10b_420_pq2020_`` .yuv pair, give the same luminance bit for bit:
    a run of frames, repeated and unordered frames, one frame."""
    t, r = hdr_content.clip_pair(cfg, 3, SEEDS[1], torch.device("cpu"))
    names = []
    for name, x in (("test", t), ("ref", r)):
        props = dict(width=W, height=H, bit_depth=10, chroma_ss="420", color_space="2020", fps=30)
        path = tmp_path / create_yuv_fname(f"{name}_pq2020", props)
        x.numpy().view(np.uint16).tofile(path)
        names.append(str(path))
    assert "_10b_420_" in names[0] and "pq2020" in names[0]
    file_src = fv.fvvdp_video_source_yuv_file(*names, display_photometry=metric.display_photometry,
                                              device="cpu", reader="python")
    arr_src = _source(metric, t, r)
    assert arr_src.get_video_size() == file_src.get_video_size() == (H, W, FRAMES)
    assert arr_src.get_frames_per_second() == file_src.get_frames_per_second() == 30
    if access == "block":
        got, want = arr_src.get_luminance_block(2, 7), file_src.get_luminance_block(2, 7)
    elif access == "indexed":
        idx = np.array([0, 0, 0, 5, 3, 11])
        got, want = (arr_src.get_indexed_luminance_block(idx),
                     file_src.get_indexed_luminance_block(idx))
    else:
        got = (arr_src.get_test_frame(4), arr_src.get_reference_frame(9))
        want = (file_src.get_test_frame(4), file_src.get_reference_frame(9))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_array_source_takes_uint16_and_refuses_bad_layouts(cfg, metric):
    t, r = hdr_content.clip_pair(cfg, 0, SEEDS[0], torch.device("cpu"))
    via_numpy = _source(metric, t.numpy().view(np.uint16), r.numpy().view(np.uint16))
    assert torch.equal(via_numpy.get_luminance_block(0, 3)[0], _source(metric, t, r)
                       .get_luminance_block(0, 3)[0])
    with pytest.raises(RuntimeError, match="stored as"):
        _source(metric, t.to(torch.int32), r.to(torch.int32))
    with pytest.raises(RuntimeError, match="must be"):
        _source(metric, t[:, :-2], r[:, :-2])
    with pytest.raises(RuntimeError, match="same number of frames"):
        _source(metric, t[:5], r)


CODES = torch.arange(1024, dtype=torch.int16)


@pytest.mark.parametrize("what", ["luma", "chroma", "upsample", "pq_display"])
def test_reference_front_stage_is_the_ports(cfg, what):
    """The reference's narrow-range decode, chroma upsampling and PQ
    display against the port's ``io.yuv`` and ``display_model`` on all
    1,024 codes, the codes at the top of PQ (above the 1500 cd/m^2 peak)
    included."""
    if what == "luma":
        got = plain_hdr.narrow_to_float(CODES.to(torch.int32), 10, False, torch.float32)
        assert torch.equal(got, yuv_io.fixed2float_y(CODES, 10))
    elif what == "chroma":
        got = plain_hdr.narrow_to_float(CODES.to(torch.int32), 10, True, torch.float32)
        assert torch.equal(got, yuv_io.fixed2float_uv(CODES, 10))
    elif what == "upsample":
        # every code once in a 32 x 32 chroma plane, shuffled
        plane = yuv_io.fixed2float_uv(CODES[torch.randperm(1024, generator=torch.Generator()
                                                           .manual_seed(5))].reshape(32, 32), 10)
        assert torch.equal(plain_hdr.upsample_chroma(plane), yuv_io.upscale_chroma(plane, (64, 64)))
    else:
        v = CODES.to(torch.float32) / 1023.0
        ref = plain_hdr.PQDisplay(cfg["display"]["photometry"], cfg["display"]["geometry"])
        port = display_model.fvvdp_display_photometry.load("standard_hdr_pq")
        got, want = ref.luminance(v), port.forward(v)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert float(want[-1]) == pytest.approx(1500.0 + ref.Y_black, rel=1e-6)
        assert float(want[0]) == pytest.approx(0.005 + ref.Y_black, rel=1e-6)
        assert ref.Y_black == pytest.approx(0.017415, rel=1e-4)
        assert int((want >= 1500.0).sum()) > 100      # PQ's top codes clip at the peak


def _span_counts(metric, src):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metric.predict_video_source(src)
    names = [e.name for e in prof.events()]
    return names.count("fvvdp.yuv"), names.count("fvvdp.luminance")


@pytest.mark.parametrize("kind", ["yuv_array", "yuv_file", "rgb_array"])
def test_yuv_span_once_per_conversion(cfg, metric, tmp_path, kind):
    """Under the profiler each conversion of a Y'CbCr block is one
    ``fvvdp.yuv`` span (test and reference apart: two per luminance
    stage); an RGB source records none."""
    t, r = hdr_content.clip_pair(cfg, 1, SEEDS[0], torch.device("cpu"))
    if kind == "yuv_array":
        src = _source(metric, t, r)
    elif kind == "yuv_file":
        names = []
        for name, x in (("test", t), ("ref", r)):
            path = tmp_path / create_yuv_fname(name, dict(width=W, height=H, bit_depth=10,
                                                          chroma_ss="420", color_space="2020",
                                                          fps=30))
            x.numpy().view(np.uint16).tofile(path)
            names.append(str(path))
        src = fv.fvvdp_video_source_yuv_file(*names, display_photometry=metric.display_photometry,
                                             device="cpu", reader="python")
    else:
        rgb_t, rgb_r = content.clip_pair(dict(cfg, content=dict(
            cfg["content"], distortions=[[["noise", 0.03]]] * 4)), 0, 1, torch.device("cpu"))
        src = fv.fvvdp_video_source_array(rgb_t, rgb_r, 30, dim_order="CFHW",
                                          display_photometry=metric.display_photometry,
                                          device="cpu")
    n_yuv, n_lum = _span_counts(metric, src)
    assert n_lum >= 2
    assert n_yuv == (0 if kind == "rgb_array" else 2 * n_lum)
