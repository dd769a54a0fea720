"""The Y'CbCr luminance stage of fovvideovdp_tpu_torch: raw planar frames
through one kernel (``ops/cuda/yuv_luminance.py``,
``csrc/yuv_luminance.cu``).

On the CPU: the route (which conversions take the kernel, which keep the
plain version ``yuv_block_to_luminance_plain``, and why), the wrapper's
checks, the launch plan, the cached 4:2:0 tap weights against ``io._taps``
and the chroma upsampling of the kernel's window against
``io.yuv.upscale_chroma``, the kernel's float32 constants, and a
plain-PyTorch emulation of the kernel's arithmetic (its constants, its
taps, its order of operations) against the plain version for every
photometry and sample format.  The ``gpu`` tests hold the kernel to the
plain version on the card, bit for bit, its powf to powf
(``tests/cuda/pow_nonneg_check.cu``, built here with nvcc), and the array
source at even and odd sizes to the CPU through ``predict_video_source``:
``python -m pytest --noconftest -m gpu tests/test_torch_yuv_luminance.py``.
"""
import ctypes
import os
import subprocess
import types

import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fv
from fovvideovdp_tpu_torch import display_model as dmod
from fovvideovdp_tpu_torch import video_source_yuv as vsy
from fovvideovdp_tpu_torch.io import _taps
from fovvideovdp_tpu_torch.io import yuv as yuv_io
from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.ops.cuda import yuv_luminance as yl
from fovvideovdp_tpu_torch.video_source import rgb_to_y

torch.set_num_threads(2)

RGB2Y = rgb_to_y("BT.2020")

PHOTOMETRIES = {
    "srgb": lambda: dmod.fvvdp_display_photo_eotf(200, contrast=1000, EOTF="sRGB"),
    "gamma": lambda: dmod.fvvdp_display_photo_eotf(300, contrast=500, EOTF="gamma",
                                                   gamma=2.2, E_ambient=50),
    "gamma_2": lambda: dmod.fvvdp_display_photo_eotf(300, contrast=500, EOTF="gamma", gamma=2),
    "pq": lambda: dmod.fvvdp_display_photometry.load("standard_hdr_pq"),
    "linear": lambda: dmod.fvvdp_display_photo_eotf(200, contrast=1000, EOTF="linear"),
    "absolute": lambda: dmod.fvvdp_display_photo_absolute(L_max=200, L_min=0.2),
    "gog_srgb": lambda: dmod.fvvdp_display_photo_gog(200, contrast=1000, gamma=-1),
    "gog_2.2": lambda: dmod.fvvdp_display_photo_gog(200, contrast=1000, gamma=2.2),
}

# (width, height, bit depth, chroma, BT.2020): the cell's format, an 8-bit
# "BT.709" 4:2:0 clip, 12-bit 4:4:4, odd 4:2:0 chroma (959 x 539 at full
# size, here 13 x 7), 12-bit 4:2:0 "BT.709" with odd chroma on a width off
# a multiple of 4, 4:4:4 on such a width (odd 4:2:0 luma keeps the plain
# version: test_route)
FORMATS = {
    "10b_420_2020": (32, 18, 10, "420", True),
    "8b_420_709": (32, 18, 8, "420", False),
    "12b_444_2020": (24, 10, 12, "444", True),
    "odd_chroma": (26, 14, 10, "420", True),
    "12b_420_709": (34, 22, 12, "420", False),
    "ragged_444": (22, 9, 8, "444", False),
}


def raw_frames(w, h, bd, ss, n=3, seed=0):
    """n frames of uniform random codes over the whole stored range (below
    and above the narrow range, so that every clamp is reached)."""
    g = torch.Generator().manual_seed(seed)
    fs = yl.frame_samples(w, h, ss)
    x = torch.randint(0, 2 ** bd, (n, fs), generator=g, dtype=torch.int32)
    return x.to(torch.int16 if bd > 8 else torch.uint8)


def plain(raw, fmt, dm, rgb2y=RGB2Y):
    w, h, bd, ss, bt2020 = fmt
    return vsy.yuv_block_to_luminance_plain(raw, w, h, bd, ss, bt2020, None, h, w, dm, rgb2y)


def window_taps(in_size, out_size):
    """The kernel's window's taps: output j reads inputs (j + 1) // 2 - 1
    and (j + 1) // 2, clamped (its tile tx reads columns 2 tx - 1 .. 2 tx + 2,
    clamped, column 4 tx + c the local pair starting at (c + 1) // 2)."""
    first = (torch.arange(out_size) + 1) // 2 - 1
    return torch.stack([first, first + 1], dim=1).clamp(0, in_size - 1)


def upsample(P, weights, h, w):
    """(..., h / 2, w / 2) chroma -> (..., h, w) as the kernel's window
    computes it, with the tap weights of ``tap_tables``: width, then
    height."""
    ty, tx = weights[:2 * h].reshape(h, 2), weights[2 * h:].reshape(w, 2)
    iy, ix = window_taps(P.shape[-2], h), window_taps(P.shape[-1], w)
    x = P[..., ix[:, 0]] * tx[:, 0] + P[..., ix[:, 1]] * tx[:, 1]
    return x[..., iy[:, 0], :] * ty[:, 0, None] + x[..., iy[:, 1], :] * ty[:, 1, None]


def emulate(raw, fmt, dm, rgb2y=RGB2Y):
    """The kernel's arithmetic in plain PyTorch: its float32 constants
    (``kernel_params``), its taps (``tap_tables``) and its order of
    operations, on whole planes."""
    w, h, bd, ss, bt2020 = fmt
    ph = yl.photometry_params(dm)
    p = [torch.tensor(v) for v in yl.kernel_params(bd, bt2020, ph, rgb2y)]
    wy, oy, wuv, ouv = p[:4]
    M, r2y = p[4:13], p[13:16]
    scale, black, lo, hi, gamma = p[16:21]
    th, a, inv_den, inv_lin, e = p[21:26]
    inv_m, c1, c2, c3, inv_n, lmax = p[26:32]
    n = raw.shape[0]
    cw, ch = yl.chroma_shape(w, h, ss)
    codes = (raw.to(torch.int32) & 0xFFFF).to(torch.float32)
    Y = torch.clamp(codes[:, :w * h].reshape(n, h, w) * wy - oy, 0.0, 1.0)
    uv = [torch.clamp(codes[:, w * h + k * cw * ch:w * h + (k + 1) * cw * ch]
                      .reshape(n, ch, cw) * wuv - ouv, -0.5, 0.5) for k in range(2)]
    if ss == "420":
        uv = [upsample(P, yl.tap_tables(h, w, "cpu"), h, w) for P in uv]

    def eotf(V):
        if ph.kind == "sRGB":
            s = torch.where(V > th, torch.pow((V + a) * inv_den, float(e)), V * inv_lin)
            return scale * s + black
        if ph.kind == "gamma":
            return scale * torch.pow(V, ph.gamma) + black
        if ph.kind == "PQ":
            im = torch.pow(V, float(inv_m))
            q = torch.clamp(im - c1, min=0.0) / (c2 - c3 * im)
            return torch.clamp(lmax * torch.pow(q, float(inv_n)), lo, hi) + black
        V = torch.clamp(V, lo, hi)
        return V + black if ph.add_black else V

    L = None
    for c in range(3):
        x = Y * M[3 * c]
        x = x + uv[0] * M[3 * c + 1]
        x = x + uv[1] * M[3 * c + 2]
        term = eotf(torch.clamp(x, 0.0, 1.0)) * r2y[c]
        L = term if L is None else L + term
    return L


# ---------------------------------------------------------------------------
# The kernel's arithmetic, emulated, against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("photometry", sorted(p for p in PHOTOMETRIES if p != "gamma_2"))
def test_emulation_matches_plain(photometry, fmt):
    """The kernel's constants, taps and order of operations give the plain
    version's luminance on the CPU.  Within a few float32 ulp, not bit for
    bit: on the card ATen divides by a Python scalar as a product with its
    reciprocal (in double, made float32), which the kernel repeats, and the
    CPU divides; the card's own test is bit for bit."""
    dm = PHOTOMETRIES[photometry]()
    raw = raw_frames(*FORMATS[fmt][:4], seed=sorted(FORMATS).index(fmt))
    want = plain(raw, FORMATS[fmt], dm)
    got = emulate(raw, FORMATS[fmt], dm)
    assert got.shape == want.shape == (3, FORMATS[fmt][1], FORMATS[fmt][0])
    torch.testing.assert_close(got, want, rtol=3e-6, atol=0)


@pytest.mark.parametrize("photometry", ["pq", "linear", "absolute"])
def test_emulation_is_plain_bit_for_bit_without_a_scalar_division(photometry):
    """Where the plain version divides by no Python scalar (PQ, the clamps)
    the emulation is the plain version bit for bit on the CPU too: the same
    operations in the same order."""
    fmt = FORMATS["10b_420_2020"]
    dm = PHOTOMETRIES[photometry]()
    raw = raw_frames(*fmt[:4], seed=4)
    assert torch.equal(emulate(raw, fmt, dm), plain(raw, fmt, dm))


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

class _Sub(dmod.fvvdp_display_photo_eotf):
    """A subclass may override forward: the kernel cannot know it."""


ROUTES = {
    # name: (device, resize (method, rh, rw) or None, photometry, kernel?[,
    # (width, height), chroma]); 32 x 18 4:2:0 unless given
    "cuda": ("cuda", None, lambda: PHOTOMETRIES["pq"](), True),
    "cuda_gog": ("cuda", None, lambda: PHOTOMETRIES["gog_2.2"](), True),
    "cuda_absolute": ("cuda", None, lambda: PHOTOMETRIES["absolute"](), True),
    "cuda_linear": ("cuda", None, lambda: PHOTOMETRIES["linear"](), True),
    "cuda_resize_same_size": ("cuda", ("bicubic", 18, 32), lambda: PHOTOMETRIES["pq"](), True),
    "cpu": ("cpu", None, lambda: PHOTOMETRIES["pq"](), False),
    "cuda_resize": ("cuda", ("bicubic", 36, 64), lambda: PHOTOMETRIES["pq"](), False),
    "cuda_resize_width": ("cuda", ("bilinear", 18, 30), lambda: PHOTOMETRIES["srgb"](), False),
    "cuda_subclass": ("cuda", None, lambda: _Sub(200, EOTF="sRGB"), False),
    "cuda_unknown_eotf": ("cuda", None, lambda: dmod.fvvdp_display_photo_eotf(200, EOTF="HLG"),
                          False),
    # ATen squares for a gamma of 2: no powf
    "cuda_gamma_2": ("cuda", None, lambda: PHOTOMETRIES["gamma_2"](), False),
    "cuda_gamma_2.2": ("cuda", None, lambda: PHOTOMETRIES["gamma"](), True),
    # odd 4:2:0 luma: the sources' rows are w * h * 3 // 2 samples, the
    # chroma no 2x upscale
    "cuda_odd_width": ("cuda", None, lambda: PHOTOMETRIES["pq"](), False, (31, 18), "420"),
    "cuda_odd_height": ("cuda", None, lambda: PHOTOMETRIES["pq"](), False, (32, 17), "420"),
    "cuda_odd_444": ("cuda", None, lambda: PHOTOMETRIES["pq"](), True, (31, 17), "444"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route(monkeypatch, route):
    """Raw frames on a CUDA card, with no full-screen resize that changes
    the size, 4:2:0 at even luma sizes, under one of display_model's three
    photometry classes with a power ATen takes through powf, go to the
    kernel; a CPU tensor, a resize, odd 4:2:0 luma, a subclass, an EOTF the
    plain version does not know or a special power keep the plain version.
    Both inside the span."""
    device, resize, make_dm, kernel = ROUTES[route][:4]
    (w, h), ss = ROUTES[route][4:] or ((32, 18), "420")
    calls = []
    monkeypatch.setattr(yl, "yuv_luminance", lambda raw, *a: calls.append(("kernel", a)) or "K")
    monkeypatch.setattr(vsy, "yuv_block_to_luminance_plain",
                        lambda raw, *a: calls.append(("plain", a)) or "P")
    monkeypatch.setattr(vsy, "span", lambda name: calls.append(name) or _NullSpan())
    raw = types.SimpleNamespace(device=torch.device(device), dtype=torch.int16)
    method, rh, rw = resize if resize else (None, h, w)
    dm = make_dm()
    assert yl.uses_kernel(raw, w, h, ss, dm, resize is not None and (rh, rw) != (h, w)) == kernel
    got = vsy.yuv_block_to_luminance(raw, w, h, 10, ss, True, method, rh, rw, dm, RGB2Y)
    assert calls[0] == "fvvdp.yuv" and len(calls) == 2
    assert got == ("K" if kernel else "P") and calls[1][0] == ("kernel" if kernel else "plain")


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("kind", ["block", "indexed", "frame"])
def test_cpu_sources_keep_the_plain_version(monkeypatch, kind):
    """The array source on the CPU never reaches the kernel's wrapper."""
    monkeypatch.setattr(yl, "yuv_luminance", lambda *a: pytest.fail("the kernel was called"))
    w, h = 32, 18
    t, r = raw_frames(w, h, 10, "420", n=6, seed=1), raw_frames(w, h, 10, "420", n=6, seed=2)
    src = vsy.fvvdp_video_source_yuv_array(t, r, 30, w, h, display_photometry="standard_hdr_pq",
                                           device="cpu")
    dm = src.dm_photometry
    fmt = (w, h, 10, "420", True)
    if kind == "block":
        got, want = src.get_luminance_block(1, 3)[0], plain(t[1:4], fmt, dm, src.color_to_luminance)
    elif kind == "indexed":
        got = src.get_indexed_luminance_block(np.array([4, 0, 4]))[1]
        want = plain(r[[4, 0, 4]], fmt, dm, src.color_to_luminance)
    else:
        got, want = src.get_test_frame(5)[0, 0], plain(t[5:6], fmt, dm, src.color_to_luminance)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The wrapper's checks and launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", ["uint8_at_10_bits", "int16_at_8_bits", "int32", "samples",
                                 "one_dim", "row_stride", "chroma", "odd_luma", "gamma_2"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """Checked before any launch: the sample type of the bit depth, (n,
    frame_samples) frames, contiguous frame rows, 4:2:0 or 4:4:4, 4:2:0 at
    even luma sizes, a photometry the kernel computes."""
    w, h, bd, ss = 32, 18, 10, "420"
    raw = raw_frames(w, h, bd, ss)
    dm = PHOTOMETRIES["gamma_2" if bad == "gamma_2" else "pq"]()
    match = {"uint8_at_10_bits": "stored as", "int16_at_8_bits": "stored as",
             "int32": "stored as", "samples": "must be", "one_dim": "must be",
             "row_stride": "contiguous", "chroma": "chroma_ss", "odd_luma": "even luma",
             "gamma_2": "does not compute"}[bad]
    if bad == "uint8_at_10_bits":
        raw = raw.to(torch.uint8)
    elif bad == "int16_at_8_bits":
        bd = 8
    elif bad == "int32":
        raw = raw.to(torch.int32)
    elif bad == "samples":
        raw = raw[:, :-2]
    elif bad == "one_dim":
        raw = raw[0]
    elif bad == "row_stride":
        wide = torch.zeros((raw.shape[0], 2 * raw.shape[1]), dtype=raw.dtype)
        wide[:, ::2] = raw
        raw = wide[:, ::2]
    elif bad == "chroma":
        ss = "422"
    elif bad == "odd_luma":
        w, h = 31, 17
        raw = torch.zeros((3, w * h * 3 // 2), dtype=torch.int16)
    with pytest.raises((RuntimeError, ValueError), match=match):
        yl.yuv_luminance(raw, w, h, bd, ss, True, dm, RGB2Y)


def test_wrapper_takes_a_good_block_and_a_frame_stride():
    """Contiguous blocks, a single frame and frames a stride apart pass."""
    raw = raw_frames(32, 18, 10, "420", n=4)
    yl.check_raw(raw, 32, 18, 10, "420")
    yl.check_raw(raw[2:3], 32, 18, 10, "420")
    wide = torch.zeros((4, raw.shape[1] + 8), dtype=raw.dtype)
    wide[:, :raw.shape[1]] = raw
    yl.check_raw(wide[:, :raw.shape[1]], 32, 18, 10, "420")
    yl.check_raw(raw_frames(32, 18, 8, "444"), 32, 18, 8, "444")


def test_launch_plan_arm_and_grid():
    """The vector arm needs rows a multiple of 4, frames 4 samples apart,
    raw aligned to 4 samples and out to 16 bytes; one thread a 2 x 4 tile."""
    out = torch.empty((8, 2160, 3840), dtype=torch.float32)
    raw = torch.empty((8, yl.frame_samples(3840, 2160, "420")), dtype=torch.int16)
    plan = yl.launch_plan(raw, out, 3840, 2160)
    assert plan.vec and plan.frame_stride == 3840 * 2160 * 3 // 2
    assert plan.frame_tiles == 1080 * 960 and plan.blocks == 1080 * 960 // 256
    buf = torch.empty(3 * 2 * 32 * 18 + 1, dtype=torch.uint8)
    assert not yl.launch_plan(buf[1:].view(2, -1), torch.empty((2, 18, 32)), 32, 18).vec
    assert yl.launch_plan(buf[:-1].view(2, -1), torch.empty((2, 18, 32)), 32, 18).vec
    odd = torch.empty((2, yl.frame_samples(1918, 1078, "420")), dtype=torch.int16)
    plan = yl.launch_plan(odd, torch.empty((2, 1078, 1918)), 1918, 1078)
    assert not plan.vec and plan.frame_tiles == 539 * 480 and plan.blocks == 1011
    strided = torch.empty((3, 32 * 18 * 3 // 2 + 2), dtype=torch.int16)[:, :-2]
    assert not yl.launch_plan(strided, torch.empty((3, 18, 32)), 32, 18).vec
    assert yl.launch_plan(strided[2:3], torch.empty((1, 18, 32)), 32, 18).vec


# ---------------------------------------------------------------------------
# The tap tables
# ---------------------------------------------------------------------------

# (luma h, luma w): 4K; odd chroma (1918 x 1078); odd luma (1917 x 1079),
# which the kernel does not take; one chroma row and column
TAP_SHAPES = [(2160, 3840), (1078, 1918), (1079, 1917), (2, 2)]


@pytest.mark.parametrize("shape", TAP_SHAPES, ids=["4k", "odd_chroma", "odd_luma", "one"])
def test_tap_tables_are_io_taps(shape):
    """The rows' weights then the columns', each io._taps' own (a one-tap
    axis padded with weight 0), whose indices follow the kernel's window;
    odd luma sizes have no such taps and are refused."""
    h, w = shape
    if h % 2 or w % 2:
        with pytest.raises(ValueError, match="2x window"):
            yl.tap_tables(h, w, "cpu")
        return
    t = yl.tap_tables(h, w, "cpu")
    assert t.dtype == torch.float32 and t.shape == (2 * h + 2 * w,)
    for n_out, wt in ((h, t[:2 * h]), (w, t[2 * h:])):
        ref_i, ref_w = _taps(n_out // 2, n_out, "linear")
        k = ref_i.shape[1]
        got_w = wt.reshape(n_out, 2)
        assert np.array_equal(got_w[:, :k].numpy(), ref_w) and not got_w[:, k:].any()
        pad = np.zeros((n_out, 2 - k), dtype=ref_i.dtype)
        assert yl.regular_taps(np.concatenate([ref_i, pad], axis=1), got_w.numpy(),
                               n_out // 2, n_out)


# even luma sizes 2 .. 1200 in four runs, and sizes of common frames up to 8K
EVEN_SIZES = {"2-300": range(2, 302, 2), "302-600": range(302, 602, 2),
              "602-900": range(602, 902, 2), "902-1200": range(902, 1202, 2),
              "frames": [1440, 1600, 1920, 2160, 2560, 3840, 4320, 7680]}


@pytest.mark.parametrize("sizes", sorted(EVEN_SIZES))
def test_every_even_size_takes_the_window(sizes):
    """io._taps' 2x upscale of every even size follows the kernel's window,
    so the route's rule (4:2:0 at even luma sizes) leaves no size to a
    table of taps."""
    for n in EVEN_SIZES[sizes]:
        idx, w = yl._two_taps(n // 2, n)
        assert yl.regular_taps(idx, w, n // 2, n), n


@pytest.mark.parametrize("shape", [(18, 32), (14, 26), (2, 2), (1080, 1920)],
                         ids=["even", "odd_chroma", "one", "1080p"])
def test_tap_tables_upsample_as_io(shape):
    """Width then height through the kernel's window's clamped taps with
    the tables' weights is io.yuv.upscale_chroma bit for bit, on decoded
    10-bit chroma (exact zeros, both signs, the clamps)."""
    h, w = shape
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 1024, (2, h // 2, w // 2), generator=g,
                          dtype=torch.int32).to(torch.int16)
    codes[:, ::3, ::5] = 512                          # decoded to exactly 0
    plane = yuv_io.fixed2float_uv(codes, 10)
    got = upsample(plane, yl.tap_tables(h, w, "cpu"), h, w)
    assert torch.equal(got, yuv_io.upscale_chroma(plane, (h, w)))


def test_tap_tables_are_cached_by_shape_and_device():
    a = yl.tap_tables(18, 32, "cpu")
    assert yl.tap_tables(18, 32, torch.device("cpu")) is a
    assert yl.tap_tables(18, 30, "cpu") is not a
    assert all((k[:2], k[2].type) != ((18, 32), "cuda") for k in yl._taps_cache)


# ---------------------------------------------------------------------------
# The kernel's constants
# ---------------------------------------------------------------------------

def test_kernel_params_in_the_kernels_order():
    """Decode, matrix, weights, photometry, then srgb2lin's and pq2lin's
    constants: 32 float32 values."""
    dm = PHOTOMETRIES["pq"]()
    p = yl.kernel_params(10, True, yl.photometry_params(dm), RGB2Y)
    assert p.dtype == np.float32 and p.shape == (32,)
    f32 = np.float32
    assert p[0] == f32(1 / (4 * 219.0)) and p[1] == f32(16 / 219.0)
    assert p[2] == f32(1 / (4 * 224.0)) and p[3] == f32(128 / 224.0)
    assert np.array_equal(p[4:13], yuv_io.YCBCR2RGB_REC2020.ravel())
    assert np.array_equal(p[13:16], np.array(RGB2Y, dtype=f32))
    black = dm.get_black_level()
    assert list(p[16:20]) == [f32(dm.Y_peak - black), f32(black), f32(0.005), f32(dm.Y_peak)]
    # ATen's reciprocal of a Python scalar divisor: in double, then float32
    assert p[23] == f32(1 / 1.055) != f32(1) / f32(1.055)
    assert p[24] == f32(1 / 12.92) and p[25] == f32(2.4)
    assert p[26] == f32(1 / 78.84375) and p[30] == f32(1 / 0.1593017578125) and p[31] == 10000
    p709 = yl.kernel_params(8, False, yl.photometry_params(dm), RGB2Y)
    assert p709[0] == f32(1 / 219.0) and np.array_equal(p709[4:13],
                                                        yuv_io.YCBCR2RGB_REC709.ravel())


@pytest.mark.parametrize("photometry,kind,flags", [
    ("srgb", "sRGB", [1]), ("gamma", "gamma", [1]), ("gamma_2", None, None),
    ("pq", "PQ", [1]), ("linear", "clamp", [1]), ("absolute", "clamp", [0]),
    ("gog_srgb", "sRGB", [1]), ("gog_2.2", "gamma", [1])])
def test_photometry_kinds_and_flags(photometry, kind, flags):
    """Each photometry's kind and add_black flag; a gamma of 2, which ATen
    squares, is none the kernel computes."""
    ph = yl.photometry_params(PHOTOMETRIES[photometry]())
    assert (ph and ph.kind) == kind
    assert (ph and [int(ph.add_black)]) == flags


@pytest.mark.parametrize("e,powf", [(2.2, True), (2.4, True), (0, False), (1, False),
                                    (0.5, False), (-0.5, False), (-1, False), (2, False),
                                    (3.0, False), (-2, False), (2.0000000001, False)])
def test_pow_mode_follows_aten(e, powf):
    """ATen's special exponents of torch.pow(tensor, scalar) on the card;
    2, 3 and -2 are tested after the exponent is made float32."""
    assert yl.takes_powf(e) == powf


# ---------------------------------------------------------------------------
# On the card: the kernel against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_kernel_matches_plain_on_the_card(cuda, fmt):
    """Bit for bit, every photometry, one launch a conversion (none for a
    gamma of 2, which keeps the plain version); a view one sample off its
    alignment takes the masked arm and agrees too."""
    w, h, bd, ss, _ = FORMATS[fmt]
    raw = raw_frames(w, h, bd, ss, n=5, seed=7).to(cuda)
    buf = torch.empty(raw.numel() + 1, dtype=raw.dtype, device=cuda)
    off = buf[1:].view(raw.shape)
    off.copy_(raw)
    for name, make_dm in PHOTOMETRIES.items():
        dm = make_dm()
        launches = int(yl.photometry_params(dm) is not None)
        for x in (raw, off, raw[1:4], raw.index_select(0, torch.tensor([4, 0, 4], device=cuda))):
            _lib.reset_launch_counts()
            got = vsy.yuv_block_to_luminance(x, w, h, bd, ss, FORMATS[fmt][4], None, h, w, dm,
                                             RGB2Y)
            assert _lib.launch_counts()["yuv_luminance"] == launches, name
            assert torch.equal(got, plain(x, FORMATS[fmt], dm)), name


def build_pow_check(out_dir):
    """tests/cuda/pow_nonneg_check.cu built with the package's nvcc flags
    against csrc/, loaded."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda", "pow_nonneg_check.cu")
    lib = os.path.join(str(out_dir), "libpow_nonneg_check.so")
    subprocess.run([_lib.find_nvcc(), *_lib.NVCC_FLAGS, "-I", _lib.SRC_DIR, "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).fvvdp_pow_nonneg_mismatches
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    return fn


@pytest.mark.gpu
def test_kernel_powf_is_powf_on_every_float(cuda, tmp_path):
    """The kernel's branch-free powf (csrc/pow_nonneg.cuh) against powf on
    all 2^30 + 1 floats in [0, 2], for srgb2lin's and pq2lin's exponents."""
    fn = build_pow_check(tmp_path)
    counts = torch.zeros(3, dtype=torch.int64, device=cuda)
    assert fn(counts.data_ptr(), _lib.stream_ptr(counts)) == 0
    assert counts.tolist() == [0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["vec_offset", "vec_width", "kind", "taps", "regular", "stride"])
def test_entry_point_refuses_a_plan_that_contradicts_it(cuda, bad):
    """A misaligned vector arm, an unknown kind, 4:2:0 without its tap
    weights or at an odd size, frames closer than their planes."""
    w, h = 32, 18
    raw = raw_frames(w, h, 10, "420", n=2).to(cuda)
    out = torch.empty((2, h, w), device=cuda)
    taps = yl.tap_tables(h, w, cuda)
    p = yl.kernel_params(10, True, yl.photometry_params(PHOTOMETRIES["pq"]()), RGB2Y)
    args = dict(raw=raw.data_ptr(), W=w, kind=2, taps=taps.data_ptr(), stride=raw.shape[1],
                vec=1)
    if bad == "vec_offset":
        args["raw"] += 2
    elif bad == "vec_width":
        args["W"] = 30
    elif bad == "kind":
        args["kind"] = 4
    elif bad == "taps":
        args["taps"] = None
    elif bad == "regular":
        args["W"], args["vec"] = 31, 0
    else:
        args["stride"] -= 1
    rc = _lib.kernel_fn("yuv_luminance")(
        args["raw"], out.data_ptr(), args["taps"], 2, args["stride"], args["W"], h, 2, 1,
        args["kind"], args["vec"], p.ctypes.data, 1, _lib.stream_ptr(raw))
    assert rc != 0


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(64, 36), (63, 35)], ids=["even", "odd_luma"])
def test_array_source_on_the_card_against_the_cpu(cuda, size):
    """A 10-bit 4:2:0 PQ clip in the sources' layout (w * h * 3 // 2
    samples a frame) through fvvdp_video_source_yuv_array and
    predict_video_source: the kernel twice a block and twice for the
    temporal padding's indexed frames at an even size, the plain version at
    an odd one, the JOD of the CPU's either way."""
    w, h = size
    g = torch.Generator().manual_seed(11)
    fs = w * h * 3 // 2
    r = torch.randint(64, 941, (6, fs), generator=g, dtype=torch.int32)
    t = (r + torch.randint(-24, 25, r.shape, generator=g, dtype=torch.int32)).clamp(0, 1023)
    r, t = r.to(torch.int16), t.to(torch.int16)
    q = {}
    for dev in (cuda, torch.device("cpu")):
        metric = fv.fvvdp(display_name="standard_hdr_pq", device=dev)
        src = vsy.fvvdp_video_source_yuv_array(t, r, 30, w, h,
                                               display_photometry=metric.display_photometry,
                                               color_space_name="BT.2020", device=dev)
        _lib.reset_launch_counts()
        q[dev.type] = metric.predict_video_source(src)[0]
        if dev.type == "cuda":
            assert _lib.launch_counts()["yuv_luminance"] == (0 if w % 2 or h % 2 else 2 * 2)
    assert abs(q["cuda"] - q["cpu"]) <= 1e-4
