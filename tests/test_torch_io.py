"""fovvideovdp_tpu_torch's I/O helpers against the JAX package on the CPU:
the resize that matches ``jax.image.resize``, the fixed-point YUV decode,
the image loader on synthetic files, the .yuv file-name convention and the
packed-array source.

Bars: ``resize`` rtol 1e-5 (atol 1e-6 for outputs near 0, where a
different summation order leaves a few float32 ulps of [0, 1] values);
``yuv_to_rgb`` atol 1e-6; images bit for bit; luminance rtol 1e-5 on an
sRGB display; |dJOD| <= 1e-4 and Q_per_ch rtol 2e-3 / atol 2e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fovvideovdp_tpu as fv_jax
import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu import video_source as jax_vs
from fovvideovdp_tpu.io import RESIZE_METHODS as JAX_RESIZE_METHODS
from fovvideovdp_tpu.io import images as jax_images
from fovvideovdp_tpu.io import yuv as jax_yuv
from fovvideovdp_tpu.video_source_yuv import create_yuv_fname as jax_create
from fovvideovdp_tpu.video_source_yuv import decode_video_props as jax_decode
from fovvideovdp_tpu_torch import csf, state
from fovvideovdp_tpu_torch.io import RESIZE_METHODS, resize, weight_matrix
from fovvideovdp_tpu_torch.io import images as port_images
from fovvideovdp_tpu_torch.io import yuv as port_yuv
from fovvideovdp_tpu_torch.video_source_yuv import create_yuv_fname, decode_video_props

torch.set_num_threads(2)

JOD_BAR = 1e-4
GOLDEN_BAR = dict(rtol=2e-3, atol=2e-4)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _metrics(display):
    """A JAX metric and a port metric on the CPU with the JAX state carried across."""
    jm = fv_jax.fvvdp(display_name=display)
    pm = fv_port.fvvdp(display_name=display, device="cpu")
    params, luts = state.state_from_numpy(
        jm.parameters, [{k: np.asarray(l[k]) for k in csf.LUT_FIELDS} for l in jm._luts], "cpu")
    pm.load_state(params, luts)
    return jm, pm


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def test_resize_methods_match_the_jax_package():
    assert RESIZE_METHODS == JAX_RESIZE_METHODS


@pytest.mark.parametrize("method", ["nearest", "bilinear", "cubic", "linear"])
@pytest.mark.parametrize("in_hw,out_hw", [((17, 23), (34, 46)), ((48, 64), (20, 30)),
                                          ((8, 9), (17, 17)), ((33, 47), (33, 100)),
                                          ((54, 96), (108, 192)), ((31, 41), (12, 9))],
                         ids=["up2", "down", "up-odd", "width-only", "up2-even", "down-odd"])
def test_resize_matches_jax_image_resize(method, in_hw, out_hw):
    x = np.random.default_rng(0).random((2,) + in_hw, dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + out_hw, method=method))
    got = resize(torch.from_numpy(x), out_hw, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", ["linear", "cubic"])
def test_weight_matrix_is_jax_s(kernel):
    from jax._src.image import scale as jscale
    fill = jscale._fill_triangle_kernel if kernel == "linear" else jscale._fill_keys_cubic_kernel
    for m, n in ((23, 46), (64, 30), (47, 100), (7, 3)):
        want = np.asarray(jscale.compute_weight_mat(m, n, n / m, 0.0, fill, True))
        np.testing.assert_allclose(weight_matrix(m, n, kernel), want, rtol=0, atol=1e-7)


def test_resize_rejects_unknown_method():
    with pytest.raises(ValueError):
        resize(torch.zeros((4, 4)), (8, 8), "area")


@pytest.mark.parametrize("hw", [(32, 48), (33, 48), (32, 49), (35, 51)])
def test_upscale_chroma_matches_jax(hw):
    """The 4:2:0 chroma upscale, odd heights and widths included."""
    H, W = hw
    uv = np.random.default_rng(1).random((2, H // 2, W // 2), dtype=np.float32) - 0.5
    want = np.asarray(jax_yuv.upscale_chroma(jnp.asarray(uv), (H, W)))
    got = port_yuv.upscale_chroma(torch.from_numpy(uv), (H, W)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# fixed-point YUV
# ---------------------------------------------------------------------------

def _planes(bits, ss, H=32, W=48, seed=0):
    rng = np.random.default_rng(seed)
    d = 2 ** (bits - 8)
    dt = np.uint8 if bits == 8 else np.uint16
    uv = (H, W) if ss == "444" else (H // 2, W // 2)
    return (rng.integers(0, 256 * d, (H, W)).astype(dt),
            rng.integers(0, 256 * d, uv).astype(dt),
            rng.integers(0, 256 * d, uv).astype(dt))


@pytest.mark.parametrize("bits", [8, 10, 12])
def test_fixed2float_matches_jax_bit_for_bit(bits):
    Y, u, _ = _planes(bits, "444")
    np.testing.assert_array_equal(port_yuv.fixed2float_y(_t(Y), bits).numpy(),
                                  np.asarray(jax_yuv.fixed2float_y(jnp.asarray(Y), bits)))
    np.testing.assert_array_equal(port_yuv.fixed2float_uv(_t(u), bits).numpy(),
                                  np.asarray(jax_yuv.fixed2float_uv(jnp.asarray(u), bits)))


@pytest.mark.parametrize("bt2020", [False, True], ids=["709", "2020"])
@pytest.mark.parametrize("ss", ["420", "444"])
@pytest.mark.parametrize("bits", [8, 10, 12])
def test_yuv_to_rgb_matches_jax(bits, ss, bt2020):
    Y, u, v = _planes(bits, ss, seed=bits)
    want = np.asarray(jax_yuv.yuv_to_rgb(jnp.asarray(Y), jnp.asarray(u), jnp.asarray(v),
                                         bits, ss, bt2020))
    got = port_yuv.yuv_to_rgb(_t(Y), _t(u), _t(v), bits, ss, bt2020).numpy()
    assert got.shape == want.shape == (32, 48, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_yuv_matrices_are_the_jax_package_s():
    np.testing.assert_array_equal(port_yuv.YCBCR2RGB_REC709, jax_yuv.YCBCR2RGB_REC709)
    np.testing.assert_array_equal(port_yuv.YCBCR2RGB_REC2020, jax_yuv.YCBCR2RGB_REC2020)


# ---------------------------------------------------------------------------
# images, written here with cv2
# ---------------------------------------------------------------------------

@pytest.fixture
def images(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    png16 = (rng.random((43, 61, 3)) * 65535).astype(np.uint16)
    jpg = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    hdr = (rng.random((36, 52, 3)) * 40.0 + 0.01).astype(np.float32)
    gray = (rng.random((30, 20)) * 255).astype(np.uint8)
    paths = dict(png16=str(tmp_path / "deep.png"), jpg=str(tmp_path / "photo.jpg"),
                 hdr=str(tmp_path / "scene.hdr"), gray=str(tmp_path / "gray.png"))
    cv2.imwrite(paths["png16"], png16[:, :, ::-1])
    cv2.imwrite(paths["jpg"], jpg[:, :, ::-1])
    cv2.imwrite(paths["hdr"], hdr[:, :, ::-1])
    cv2.imwrite(paths["gray"], gray)
    return paths


@pytest.mark.parametrize("kind", ["png16", "jpg", "hdr", "gray"])
def test_load_image_matches_jax_bit_for_bit(images, kind):
    got = fv_port.load_image_as_array(images[kind])
    want = jax_images.load_image_as_array(images[kind])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_16bit_png_synthetic(images):
    img = port_images.load_image_as_array(images["png16"])
    assert img.dtype == np.uint16, "a 16-bit PNG must not be downconverted"
    assert img.shape == (43, 61, 3) and img.max() > 255


def test_load_jpeg_and_hdr_synthetic(images):
    img = port_images.load_image_as_array(images["jpg"])
    assert img.dtype == np.uint8 and img.shape == (40, 56, 3)
    hdr = port_images.load_image_as_array(images["hdr"])
    assert hdr.dtype == np.float32 and hdr.shape == (36, 52, 3)
    assert np.isfinite(hdr).all() and hdr.max() > 1.0


def test_builtin_radiance_reader_matches_jax(images):
    """The reader a machine without cv2 uses."""
    got = port_images._read_radiance_hdr(images["hdr"])
    np.testing.assert_array_equal(got, jax_images._read_radiance_hdr(images["hdr"]))
    np.testing.assert_allclose(got, fv_port.load_image_as_array(images["hdr"]), rtol=0, atol=0)


def test_image_loader_imports_no_media_package_at_import():
    import subprocess
    import sys
    code = ("import sys, fovvideovdp_tpu_torch.io.images\n"
            "print(sorted(m for m in ('cv2', 'PIL') if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__)))), timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# .yuv file names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["clip_1920x1080_10b_420_2020_24fps.yuv",
                                  "clip_1280x720p_8b_420_709_30fps.yuv",
                                  "a_64x48_12_444_bt709_23.976fps.yuv",
                                  "b_pq2020_3840x2160.yuv", "plain.yuv"])
def test_yuv_props_match_jax(name):
    props = decode_video_props(name)
    assert props == jax_decode(name)
    assert create_yuv_fname("clip", props) == jax_create("clip", props)


def test_yuv_props_roundtrip():
    props = decode_video_props("clip_1920x1080_10b_420_2020_24fps.yuv")
    assert props == dict(width=1920, height=1080, fps=24, bit_depth=10,
                         color_space="2020", chroma_ss="420")
    assert create_yuv_fname("clip", props) == "clip_1920x1080_10b_420_2020_24fps.yuv"


# ---------------------------------------------------------------------------
# the packed-array source
# ---------------------------------------------------------------------------

def _packed(seed, F, h, w, bits, ss, rh, rw, yuv=True):
    rng = np.random.default_rng(seed)
    d = 2 ** (bits - 8)
    dt = np.uint16
    if yuv:
        uv = h * w // 4 if ss == 420 else h * w
        body = [rng.integers(16 * d, 236 * d, h * w + 2 * uv) for _ in range(F)]
    else:
        dt = np.uint8 if bits == 8 else np.uint16
        body = [rng.integers(0, 256 * d, rh * rw * 3) for _ in range(F)]
    return np.concatenate([[F, h, w, bits, ss, rh, rw]] + body).astype(dt)


@pytest.mark.parametrize("case", [
    dict(bits=8, ss=420, rh=24, rw=32), dict(bits=10, ss=420, rh=24, rw=32),
    dict(bits=10, ss=444, rh=24, rw=32), dict(bits=8, ss=420, rh=40, rw=56),
    dict(bits=8, ss=420, rh=24, rw=32, yuv=False), dict(bits=16, ss=420, rh=24, rw=32, yuv=False),
], ids=["8b-420", "10b-420", "10b-444", "8b-420-resized", "rgb8", "rgb16"])
def test_packed_array_source_matches_jax(case):
    F, h, w = 5, 24, 32
    yuv = case.get("yuv", True)
    arrs = [_packed(s, F, h, w, case["bits"], case["ss"], case["rh"], case["rw"], yuv)
            for s in (0, 1)]
    jm, pm = _metrics("standard_fhd")
    js = jax_vs.fvvdp_video_source_packed_array(*arrs, 30.0, display_photometry="standard_fhd",
                                                yuv=yuv)
    ps = fv_port.fvvdp_video_source_packed_array(*arrs, 30.0, display_photometry="standard_fhd",
                                                 yuv=yuv, device="cpu")
    assert ps.get_video_size() == js.get_video_size() == (case["rh"], case["rw"], F)
    for i in (0, F - 1):
        want = np.asarray(js.get_test_frame(i))
        got = ps.get_test_frame(i).numpy()
        assert got.shape == want.shape == (1, 1, 1, case["rh"], case["rw"])
        np.testing.assert_allclose(got, want, rtol=1e-5)
    Q_j, s_j = jm.predict_video_source(js)
    Q_p, s_p = pm.predict_video_source(ps)
    assert abs(Q_p - Q_j) <= JOD_BAR
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], **GOLDEN_BAR)
