"""fovvideovdp_tpu_torch as a package: what it imports, where it runs, what
it refuses, and (on a CUDA card only) each hand-written kernel against its
plain PyTorch version.

The CPU tests need no JAX.  The ``gpu`` tests skip without a card; on the
card run them without the repo's JAX-pinning conftest:
``python -m pytest --noconftest -m gpu tests/test_torch_package.py``.
"""
import ast
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fvt
from fovvideovdp_tpu_torch import fvvdp
from fovvideovdp_tpu_torch.ops import cuda as cuda_ops
from fovvideovdp_tpu_torch.ops.cuda import _lib

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fovvideovdp_tpu_torch")
JAX_PKG = os.path.join(REPO, "fovvideovdp_tpu")
_FORBIDDEN = ("jax", "jaxlib", "fovvideovdp_tpu")


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in _FORBIDDEN


def _tiny_video(seed=0, shape=(40, 56, 1, 6)):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, size=shape, dtype=np.uint8)
    test = np.clip(ref.astype(np.int16) + rng.integers(-9, 9, size=shape),
                   0, 255).astype(np.uint8)
    return test, ref


def test_import_and_cpu_predict_load_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import fovvideovdp_tpu_torch as fvt\n"
        "rng = np.random.default_rng(0)\n"
        "ref = rng.integers(0, 256, size=(40, 56, 1, 6), dtype=np.uint8)\n"
        "test = np.clip(ref.astype(np.int16) + 5, 0, 255).astype(np.uint8)\n"
        "q, _ = fvt.fvvdp(display_name='standard_fhd', device='cpu').predict(\n"
        "    test, ref, dim_order='HWCF', frames_per_second=30)\n"
        "assert np.isfinite(q), q\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr


def test_package_sources_import_no_jax():
    offenders = []
    for root, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                offenders += [(path, n) for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fvvdp(display_name="standard_4k")


@pytest.mark.parametrize("fname", [
    "fvvdp_parameters.json", "display_models.json", "color_spaces.json",
    "csf_lut_o0_sn1_5_cm0_604562.npz", "csf_lut_o5_sn1_5_cm0_604562.npz"])
def test_data_copies_match_the_jax_package(fname):
    assert filecmp.cmp(os.path.join(PKG, "data", fname),
                       os.path.join(JAX_PKG, "data", fname), shallow=False)


@pytest.mark.parametrize("kwargs", [
    dict(do_temporal_channels=False),
    dict(ignore_boundary_pixels=True), dict(band_callback=print),
    dict(content_mapping=object()), dict(use_checkpoints=True),
    dict(foveated=True, content_mapping=object()),
    dict(heatmap="raw", ignore_boundary_pixels=True),
    dict(parameter_overrides={"local_adapt": "simple"}),
    dict(parameter_overrides={"local_adapt": "global"}),
    dict(parameter_overrides={"local_adapt": "gpyr2"}),
    dict(parameter_overrides={"contrast": "log"}),
    dict(parameter_overrides={"masking_model": "contrast_difference"}),
    dict(parameter_overrides={"masking_model": "contrast_difference_perc_norm"}),
    dict(parameter_overrides={"pu_dilate": 1.0}),
    dict(parameter_overrides={"csf_sigma": -2.0}),   # no shipped LUT
], ids=lambda kw: "-".join(f"{k}" for k in kw) + "-" + "-".join(
    f"{k}" for k in (kw.get("parameter_overrides") or {})))
def test_unsupported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fvvdp(device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,error", [
    (dict(heatmap="contours"), ValueError),
    (dict(heatmap_dtype="float32"), ValueError),
    (dict(heatmap="raw", heatmap_dtype="uint8"), ValueError),
    (dict(temp_padding="mirror"), ValueError),
], ids=["heatmap-type", "heatmap-dtype", "uint8-raw", "temp-padding"])
def test_constructor_rejects_bad_values(kwargs, error):
    with pytest.raises(error):
        fvvdp(device="cpu", **kwargs)


def test_unsupported_call_options_raise():
    fv = fvvdp(device="cpu")
    test, ref = _tiny_video()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fv.predict(test, ref, dim_order="HWCF", frames_per_second=30, mesh=object())
    # a per-frame fixation point (a moving gaze) scores, like the same point held
    fov = fvvdp(device="cpu", foveated=True)
    kw = dict(dim_order="HWCF", frames_per_second=30)
    q_moving, _ = fov.predict(test, ref, fixation_point=np.tile([20.0, 10.0], (6, 1)), **kw)
    q_fixed, _ = fov.predict(test, ref, fixation_point=np.array([20.0, 10.0]), **kw)
    assert np.isfinite(q_moving) and abs(q_moving - q_fixed) <= 1e-3
    vs = fvt.fvvdp_video_source_array(test, ref, 30, dim_order="HWCF",
                                      display_photometry=fv.display_photometry,
                                      device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fv.predict_video_source(vs, checkpoint_path="ckpt.npz")


@pytest.mark.parametrize("broken", ["non_uniform_Y", "unshared_Y"])
def test_luts_the_fused_scorer_cannot_take_raise(broken):
    """A non-uniform Y grid is refused; LUTs on different Y grids leave the
    fused scorer for the per-channel one (and score)."""
    fv = fvvdp(device="cpu")
    luts = [dict(l) for l in fv._luts]
    if broken == "non_uniform_Y":
        for l in luts:
            l["_uniform"] = dict(l["_uniform"], Y_log=False)
        fv.load_state(fv.parameters, luts)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fv._get_core(64, 48)
        return
    luts[1]["Y_log"] = luts[1]["Y_log"] + 0.5
    fv.load_state(fv.parameters, luts)
    core = fv._get_core(64, 48)
    assert not core._luts_share_Y and core.route == "banded"
    assert not core._score_tables and len(core._channel_tables) == core.plan.height
    test, ref = _tiny_video()
    q, _ = fv.predict(test, ref, dim_order="HWCF", frames_per_second=30)
    assert np.isfinite(q)


def test_cpu_run_leaves_launch_counts_at_zero():
    cuda_ops.reset_launch_counts()
    test, ref = _tiny_video()
    q, _ = fvvdp(display_name="standard_fhd", device="cpu", block_frames=4).predict(
        test, ref, dim_order="HWCF", frames_per_second=30)
    q_img, _ = fvvdp(device="cpu").predict(test[..., 0], ref[..., 0], dim_order="HWC")
    q_fov, _ = fvvdp(device="cpu", foveated=True, heatmap="raw").predict(
        test[..., 0], ref[..., 0], dim_order="HWC")
    assert np.isfinite(q) and np.isfinite(q_img) and np.isfinite(q_fov)
    assert cuda_ops.launch_counts() == {k: 0 for k in cuda_ops.KERNELS}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_lib, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.build()


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((2, 8, 8), dtype=torch.float64),
    lambda: torch.zeros((2, 1, 8), dtype=torch.float32),
    lambda: torch.zeros((2, 8, 8), dtype=torch.float32, device="meta"),
], ids=["float64", "H1", "meta-device"])
def test_reduce_wrapper_rejects_what_the_kernel_cannot_take(make):
    from fovvideovdp_tpu_torch.ops.cuda.reduce import gausspyr_reduce
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        gausspyr_reduce(make())


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, scale=80.0, offset=0.5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape, dtype=np.float32) * scale + offset)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4, 96, 256), (1, 4, 67, 131), (1, 4, 135, 240),
                                   (1, 4, 17, 30), (3, 2, 2), (1, 5, 3)])
def test_reduce_kernel_matches_plain(cuda, shape):
    from fovvideovdp_tpu_torch.ops.cuda.reduce import (gausspyr_reduce,
                                                       gausspyr_reduce_plain)
    x = _rand(shape, 1)
    got = gausspyr_reduce(x.to(cuda)).cpu()
    want = gausspyr_reduce_plain(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(96, 144), (67, 131), (160, 384), (17, 30), (2, 2)])
def test_expand_score2_kernel_matches_plain(cuda, hw):
    from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
    H, W = hw
    core = fvvdp(device=cuda)._get_core(max(W, 16), max(H, 16))
    fine = _rand((2, 4, H, W), 2).to(cuda)
    coarse = _rand((2, 4, -(-H // 2), -(-W // 2)), 3).to(cuda)
    for tables, meta in zip(core._score_tables, core._meta):
        got = bp.expand_score2(fine, coarse, tables, meta).cpu().double()
        want = bp.expand_score2_plain(fine, coarse, tables, meta).cpu().double()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        assert rel < 1e-4, rel


@pytest.mark.gpu
@pytest.mark.parametrize("fps,ncarry,nnew", [(30, 7, 9), (60, 14, 3), (30, 0, 20),
                                             (60, 0, 15)])
def test_temporal_kernel_matches_plain(cuda, fps, ncarry, nnew):
    from fovvideovdp_tpu_torch.ops import temporal as t
    from fovvideovdp_tpu_torch.ops.cuda.temporal import (temporal_pair,
                                                         temporal_pair_plain)
    taps = torch.as_tensor(t.temporal_filters(fps, t.filter_len_for_fps(fps)),
                           device=cuda)
    args = [_rand(s, k).to(cuda) for k, s in enumerate(
        [(ncarry, 33, 70), (nnew, 33, 70), (ncarry, 33, 70), (nnew, 33, 70)])]
    got = temporal_pair(*args, taps).cpu()
    want = temporal_pair_plain(*args, taps).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4, 96, 256), (1, 4, 67, 131), (3, 2, 37, 131),
                                   (1, 4, 17, 30), (1, 2, 2, 2), (2, 4, 135, 240)])
def test_expand_contrast_kernel_matches_plain(cuda, shape):
    from fovvideovdp_tpu_torch.ops.cuda.expand_contrast import (expand_contrast,
                                                                expand_contrast_plain)
    F, C, H, W = shape
    fine = _rand(shape, 4).to(cuda)
    coarse = _rand((F, C, -(-H // 2), -(-W // 2)), 5).to(cuda)
    for bkg in (0, 1):
        got_c, got_l = expand_contrast(fine, coarse, bkg)
        want_c, want_l = expand_contrast_plain(fine, coarse, bkg)
        assert got_l.shape == (F, 1, H, W)
        torch.testing.assert_close(got_c.cpu(), want_c.cpu(), rtol=2e-5, atol=1e-4)
        torch.testing.assert_close(got_l.cpu(), want_l.cpu(), rtol=1e-5, atol=1e-4)


def _band_inputs(F, h, w, n, device):
    rng = np.random.default_rng(6)
    band = torch.from_numpy((rng.standard_normal((F, 4, h, w)) * 0.05).astype(np.float32))
    band[0, 1, :2] = band[0, 0, :2]          # D(T, T) = 0
    band[0, 2, 2:4] = 0.0                    # min(|T|, |R|) = 0
    L = torch.from_numpy((10.0 ** rng.uniform(-1.3, 2.6, (F, h, w))).astype(np.float32))
    tabs_s = torch.from_numpy(rng.uniform(-5, 10, (n, h, w)).astype(np.float32))
    tabs_t = tabs_s + torch.from_numpy(rng.uniform(-1, 1, (n, h, w)).astype(np.float32))
    return [t.to(device) for t in (band, L, tabs_s, tabs_t)]


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("Fhw", [(2, 64, 256), (3, 37, 200), (40, 9, 13), (1, 1, 1),
                                 (33, 68, 120)])
def test_band_score_kernels_match_plain(cuda, Fhw):
    """band_score (channel views of the stack, no copy), band_score2 and
    band_score2_fov: per-frame sums within 1e-4 relative of the plain
    versions (the kernels score in log2 space, the plain ones with powers)."""
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    F, h, w = Fhw
    core = fvvdp(device=cuda)._get_core(64, 64)
    meta, tables = core._meta[1], core._score_tables[1]
    n = tables.shape[1]
    band, L, tabs_s, tabs_t = _band_inputs(F, h, w, n, cuda)
    for cc, q in enumerate((meta.q_s, meta.q_t)):
        T, R = band[:, 2 * cc], band[:, 2 * cc + 1]
        assert _rel(bs.band_score(T, R, L, tables[cc], meta, q),
                    bs.band_score_plain(T, R, L, tables[cc], meta, q)) < 1e-4
    assert _rel(bs.band_score2(band, L, tables, meta),
                bs.band_score2_plain(band, L, tables, meta)) < 1e-4
    assert _rel(bs.band_score2_fov(band, L, tabs_s, tabs_t, meta),
                bs.band_score2_fov_plain(band, L, tabs_s, tabs_t, meta)) < 2e-4


@pytest.mark.gpu
def test_band_score_wrappers_raise_on_cuda_tensors_they_cannot_take(cuda):
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    from fovvideovdp_tpu_torch.ops.cuda.expand_contrast import expand_contrast
    core = fvvdp(device=cuda)._get_core(64, 64)
    meta, tables = core._meta[0], core._score_tables[0]
    band, L, tabs_s, tabs_t = _band_inputs(2, 16, 24, tables.shape[1], cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bs.band_score2(band.transpose(2, 3), L.transpose(1, 2), tables, meta)
    with pytest.raises(ValueError, match="contiguous"):
        bs.band_score(band[:, 0, :, ::2], band[:, 1, :, ::2], L[:, :, ::2], tables[0],
                      meta, meta.q_s)
    with pytest.raises(ValueError):
        bs.band_score2_fov(band, L, tabs_s[:, :8], tabs_t[:, :8], meta)
    with pytest.raises(TypeError):
        expand_contrast(band.double(), band[:, :, ::2, ::2].double())


@pytest.mark.gpu
@pytest.mark.parametrize("content", ["video_uint8", "image_uint16"])
def test_card_predict_matches_cpu_and_counts_launches(cuda, content):
    if content == "video_uint8":
        test, ref = _tiny_video(shape=(67, 131, 3, 10))
        kw = dict(dim_order="HWCF", frames_per_second=30)
        launched = ("gausspyr_reduce", "expand_score2", "temporal_pair")
    else:
        g = np.load(os.path.join(REPO, "tests", "goldens", "image_path_uint16.npz"))
        test, ref = g["test"], g["ref"]
        kw = dict(dim_order="HWC")
        launched = ("gausspyr_reduce", "expand_score2")
    q_cpu, s_cpu = fvvdp(display_name="standard_fhd", device="cpu").predict(test, ref, **kw)
    cuda_ops.reset_launch_counts()
    q_gpu, s_gpu = fvvdp(display_name="standard_fhd", device=cuda,
                         block_frames=4).predict(test, ref, **kw)
    counts = cuda_ops.launch_counts()
    assert all(counts[k] > 0 for k in launched), counts
    assert abs(q_gpu - q_cpu) <= 1e-3
    # the kernel scores in log2 space where the plain version uses powers:
    # per-frame sums agree to ~1e-4 relative, Q_per_ch to its 1/beta power
    np.testing.assert_allclose(s_gpu["Q_per_ch"], s_cpu["Q_per_ch"], rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["foveated", "foveated_image", "heatmap",
                                   "per_channel_luts"])
def test_card_routes_match_cpu_and_launch_their_kernels(cuda, route):
    test, ref = _tiny_video(shape=(67, 131, 3, 10))
    kw = dict(dim_order="HWCF", frames_per_second=30)
    opts = dict(display_name="htc_vive_pro")
    launched, idle = ("expand_contrast",), ("expand_score2",)
    if route.startswith("foveated"):
        opts["foveated"] = True
        kw["fixation_point"] = np.array([30, 20])
        launched += ("band_score2_fov",)
        if route == "foveated_image":
            test, ref, kw = test[..., 0], ref[..., 0], dict(
                dim_order="HWC", fixation_point=np.array([30, 20]))
    elif route == "heatmap":
        opts["heatmap"] = "threshold"
    else:
        launched += ("band_score",)

    def metric(device, **extra):
        fv = fvvdp(device=device, **opts, **extra)
        if route == "per_channel_luts":
            luts = [dict(l) for l in fv._luts]
            luts[1] = dict(luts[1], Y=luts[1]["Y"][:-1], Y_log=luts[1]["Y_log"][:-1],
                           S_log=luts[1]["S_log"][:-1])
            fv.load_state(fv.parameters, luts)
        return fv

    q_cpu, s_cpu = metric("cpu").predict(test, ref, **kw)
    cuda_ops.reset_launch_counts()
    q_gpu, s_gpu = metric(cuda, block_frames=4).predict(test, ref, **kw)
    counts = cuda_ops.launch_counts()
    assert all(counts[k] > 0 for k in launched), counts
    assert all(counts[k] == 0 for k in idle), counts
    assert abs(q_gpu - q_cpu) <= 1e-3
    np.testing.assert_allclose(s_gpu["Q_per_ch"], s_cpu["Q_per_ch"], rtol=1e-3, atol=1e-5)
    if route == "heatmap":
        np.testing.assert_allclose(s_gpu["heatmap"].astype(np.float32),
                                   s_cpu["heatmap"].astype(np.float32), atol=5e-3)


def _mov_inputs(F, h, w, n_e, ny, nr, two, device, seed=8):
    """Synthetic inputs of the moving-gaze scorer: a sweeping gaze over a
    30 x 20 degree field, a smooth LUT plus noise."""
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
    rng = np.random.default_rng(seed)
    band = torch.from_numpy((rng.standard_normal((F, 4, h, w)) * 0.05).astype(np.float32))
    band[0, 1, :1] = band[0, 0, :1]            # D(T, T) = 0
    L = torch.from_numpy((10.0 ** rng.uniform(-1.3, 2.6, (F, h, w))).astype(np.float32))
    yy, xx = np.meshgrid(np.linspace(10, -10, h), np.linspace(-15, 15, w), indexing="ij")
    vd = torch.from_numpy(np.stack([xx, yy]).astype(np.float32))
    t_r = torch.from_numpy(rng.uniform(0, nr - 1, (h, w)).astype(np.float32))
    t_r[0, 0], t_r[-1, -1] = 0.0, float(nr - 1)          # both ends of the window
    gaze = torch.from_numpy(np.stack([np.linspace(-18, 18, F), np.linspace(12, -12, F)],
                                     axis=1).astype(np.float32))
    gaze[0] = vd[:, h // 2, w // 2]                      # ecc = 0 on a pixel
    e, y, r = np.meshgrid(np.arange(n_e), np.arange(ny), np.arange(nr), indexing="ij")
    V = (8.0 - 0.25 * e - 0.02 * (y - 8.0) ** 2 - 0.6 * r
         + rng.uniform(-0.2, 0.2, e.shape)).astype(np.float32).reshape(n_e, ny * nr)
    V2s = torch.from_numpy(V)
    V2t = torch.from_numpy(V + rng.uniform(-0.5, 0.5, V.shape).astype(np.float32)) \
        if two else None
    score = bs.ScoreMeta(y0=-7.0, dy=0.6, Ymin=2.0 ** -7, Ymax=2.0 ** (-7 + 0.6 * (ny - 1)),
                         p=2.4, q_s=3.2, q_t=3.1, c10=10.0 ** -0.5, corr=0.3, beta=0.96)
    meta = ms.MovMeta(score, es0=0.0, des=0.35, emin=0.0, emax=(0.35 * (n_e - 1)) ** 2,
                      ny=ny, nr=nr, off5=None if two else -0.8)
    args = [band, L, vd, t_r, gaze, V2s, V2t]
    return [a if a is None else a.to(device) for a in args] + [meta]


@pytest.mark.gpu
@pytest.mark.parametrize("two", [True, False], ids=["two_tables", "off5"])
@pytest.mark.parametrize("lut", [(32, 19, 4), (32, 32, 32), (5, 1, 1)],
                         ids=["shared", "global", "tiny"])
@pytest.mark.parametrize("Fhw", [(3, 64, 256), (40, 9, 13), (1, 37, 200), (33, 68, 120)])
def test_mov_score_kernel_matches_plain(cuda, Fhw, lut, two):
    """Every instance of mov_score (two tables or one with an offset; the LUT
    in shared or in global memory) within 2e-4 relative of the plain
    version, on whole planes, ragged ones, an image and more than one chunk
    of frames."""
    from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
    args = _mov_inputs(*Fhw, *lut, two, cuda)
    assert ms.lut_in_shared(lut[0], args[-1]) == (lut != (32, 32, 32))
    cuda_ops.reset_launch_counts()
    got = ms.band_score2_mov(*args)
    assert cuda_ops.launch_counts()["mov_score"] == 1
    want = ms.band_score2_mov_plain(*args)
    assert got.shape == (Fhw[0], 2) and bool(torch.isfinite(got).all())
    assert _rel(got, want) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["L_bkg", "gaze", "contrast"])
def test_scorers_keep_a_nan_on_the_card(cuda, bad):
    """NaN in, NaN out, for that frame only: the kernels as their plain
    versions."""
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
    args = _mov_inputs(3, 20, 50, 32, 19, 4, True, cuda)
    band, L, _, _, gaze = args[:5]
    if bad == "L_bkg":
        L[1, 3, 5] = float("nan")
    elif bad == "gaze":
        gaze[1, 1] = float("nan")
    else:
        band[1, 0, 2, 2] = float("nan")
    nan_at = torch.zeros((3, 2), dtype=torch.bool)
    nan_at[1, :1 if bad == "contrast" else 2] = True
    for got in (ms.band_score2_mov(*args), ms.band_score2_mov_plain(*args)):
        assert torch.equal(torch.isnan(got).cpu(), nan_at), got
    if bad != "gaze":
        m = args[-1].score
        tables = torch.linspace(1.0, 3.0, 38, device=cuda).reshape(2, 19)
        tabs = tables[0][:, None, None].expand(19, 20, 50).contiguous()
        for got in (bs.band_score2(band, L, tables, m), bs.band_score2_plain(band, L, tables, m),
                    bs.band_score2_fov(band, L, tabs, tabs, m)):
            assert torch.equal(torch.isnan(got).cpu(), nan_at), got


@pytest.mark.gpu
def test_mov_score_wrapper_raises_on_cuda_tensors_it_cannot_take(cuda):
    from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
    args = _mov_inputs(2, 16, 24, 32, 19, 4, True, cuda)
    for i in (0, 2, 3, 4, 5):
        bad = list(args)
        bad[i] = torch.cat([args[i], args[i]], dim=-1)[..., ::2]     # strided, same shape
        with pytest.raises(ValueError, match="contiguous"):
            ms.band_score2_mov(*bad)
    with pytest.raises(ValueError, match="is on"):
        ms.band_score2_mov(*args[:4], args[4].cpu(), *args[5:])


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["video", "image", "heatmap", "monotone_luts"])
def test_card_moving_gaze_matches_cpu_and_launches_its_kernel(cuda, route):
    test, ref = _tiny_video(shape=(67, 131, 3, 10))
    gaze = np.stack([np.linspace(0, 130, 10), np.linspace(66, -5, 10)], axis=1)
    kw = dict(dim_order="HWCF", frames_per_second=30, fixation_point=gaze)
    opts = dict(display_name="htc_vive_pro", foveated=True)
    if route == "image":
        test, ref, kw = test[..., 0], ref[..., 0], dict(dim_order="HWC",
                                                        fixation_point=gaze[3:4])
    elif route == "heatmap":
        opts["heatmap"] = "raw"

    def metric(device, **extra):
        fv = fvvdp(device=device, **opts, **extra)
        if route == "monotone_luts":
            luts = [dict(l, _uniform=dict(l["_uniform"], ecc_sqrt=False)) for l in fv._luts]
            fv.load_state(fv.parameters, luts)
        return fv

    q_cpu, s_cpu = metric("cpu").predict(test, ref, **kw)
    cuda_ops.reset_launch_counts()
    q_gpu, s_gpu = metric(cuda, block_frames=4).predict(test, ref, **kw)
    counts = cuda_ops.launch_counts()
    kernel_route = route in ("video", "image")
    assert counts["expand_contrast"] > 0 and counts["band_score2_fov"] == 0, counts
    assert (counts["mov_score"] > 0) == kernel_route, counts
    assert abs(q_gpu - q_cpu) <= 1e-3
    np.testing.assert_allclose(s_gpu["Q_per_ch"], s_cpu["Q_per_ch"], rtol=1e-3, atol=1e-5)
    if route == "heatmap":
        np.testing.assert_allclose(s_gpu["heatmap"].astype(np.float32),
                                   s_cpu["heatmap"].astype(np.float32), atol=5e-3)
