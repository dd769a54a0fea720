"""fovvideovdp_tpu_torch as a package: what it imports, where it runs, what
it refuses, and (on a CUDA card only) each hand-written kernel against its
plain PyTorch version.

The CPU tests need no JAX but two, which hold the options (the
``do_temporal_channels`` ablation, the ablations and options of the MATLAB
core, generated and non-uniform LUTs) to the JAX package and import it
inside the test.  The ``gpu`` tests skip without a card; on the
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


_MAPPING = "equirect"   # stands for each package's equirect content mapping


@pytest.mark.parametrize("kwargs", [
    dict(do_temporal_channels=False),
    dict(ignore_boundary_pixels=True), dict(band_callback=lambda *a: None),
    dict(content_mapping=_MAPPING),
    dict(foveated=True, content_mapping=_MAPPING),
    dict(heatmap="raw", ignore_boundary_pixels=True),
    dict(parameter_overrides={"local_adapt": "simple"}),
    dict(parameter_overrides={"local_adapt": "global"}),
    dict(parameter_overrides={"local_adapt": "gpyr2"}),
    dict(parameter_overrides={"contrast": "log"}),
    dict(parameter_overrides={"masking_model": "contrast_difference"}),
    dict(parameter_overrides={"masking_model": "contrast_difference_perc_norm"}),
    dict(parameter_overrides={"pu_dilate": 1.0}),
    dict(parameter_overrides={"csf_sigma": -2.0}),   # no shipped LUT: generated
], ids=lambda kw: "-".join(f"{k}" for k in kw) + "-" + "-".join(
    f"{k}" for k in (kw.get("parameter_overrides") or {})))
def test_unsupported_options_raise(kwargs):
    """The options ROADMAP queue 1 items 3 and 4 listed as missing, each of
    which once raised here, now score as the JAX package scores them (the
    ablation of do_temporal_channels since PR 9): |dJOD| <= 1e-4 and
    Q_per_ch at rtol 2e-3 / atol 2e-4, the heatmap at 2e-3."""
    import fovvideovdp_tpu as fv_jax        # the comparison needs JAX
    from fovvideovdp_tpu.content_mapping import fvvdp_content_mapping_equirect as jax_cm
    from fovvideovdp_tpu_torch.content_mapping import fvvdp_content_mapping_equirect
    test, ref = _tiny_video(shape=(40, 56, 3, 6))
    call = dict(dim_order="HWCF", frames_per_second=30)
    j_kw, p_kw = dict(kwargs), dict(kwargs)
    if kwargs.get("content_mapping") == _MAPPING:
        j_kw["content_mapping"] = jax_cm(56, 40)
        p_kw["content_mapping"] = fvvdp_content_mapping_equirect(56, 40)
    Q_p, s_p = fvvdp(device="cpu", **p_kw).predict(test, ref, **call)
    Q_j, s_j = fv_jax.fvvdp(**j_kw).predict(test, ref, **call)
    assert abs(Q_p - Q_j) <= 1e-4
    np.testing.assert_allclose(s_p["Q_per_ch"], np.asarray(s_j["Q_per_ch"]),
                               rtol=2e-3, atol=2e-4)
    if "do_temporal_channels" in kwargs:
        assert np.all(s_p["Q_per_ch"][:, 1] == 0)
    if "heatmap" in kwargs:
        np.testing.assert_allclose(s_p["heatmap"].astype(np.float32),
                                   np.asarray(s_j["heatmap"], np.float32), atol=2e-3)


@pytest.mark.parametrize("kwargs,error", [
    (dict(heatmap="contours"), ValueError),
    (dict(heatmap_dtype="float32"), ValueError),
    (dict(heatmap="raw", heatmap_dtype="uint8"), ValueError),
    (dict(temp_padding="mirror"), ValueError),
], ids=["heatmap-type", "heatmap-dtype", "uint8-raw", "temp-padding"])
def test_constructor_rejects_bad_values(kwargs, error):
    with pytest.raises(error):
        fvvdp(device="cpu", **kwargs)


def test_unsupported_call_options_raise(tmp_path):
    """``mesh``, which once raised here naming its ROADMAP item, streams
    the video over a mesh of CPU slots as one device scores it; a
    per-frame fixation point scores; a checkpoint path, which once raised
    here, scores as the run without one and leaves no file."""
    from fovvideovdp_tpu_torch.parallel import make_mesh
    fv = fvvdp(device="cpu")
    test, ref = _tiny_video()
    q_one, s_one = fv.predict(test, ref, dim_order="HWCF", frames_per_second=30)
    q_mesh, s_mesh = fv.predict(test, ref, dim_order="HWCF", frames_per_second=30,
                                mesh=make_mesh(["cpu"] * 3))
    np.testing.assert_allclose(q_mesh, q_one, rtol=1e-6, atol=0)
    np.testing.assert_allclose(s_mesh["Q_per_ch"], s_one["Q_per_ch"], rtol=1e-6, atol=0)
    # a per-frame fixation point (a moving gaze) scores, like the same point held
    fov = fvvdp(device="cpu", foveated=True)
    kw = dict(dim_order="HWCF", frames_per_second=30)
    q_moving, _ = fov.predict(test, ref, fixation_point=np.tile([20.0, 10.0], (6, 1)), **kw)
    q_fixed, _ = fov.predict(test, ref, fixation_point=np.array([20.0, 10.0]), **kw)
    assert np.isfinite(q_moving) and abs(q_moving - q_fixed) <= 1e-3
    vs = fvt.fvvdp_video_source_array(test, ref, 30, dim_order="HWCF",
                                      display_photometry=fv.display_photometry,
                                      device="cpu")
    ckpt = str(tmp_path / "ckpt.npz")
    q_ck, s_ck = fv.predict_video_source(vs, checkpoint_path=ckpt, checkpoint_every=1)
    q_plain, s_plain = fv.predict(test, ref, **kw)
    assert q_ck == q_plain and np.array_equal(s_ck["Q_per_ch"], s_plain["Q_per_ch"])
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("broken", ["non_uniform_Y", "unshared_Y"])
def test_luts_the_fused_scorer_cannot_take_raise(broken):
    """A Y grid flagged non-uniform leaves the kernels for the composed
    route and scores as the JAX package scores the same LUTs (it once
    raised here); LUTs on different Y grids leave the fused scorer for the
    per-channel one (and score)."""
    fv = fvvdp(device="cpu")
    luts = [dict(l) for l in fv._luts]
    if broken == "non_uniform_Y":
        import fovvideovdp_tpu as fv_jax     # the comparison needs JAX
        for l in luts:
            l["_uniform"] = dict(l["_uniform"], Y_log=False)
        fv.load_state(fv.parameters, luts)
        assert fv._get_core(56, 40).route == "composed"
        jm = fv_jax.fvvdp()
        jm._luts = tuple(dict(l, _uniform=dict(l["_uniform"], Y_log=False)) for l in jm._luts)
        test, ref = _tiny_video()
        call = dict(dim_order="HWCF", frames_per_second=30)
        (q, s), (q_j, s_j) = fv.predict(test, ref, **call), jm.predict(test, ref, **call)
        assert abs(q - q_j) <= 1e-4
        np.testing.assert_allclose(s["Q_per_ch"], np.asarray(s_j["Q_per_ch"]),
                                   rtol=2e-3, atol=2e-4)
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
                                   (1, 4, 17, 30), (3, 2, 2), (1, 5, 3), (2, 3, 50, 126),
                                   (1, 2, 270, 480), (1, 3, 5)])
@pytest.mark.parametrize("view", ["aligned", "offset"])
def test_reduce_kernel_matches_plain(cuda, shape, view):
    """Bit for bit on both arms: 16-byte loads where the width is a multiple
    of 4 and the input aligned, 4-byte loads on an odd width or a view 4
    bytes off a 16-byte boundary."""
    from fovvideovdp_tpu_torch.ops.cuda.reduce import (gausspyr_reduce,
                                                       gausspyr_reduce_plain, plan_for)
    x = _rand(shape, 1).to(cuda)
    if view == "offset":
        x = _offset_by_one_float(x)
    assert plan_for(x, torch.empty(0, device=cuda)).vec == (
        view == "aligned" and shape[-1] % 4 == 0)
    got = gausspyr_reduce(x)
    want = gausspyr_reduce_plain(x)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["vec", "warps", "col_blocks", "strips", "strip_rows"])
def test_reduce_entry_point_refuses_a_plan_that_contradicts_it(cuda, bad):
    """The C entry point checks the plan it is given: the vector arm on a
    view off a 16-byte boundary, a block of 5 warps, column blocks or strips
    that do not cover the level, a strip of no rows."""
    from fovvideovdp_tpu_torch.ops.cuda import reduce as red
    x = _rand((4, 67, 240), 2).to(cuda)
    if bad == "vec":
        x = _offset_by_one_float(x)
    y = torch.empty((4, 34, 120), device=cuda)
    plan = red.plan_for(x, y)
    plan = plan._replace(**{"vec": dict(vec=True), "warps": dict(warps_per_block=5),
                            "col_blocks": dict(col_blocks=plan.col_blocks + 1),
                            "strips": dict(strips=plan.strips - 1),
                            "strip_rows": dict(strip_rows=0)}[bad])
    rc = _lib.kernel_fn("gausspyr_reduce")(x.data_ptr(), y.data_ptr(), 4, 67, 240,
                                           int(plan.vec), *plan[1:], _lib.stream_ptr(x))
    assert rc != 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float16, torch.float32])
@pytest.mark.parametrize("chunk_bytes", [1000, 1 << 20])
def test_staged_upload_gives_the_pageable_upload_bytes(cuda, dtype, chunk_bytes):
    """Pinned staging buffers on a side stream, in many chunks and in one:
    the same bytes as a plain pageable copy, visible to the compute stream
    as soon as the call returns."""
    from fovvideovdp_tpu_torch import video_source as vsrc
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.integers(0, 255, size=(3, 5, 37, 61)).astype(np.uint8))
    src = src.to(dtype) if dtype != torch.int16 else (src.to(torch.int16) * 257 - 30000)
    dst = torch.empty(src.shape, dtype=dtype, device=cuda)
    vsrc._staged_copy(dst, src, chunk_bytes)
    assert torch.equal(dst.cpu(), src)
    hwcf = src.permute(2, 3, 0, 1).contiguous()
    assert torch.equal(vsrc._upload_cfhw(hwcf.numpy(), "HWCF", cuda), src.to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dim_order", ["HWCF", "BCFHW"])
def test_card_host_resident_path_matches_resident(cuda, monkeypatch, dim_order):
    """The raw pair on the host, each block through the staging buffers on a
    side stream, the next block's copy in flight during this one's scoring:
    Q_per_ch equal to the resident path's bit for bit."""
    test, ref = _tiny_video(shape=(40, 56, 3, 9))
    if dim_order == "BCFHW":
        test, ref = (np.ascontiguousarray(x.transpose(2, 3, 0, 1))[None] for x in (test, ref))
    fv = fvvdp(display_name="standard_fhd", device=cuda, block_frames=2)
    call = dict(dim_order=dim_order, frames_per_second=30)
    _, s_res = fv.predict(test, ref, **call)
    monkeypatch.setattr(fvt.fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES", 0)
    _, s_host = fv.predict(test, ref, **call)
    np.testing.assert_array_equal(s_host["Q_per_ch"], s_res["Q_per_ch"])


@pytest.mark.gpu
@pytest.mark.parametrize("frames_on", ["cuda", "cpu"])
def test_card_scores_a_per_frame_source(cuda, frames_on):
    """A source with only the per-frame methods goes through the kernels.
    Frames decoded on the card give the array source's scores bit for bit;
    frames decoded on the host (the CPU's EOTF) agree as the CPU run does."""
    test, ref = _tiny_video()
    fv = fvvdp(display_name="standard_fhd", device=cuda)
    inner = fvt.fvvdp_video_source_array(test, ref, 30, dim_order="HWCF",
                                         display_photometry=fv.display_photometry,
                                         device=cuda if frames_on == "cuda" else "cpu")

    class Frames(fvt.fvvdp_video_source):
        get_video_size = inner.get_video_size
        get_frames_per_second = inner.get_frames_per_second
        get_test_frame = inner.get_test_frame
        get_reference_frame = inner.get_reference_frame

    cuda_ops.reset_launch_counts()
    q, s = fv.predict_video_source(Frames())
    assert cuda_ops.launch_counts()["gausspyr_reduce"] > 0
    q_arr, s_arr = fv.predict(test, ref, dim_order="HWCF", frames_per_second=30)
    if frames_on == "cuda":
        np.testing.assert_array_equal(s["Q_per_ch"], s_arr["Q_per_ch"])
    else:
        assert abs(q - q_arr) <= 1e-3
        np.testing.assert_allclose(s["Q_per_ch"], s_arr["Q_per_ch"], rtol=1e-3, atol=1e-5)


def _offset_by_one_float(t):
    """The same values in storage that starts 4 bytes past a 16-byte
    boundary: contiguous, but no 16-byte load of it is aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(96, 144), (67, 131), (160, 384), (17, 30), (2, 2),
                                (135, 240), (33, 516), (16, 129)])
def test_expand_score2_kernel_matches_plain(cuda, hw):
    """Both arms: 16-byte loads where W % 4 == 0 (whole tiles, ragged tiles,
    an odd H), 4-byte loads elsewhere."""
    from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
    H, W = hw
    core = fvvdp(device=cuda)._get_core(max(W, 16), max(H, 16))
    fine = _rand((2, 4, H, W), 2).to(cuda)
    coarse = _rand((2, 4, -(-H // 2), -(-W // 2)), 3).to(cuda)
    assert bp.plan_for(fine, coarse, core._score_tables[0]).vec == (W % 4 == 0)
    for tables, meta in zip(core._score_tables, core._meta):
        got = bp.expand_score2(fine, coarse, tables, meta).cpu().double()
        want = bp.expand_score2_plain(fine, coarse, tables, meta).cpu().double()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        assert rel < 1e-4, rel


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(96, 144), (135, 240)])
def test_expand_score2_unaligned_fine_takes_the_scalar_arm(cuda, hw):
    """A fine level whose first element is not on a 16-byte boundary: the
    scalar arm, with the vector arm's sums (the arms differ in their loads
    only) and the image path's exact zero."""
    from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
    H, W = hw
    core = fvvdp(device=cuda)._get_core(W, H)
    tables, meta = core._score_tables[0], core._meta[0]
    fine = _rand((2, 4, H, W), 2).to(cuda)
    fine[:, 2:] = 0.0
    coarse = _rand((2, 4, -(-H // 2), -(-W // 2)), 3).to(cuda)
    coarse[:, 2:] = 0.0
    shifted = _offset_by_one_float(fine)
    assert bp.plan_for(fine, coarse, tables).vec
    assert not bp.plan_for(shifted, coarse, tables).vec
    cuda_ops.reset_launch_counts()
    got = bp.expand_score2(shifted, coarse, tables, meta)
    assert cuda_ops.launch_counts()["expand_score2"] == 1
    assert torch.equal(got, bp.expand_score2(fine, coarse, tables, meta))
    assert bool((got[:, 1] == 0.0).all())
    assert _rel(got, bp.expand_score2_plain(fine, coarse, tables, meta)) < 1e-4


@pytest.mark.gpu
def test_expand_score2_keeps_a_nan_on_the_card(cuda):
    from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
    core = fvvdp(device=cuda)._get_core(144, 96)
    tables, meta = core._score_tables[0], core._meta[0]
    fine = _rand((3, 4, 96, 144), 2).to(cuda)
    coarse = _rand((3, 4, 48, 72), 3).to(cuda)
    fine[1, 0, 5, 7] = float("nan")
    nan_at = torch.zeros((3, 2), dtype=torch.bool)
    nan_at[1, 0] = True
    for got in (bp.expand_score2(fine, coarse, tables, meta),
                bp.expand_score2_plain(fine, coarse, tables, meta)):
        assert torch.equal(torch.isnan(got).cpu(), nan_at), got


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
                                 (33, 68, 120), (2, 45, 50), (3, 67, 131), (33, 520, 520)])
def test_band_score_kernels_match_plain(cuda, Fhw):
    """band_score (channel views of the stack, no copy), band_score2 and
    band_score2_fov: per-frame sums within 1e-4 relative of the plain
    versions (the kernels score in log2 space, the plain ones with powers),
    on the vector arm where h * w is a multiple of 4, else the scalar arm;
    the last shape has blocks enough for one group of 33 frames, two chunks
    of the frame sums."""
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    F, h, w = Fhw
    core = fvvdp(device=cuda)._get_core(64, 64)
    meta, tables = core._meta[1], core._score_tables[1]
    n = tables.shape[1]
    band, L, tabs_s, tabs_t = _band_inputs(F, h, w, n, cuda)
    assert bs.plan_for("band_score2", (("band", band), ("L_bkg", L)))[0].vec == (h * w % 4 == 0)
    cuda_ops.reset_launch_counts()
    for cc, q in enumerate((meta.q_s, meta.q_t)):
        T, R = band[:, 2 * cc], band[:, 2 * cc + 1]
        assert _rel(bs.band_score(T, R, L, tables[cc], meta, q),
                    bs.band_score_plain(T, R, L, tables[cc], meta, q)) < 1e-4
    assert _rel(bs.band_score2(band, L, tables, meta),
                bs.band_score2_plain(band, L, tables, meta)) < 1e-4
    assert _rel(bs.band_score2_fov(band, L, tabs_s, tabs_t, meta),
                bs.band_score2_fov_plain(band, L, tabs_s, tabs_t, meta)) < 2e-4
    counts = cuda_ops.launch_counts()
    assert (counts["band_score"], counts["band_score2"], counts["band_score2_fov"]) == (2, 1, 1)


def _band_views(band, L, view):
    """The same values as a view the vector arm cannot load 16 bytes at a
    time: the band 4 bytes off a 16-byte boundary, L_bkg the same or at a
    frame stride off a multiple of 4."""
    if view == "band_offset":
        return _offset_by_one_float(band), L
    if view == "L_offset":
        return band, _offset_by_one_float(L)
    F, h, w = L.shape
    rows = torch.empty((F, h * w + 2), dtype=L.dtype, device=L.device)
    strided = rows[:, :h * w].view(F, h, w)
    strided.copy_(L)
    return band, strided


@pytest.mark.gpu
@pytest.mark.parametrize("Fhw", [(3, 36, 200), (33, 68, 120)])
@pytest.mark.parametrize("view", ["band_offset", "L_offset", "L_stride"])
def test_band_scorers_scalar_arm_gives_the_vector_arms_sums(cuda, view, Fhw):
    """The arms differ in their loads only: a view off the vector arm's
    alignment takes the scalar arm and gives its sums bit for bit, for every
    entry point; a channel of the (F, 4, h, w) stack stays on the vector
    arm."""
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    core = fvvdp(device=cuda)._get_core(64, 64)
    meta, tables = core._meta[1], core._score_tables[1]
    band, L, tabs_s, tabs_t = _band_inputs(*Fhw, tables.shape[1], cuda)
    vband, vL = _band_views(band, L, view)
    T, R = band[:, 2], band[:, 3]
    assert bs.plan_for("band_score", (("T", T), ("R", R), ("L_bkg", L)))[0].vec
    assert not bs.plan_for("band_score",
                           (("T", vband[:, 2]), ("R", vband[:, 3]), ("L_bkg", vL)))[0].vec
    assert not bs.plan_for("band_score2_fov", (("band", vband), ("L_bkg", vL)), 19)[0].vec
    pairs = [
        (bs.band_score(T, R, L, tables[1], meta, meta.q_t),
         bs.band_score(vband[:, 2], vband[:, 3], vL, tables[1], meta, meta.q_t),
         bs.band_score_plain(T, R, L, tables[1], meta, meta.q_t), 1e-4),
        (bs.band_score2(band, L, tables, meta), bs.band_score2(vband, vL, tables, meta),
         bs.band_score2_plain(band, L, tables, meta), 1e-4),
        (bs.band_score2_fov(band, L, tabs_s, tabs_t, meta),
         bs.band_score2_fov(vband, vL, tabs_s, tabs_t, meta),
         bs.band_score2_fov_plain(band, L, tabs_s, tabs_t, meta), 2e-4),
    ]
    for vec, scalar, plain, tol in pairs:
        assert torch.equal(scalar, vec)
        assert _rel(scalar, plain) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 19, 64])
@pytest.mark.parametrize("Fhw", [(3, 36, 200), (2, 45, 50)])
def test_band_score2_fov_takes_every_table_size(cuda, Fhw, n):
    """Per-pixel tables of 1 to 64 knots: the block shrinks as the tables
    grow (1,024 pixels at n = 1, 512 at 19, 128 at 64), on both arms."""
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    core = fvvdp(device=cuda)._get_core(64, 64)
    meta = core._meta[1]
    F, h, w = Fhw
    band, L, tabs_s, tabs_t = _band_inputs(F, h, w, n, cuda)
    # a log2 Y grid of n knots over the inputs' luminance range
    Y_log = np.linspace(np.log2(0.01), np.log2(10.0 ** 3.5), n)
    meta = meta._replace(y0=float(Y_log[0]),
                         dy=float(Y_log[-1] - Y_log[0]) / (n - 1) if n > 1 else 1.0,
                         Ymin=0.01, Ymax=10.0 ** 3.5)
    plan = bs.plan_for("band_score2_fov", (("band", band), ("L_bkg", L)), n)[0]
    assert plan.block_pixels == {1: 1024, 19: 512, 64: 128}[n]
    assert plan.vec == (h * w % 4 == 0)
    assert _rel(bs.band_score2_fov(band, L, tabs_s, tabs_t, meta),
                bs.band_score2_fov_plain(band, L, tabs_s, tabs_t, meta)) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(36, 200), (45, 50)])
def test_band_scorers_sum_a_zero_channel_to_exactly_0(cuda, hw):
    """An image (F = 1) with zero transient contrast, as the image path
    gives it: that channel's sum is exactly 0 on every entry point (lg2(0)
    = -inf, ex2(-inf) = 0), the sustained one agrees with the plain
    version."""
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    core = fvvdp(device=cuda)._get_core(64, 64)
    meta, tables = core._meta[1], core._score_tables[1]
    band, L, tabs_s, tabs_t = _band_inputs(1, *hw, tables.shape[1], cuda)
    band[:, 2:] = 0.0
    zero = bs.band_score(band[:, 2], band[:, 3], L, tables[1], meta, meta.q_t)
    assert bool((zero == 0.0).all())
    for got, want in ((bs.band_score2(band, L, tables, meta),
                       bs.band_score2_plain(band, L, tables, meta)),
                      (bs.band_score2_fov(band, L, tabs_s, tabs_t, meta),
                       bs.band_score2_fov_plain(band, L, tabs_s, tabs_t, meta))):
        assert bool((got[:, 1] == 0.0).all()) and bool((want[:, 1] == 0.0).all())
        assert _rel(got[:, 0], want[:, 0]) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["block_pixels", "n_blocks", "groups", "vec", "smem"])
def test_band_score2_fov_entry_point_refuses_a_plan_that_contradicts_it(cuda, bad):
    """The C entry point checks the plan it is given: a block it does not
    take, blocks or groups that do not cover the plane and the frames, the
    vector arm on a view off a 16-byte boundary, tables too large for a
    block of that size."""
    from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
    core = fvvdp(device=cuda)._get_core(64, 64)
    meta = core._meta[1]
    n = 64 if bad == "smem" else 19
    band, L, tabs_s, tabs_t = _band_inputs(3, 36, 200, n, cuda)
    if bad == "vec":
        band = _offset_by_one_float(band)
    plan, strides = bs.plan_for("band_score2_fov", (("band", band), ("L_bkg", L)), n)
    plan = plan._replace(**{"block_pixels": dict(block_pixels=1000),
                            "n_blocks": dict(n_blocks=plan.n_blocks + 1),
                            "groups": dict(groups=plan.groups + 1),
                            "vec": dict(vec=True),
                            "smem": dict(block_pixels=1024, n_blocks=-(-7200 // 1024))}[bad])
    partials, out = bs._out(plan, 3, cuda)
    rc = _lib.kernel_fn("band_score2_fov")(
        band.data_ptr(), L.data_ptr(), tabs_s.data_ptr(), tabs_t.data_ptr(),
        partials.data_ptr(), out.data_ptr(), 3, 7200, strides[-1], n, int(plan.vec),
        *plan[1:], *bs._kernel_scalars(meta, meta.q_s, meta.q_t), _lib.stream_ptr(band))
    assert rc != 0


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["images", "clips", "streamed_clips", "shared_gaze",
                                  "gaze_per_pair", "ablation", "host_images", "host_clips",
                                  "host_streamed_clips", "host_ablation"])
def test_card_batch_matches_cpu_and_launches_its_kernels(cuda, case, monkeypatch):
    """predict_batch and the do_temporal_channels=False ablation on the card
    against device="cpu", each with the kernels its route launches: whole
    clips launch temporal_pair once per clip (an empty carry), streamed ones
    once per block.  The host_ cases keep the raw frames on the host (the
    array source's residency limit at 0): a batch goes up a chunk of pairs
    at a time, the ablation's frames a chunk at a time through the pinned
    staging buffers, the next chunk prefetched."""
    host = case.startswith("host_")
    case = case[len("host_"):] if host else case
    if host:
        monkeypatch.setattr(fvt.fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES", 0)
    test, ref = _tiny_video(shape=(67, 131, 3, 10))
    batch_t = np.stack([test, np.roll(test, 5, axis=1), ref])
    batch_r = np.stack([ref, ref, np.roll(ref, 3, axis=0)])
    opts, kw = dict(display_name="standard_fhd"), dict(dim_order="BHWC")
    launched, idle = ("gausspyr_reduce", "expand_score2"), ("temporal_pair", "mov_score")
    if case.endswith("clips"):
        kw = dict(dim_order="BHWCF", frames_per_second=30)
        launched, idle = launched + ("temporal_pair",), ("expand_contrast",)
        if case == "streamed_clips":
            opts["block_frames"] = 4
    else:
        batch_t, batch_r = batch_t[..., 0], batch_r[..., 0]
    if case in ("shared_gaze", "gaze_per_pair"):
        opts["foveated"] = True
        kw["fixation_point"] = np.array([30, 20]) if case == "shared_gaze" \
            else np.array([[30, 20], [100, 60], [0, 0]])
        launched = ("expand_contrast",) + (
            ("band_score2_fov",) if case == "shared_gaze" else ("mov_score",))
        idle = ("expand_score2",) + (
            ("mov_score",) if case == "shared_gaze" else ("band_score2_fov",))
    if host and case in ("images", "ablation"):
        opts["block_frames"] = 2                    # several chunks
    if case == "ablation":
        opts["do_temporal_channels"] = False
        cuda_ops.reset_launch_counts()
        q_gpu, s_gpu = fvvdp(device=cuda, **opts).predict(test, ref, dim_order="HWCF",
                                                           frames_per_second=30)
        counts = cuda_ops.launch_counts()
        q_cpu, s_cpu = fvvdp(device="cpu", **opts).predict(test, ref, dim_order="HWCF",
                                                           frames_per_second=30)
        assert np.all(s_gpu["Q_per_ch"][:, 1] == 0)
        q_gpu, q_cpu = np.array([q_gpu]), np.array([q_cpu])
    else:
        q_cpu, s_cpu = fvvdp(device="cpu", **opts).predict_batch(batch_t, batch_r, **kw)
        cuda_ops.reset_launch_counts()
        q_gpu, s_gpu = fvvdp(device=cuda, **opts).predict_batch(batch_t, batch_r, **kw)
        counts = cuda_ops.launch_counts()
    assert all(counts[k] > 0 for k in launched), counts
    assert all(counts[k] == 0 for k in idle), counts
    if case == "clips":
        assert counts["temporal_pair"] == 3
    if case == "streamed_clips":
        assert counts["temporal_pair"] == 3 * 3
    np.testing.assert_allclose(q_gpu, q_cpu, rtol=0, atol=1e-3)
    if "Q_per_ch" in s_cpu:
        np.testing.assert_allclose(s_gpu["Q_per_ch"], s_cpu["Q_per_ch"], rtol=1e-3, atol=1e-5)


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
@pytest.mark.parametrize("Fhw", [(3, 64, 256), (40, 9, 13), (1, 37, 200), (33, 68, 120),
                                 (2, 67, 131), (1, 1, 1)])
def test_mov_score_kernel_matches_plain(cuda, Fhw, lut, two):
    """Every instance of mov_score (two tables or one with an offset; the LUT
    in shared or in global memory; 16-byte loads where h * w is a multiple of
    4, else 4-byte loads) within 2e-4 relative of the plain version, on whole
    planes, ragged ones, an image and more than one chunk of frames."""
    from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
    args = _mov_inputs(*Fhw, *lut, two, cuda)
    assert ms.lut_in_shared(lut[0], args[-1]) == (lut != (32, 32, 32))
    assert ms.plan_for(*args[:5], [("V2s", args[5])])[0].vec == (Fhw[1] * Fhw[2] % 4 == 0)
    cuda_ops.reset_launch_counts()
    got = ms.band_score2_mov(*args)
    assert cuda_ops.launch_counts()["mov_score"] == 1
    want = ms.band_score2_mov_plain(*args)
    assert got.shape == (Fhw[0], 2) and bool(torch.isfinite(got).all())
    assert _rel(got, want) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("two", [True, False], ids=["two_tables", "off5"])
@pytest.mark.parametrize("lut", [(32, 19, 4), (32, 32, 32)], ids=["shared", "global"])
@pytest.mark.parametrize("view", ["L_offset", "L_stride", "band_offset", "L_channel"])
def test_mov_score_views_choose_the_arm(cuda, view, lut, two):
    """Views the vector arm cannot load 16 bytes at a time take the scalar
    arm and give the vector arm's sums (the arms differ in their loads
    only); a channel of a (F, C, h, w) stack stays on the vector arm."""
    from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
    args = _mov_inputs(5, 36, 200, *lut, two, cuda)
    band, L = args[0], args[1]
    F, h, w = L.shape
    want = ms.band_score2_mov(*args)
    assert ms.plan_for(band, L, *args[2:5], [("V2s", args[5])])[0].vec
    if view == "L_offset":
        args[1] = _offset_by_one_float(L)
    elif view == "L_stride":
        rows = torch.empty((F, h * w + 2), dtype=L.dtype, device=cuda)
        args[1] = rows[:, :h * w].view(F, h, w)
        args[1].copy_(L)
    elif view == "band_offset":
        args[0] = _offset_by_one_float(band)
    else:
        stack = torch.zeros((F, 3, h, w), dtype=L.dtype, device=cuda)
        stack[:, 1] = L
        args[1] = stack[:, 1]
    vec = ms.plan_for(*args[:5], [("V2s", args[5])])[0].vec
    assert vec == (view == "L_channel")
    got = ms.band_score2_mov(*args)
    assert torch.equal(got, want)
    assert _rel(got, ms.band_score2_mov_plain(*args)) < 2e-4


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
        for b, l in ((band, L), _band_views(band, L, "band_offset")):
            for got in (bs.band_score2(b, l, tables, m), bs.band_score2_plain(b, l, tables, m),
                        bs.band_score2_fov(b, l, tabs, tabs, m)):
                assert torch.equal(torch.isnan(got).cpu(), nan_at), got
            # one channel at a time: the channel's own NaN only
            for cc in range(2):
                got = bs.band_score(b[:, 2 * cc], b[:, 2 * cc + 1], l, tables[cc], m,
                                    (m.q_s, m.q_t)[cc])
                assert torch.equal(torch.isnan(got).cpu(), nan_at[:, cc]), got


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


# ---------------------------------------------------------------------------
# On the card: the file sources and the native reader
# ---------------------------------------------------------------------------

def _write_yuv(path, bits, seed, h=48, w=64, frames=6):
    rng = np.random.RandomState(seed)
    d = 2 ** (bits - 8)
    dt = np.uint8 if bits == 8 else np.uint16
    with open(path, "wb") as f:
        for _ in range(frames):
            f.write(rng.randint(16 * d, 236 * d, (h, w)).astype(dt).tobytes())
            f.write(rng.randint(16 * d, 241 * d, (2, h // 2, w // 2)).astype(dt).tobytes())
    return str(path)


@pytest.mark.gpu
def test_native_reader_fills_a_pinned_buffer(cuda, tmp_path):
    from fovvideovdp_tpu_torch import native
    path = _write_yuv(tmp_path / "clip_64x48_10b_420_709_30fps.yuv", 10, 0)
    frames = np.fromfile(path, dtype=np.uint16).reshape(6, -1)
    r = native.NativeYuvReader(path, 64, 48, 10, "420")
    buf = torch.empty(6 * r.frame_bytes, dtype=torch.uint8, pin_memory=True)
    assert buf.is_pinned()
    r.read_block(0, 6, out=buf)
    dev = buf.to(cuda, non_blocking=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(dev.cpu().numpy().view(np.uint16).reshape(6, -1), frames)
    r.close()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [(8, "709", "standard_fhd", None),
                                 (10, "2020", "standard_hdr_pq", "bicubic")],
                         ids=["8b-709", "10b-pq-resized"])
def test_yuv_source_on_the_card_matches_the_cpu(cuda, tmp_path, fmt):
    """Luminance blocks at rtol 1e-4, JOD at 1e-4, the default route's kernels
    launched, and the blocks served through the prefetch in any block size."""
    from fovvideovdp_tpu_torch.video_source_yuv import fvvdp_video_source_yuv_file
    bits, space, display, resize = fmt
    names = [_write_yuv(tmp_path / f"{t}_64x48_{bits}b_420_{space}_30fps.yuv", bits, k)
             for k, t in enumerate(("test", "ref"))]
    kw = dict(display_photometry=display, full_screen_resize=resize, resize_resolution=(96, 72))
    card = fvvdp_video_source_yuv_file(*names, device=cuda, **kw)
    cpu = fvvdp_video_source_yuv_file(*names, device="cpu", **kw)
    for a, b in zip(card.get_luminance_block(0, 3), cpu.get_luminance_block(0, 3)):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4)
    for a, b in zip(card.get_indexed_luminance_block([5, 0, 5]),
                    cpu.get_indexed_luminance_block([5, 0, 5])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4)
    q_cpu, _ = fvvdp(display_name=display, device="cpu").predict_video_source(
        fvvdp_video_source_yuv_file(*names, device="cpu", **kw))
    for block in (2, 4, None):
        cuda_ops.reset_launch_counts()
        q_card, _ = fvvdp(display_name=display, device=cuda, block_frames=block
                          ).predict_video_source(
            fvvdp_video_source_yuv_file(*names, device=cuda, **kw))
        counts = cuda_ops.launch_counts()
        assert all(counts[k] > 0 for k in ("temporal_pair", "gausspyr_reduce",
                                          "expand_score2")), counts
        assert abs(q_card - q_cpu) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("preload", [False, True])
def test_pipe_source_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch, preload):
    import json
    import stat
    from fovvideovdp_tpu_torch.video_source_file import fvvdp_video_source_file
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, body in (
            ("ffprobe", "import sys\nprint(open(sys.argv[-1] + '.probe.json').read())\n"),
            ("ffmpeg", "import sys\npath = sys.argv[sys.argv.index('-i') + 1]\n"
                       "sys.stdout.buffer.write(open(path, 'rb').read())\n")):
        exe = bindir / name
        exe.write_text(f"#!{sys.executable}\n{body}")
        os.chmod(exe, os.stat(exe).st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    vids = []
    for k, tag in enumerate(("tst", "ref")):
        vid = _write_yuv(tmp_path / f"{tag}.mp4", 8, k)
        (tmp_path / f"{tag}.mp4.probe.json").write_text(json.dumps({"streams": [{
            "codec_type": "video", "width": 64, "height": 48, "pix_fmt": "yuv420p",
            "nb_frames": "6", "r_frame_rate": "30/1"}]}))
        vids.append(vid)
    q = {}
    for dev in (cuda, "cpu"):
        vs = fvvdp_video_source_file(*vids, display_photometry="standard_fhd", device=dev,
                                     preload=preload)
        q[str(dev)] = fvvdp(display_name="standard_fhd", device=dev,
                            block_frames=4).predict_video_source(vs)[0]
    assert abs(q["cuda"] - q["cpu"]) <= 1e-4
