"""Heatmaps of fovvideovdp_tpu_torch end to end on the CPU, against the
reference goldens (inputs and bars of tests/test_metric_e2e.py:20-119) and
against the JAX package's ``predict``.
"""
import numpy as np
import pytest
import torch

import fovvideovdp_tpu as fv_jax
import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu_torch import memory

torch.set_num_threads(2)

JOD_TOL = 0.01


def _f32(h):
    return np.asarray(h).astype(np.float32)


def test_image_raw_heatmap_matches_golden(goldens):
    g = goldens("image_path_uint8")
    fv = fv_port.fvvdp(display_name="standard_4k", heatmap="raw", device="cpu")
    Q, stats = fv.predict(g["test"], g["ref"], dim_order="HWC")
    assert abs(Q - float(g["Q_jod"])) <= JOD_TOL
    np.testing.assert_allclose(stats["Q_per_ch"], g["Q_per_ch"], rtol=2e-3, atol=2e-4)
    hm = stats["heatmap"]
    assert isinstance(hm, np.ndarray) and hm.dtype == np.float16
    assert hm.shape == g["heatmap"].shape == (1, 1, 1, 72, 108)
    np.testing.assert_allclose(_f32(hm), g["heatmap"], atol=2e-3)


def test_image_threshold_heatmap_matches_golden(goldens):
    g = goldens("image_path_heatmap_threshold")
    g8 = goldens("image_path_uint8")
    fv = fv_port.fvvdp(display_name="standard_4k", heatmap="threshold", device="cpu")
    Q, stats = fv.predict(g8["test"], g8["ref"], dim_order="HWC")
    assert abs(Q - float(g["Q_jod"])) <= JOD_TOL
    assert stats["heatmap"].shape == (1, 3, 1, 72, 108)
    np.testing.assert_allclose(_f32(stats["heatmap"]), g["heatmap"], atol=5e-3)


@pytest.mark.parametrize("block_frames", [None, 5])
def test_video_raw_heatmap_matches_golden(goldens, block_frames):
    g = goldens("video_path_heatmap")
    gv = goldens("video_path_replicate")
    fv = fv_port.fvvdp(display_name="standard_fhd", heatmap="raw", device="cpu",
                       block_frames=block_frames)
    Q, stats = fv.predict(gv["test"], gv["ref"], dim_order="HWCF",
                          frames_per_second=float(gv["fps"]))
    assert abs(Q - float(g["Q_jod"])) <= JOD_TOL
    np.testing.assert_allclose(stats["Q_per_ch"], gv["Q_per_ch"], rtol=2e-3, atol=2e-4)
    assert stats["heatmap"].shape == g["heatmap"].shape == (1, 1, 12, 48, 64)
    np.testing.assert_allclose(_f32(stats["heatmap"]), g["heatmap"], atol=2e-3)


@pytest.mark.parametrize("heatmap", ["raw", "threshold"])
def test_device_heatmap_is_a_tensor_equal_to_the_host_result(goldens, heatmap):
    gv = goldens("video_path_replicate")
    call = dict(dim_order="HWCF", frames_per_second=float(gv["fps"]))
    # 5-frame blocks in both: more than one block, so the blocks are joined
    host = fv_port.fvvdp(display_name="standard_fhd", heatmap=heatmap, device="cpu",
                         block_frames=5)
    dev = fv_port.fvvdp(display_name="standard_fhd", heatmap=heatmap, device="cpu",
                        device_heatmap=True, block_frames=5)
    Q_h, s_h = host.predict(gv["test"], gv["ref"], **call)
    Q_d, s_d = dev.predict(gv["test"], gv["ref"], **call)
    assert isinstance(s_d["heatmap"], torch.Tensor) and s_d["heatmap"].dtype == torch.float16
    assert Q_d == Q_h
    np.testing.assert_array_equal(s_d["heatmap"].numpy(), s_h["heatmap"])
    # the image path too
    g8 = goldens("image_path_uint8")
    _, s_hi = host.predict(g8["test"], g8["ref"], dim_order="HWC")
    _, s_di = dev.predict(g8["test"], g8["ref"], dim_order="HWC")
    assert isinstance(s_di["heatmap"], torch.Tensor)
    np.testing.assert_array_equal(s_di["heatmap"].numpy(), s_hi["heatmap"])


@pytest.mark.parametrize("heatmap", ["threshold", "supra-threshold", "monochromatic"])
def test_colour_heatmaps_match_jax_in_both_dtypes(goldens, heatmap):
    """float16 within the threshold golden's bar (5e-3); uint8 within one
    level of the JAX package's quantisation."""
    gv = goldens("video_path_replicate")
    test, ref = gv["test"][..., :4], gv["ref"][..., :4]
    call = dict(dim_order="HWCF", frames_per_second=float(gv["fps"]))
    for dtype in ("float16", "uint8"):
        jm = fv_jax.fvvdp(display_name="standard_fhd", heatmap=heatmap, heatmap_dtype=dtype)
        pm = fv_port.fvvdp(display_name="standard_fhd", heatmap=heatmap,
                           heatmap_dtype=dtype, device="cpu")
        Q_j, s_j = jm.predict(test, ref, **call)
        Q_p, s_p = pm.predict(test, ref, **call)
        assert abs(Q_p - Q_j) <= 1e-3
        assert s_p["heatmap"].shape == np.asarray(s_j["heatmap"]).shape == (1, 3, 4, 48, 64)
        assert s_p["heatmap"].dtype == np.dtype(dtype)
        if dtype == "uint8":
            diff = np.abs(s_p["heatmap"].astype(np.int16)
                          - np.asarray(s_j["heatmap"]).astype(np.int16))
            assert diff.max() <= 1
        else:
            np.testing.assert_allclose(_f32(s_p["heatmap"]), _f32(s_j["heatmap"]), atol=5e-3)


def test_heatmap_option_checks():
    with pytest.raises(ValueError, match="colormapped"):
        fv_port.fvvdp(heatmap="raw", heatmap_dtype="uint8", device="cpu")
    with pytest.raises(ValueError, match="heatmap_dtype"):
        fv_port.fvvdp(heatmap="threshold", heatmap_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="heatmap type"):
        fv_port.fvvdp(heatmap="blobs", device="cpu")
    # "none" is no heatmap, and takes the fused default route
    fv = fv_port.fvvdp(heatmap="none", device="cpu")
    assert not fv.do_heatmap and fv._get_core(64, 48).route == "fused"


def test_heatmap_does_not_change_the_score(goldens):
    g = goldens("image_path_uint8")
    q0, s0 = fv_port.fvvdp(device="cpu").predict(g["test"], g["ref"], dim_order="HWC")
    q1, s1 = fv_port.fvvdp(device="cpu", heatmap="supra-threshold").predict(
        g["test"], g["ref"], dim_order="HWC")
    assert "heatmap" not in s0
    assert abs(q1 - q0) <= 1e-3
    np.testing.assert_allclose(s1["Q_per_ch"], s0["Q_per_ch"], rtol=1e-4, atol=1e-6)


def test_device_heatmap_budget(goldens, monkeypatch):
    g = goldens("image_path_uint8")
    fv = fv_port.fvvdp(device="cpu", heatmap="threshold", device_heatmap=True)
    assert memory.heatmap_budget(fv.device) is None           # the CPU has no limit
    # half of the usable memory: one byte short of the (72, 108) map, then enough
    monkeypatch.setattr(memory, "usable_bytes", lambda device: 2 * (72 * 108 * 3 * 2 - 1))
    with pytest.raises(RuntimeError, match="device_heatmap=False"):
        fv.predict(g["test"], g["ref"], dim_order="HWC")
    monkeypatch.setattr(memory, "usable_bytes", lambda device: 2 * 72 * 108 * 3 * 2)
    _, stats = fv.predict(g["test"], g["ref"], dim_order="HWC")
    assert tuple(stats["heatmap"].shape) == (1, 3, 1, 72, 108)


@pytest.mark.parametrize("heatmap,kind", [("raw", "image"), ("threshold", "video")])
def test_foveated_heatmap_matches_jax(heatmap, kind):
    """The composition with per-pixel tables (sensitivity_pixel_tables)."""
    rng = np.random.default_rng(40)
    shape = (64, 160, 3, 4) if kind == "video" else (64, 160, 3)
    ref = rng.integers(0, 256, size=shape, dtype=np.uint8)
    test = np.clip(ref.astype(np.int16) + rng.integers(-14, 14, size=shape),
                   0, 255).astype(np.uint8)
    call = dict(fixation_point=np.array([40, 20]),
                **(dict(dim_order="HWCF", frames_per_second=30) if kind == "video"
                   else dict(dim_order="HWC")))
    jm = fv_jax.fvvdp(display_name="htc_vive_pro", foveated=True, heatmap=heatmap)
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, heatmap=heatmap,
                       device="cpu")
    Q_j, s_j = jm.predict(test, ref, **call)
    Q_p, s_p = pm.predict(test, ref, **call)
    assert abs(Q_p - Q_j) <= JOD_TOL
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], rtol=2e-3, atol=2e-4)
    assert s_p["heatmap"].shape == np.asarray(s_j["heatmap"]).shape
    np.testing.assert_allclose(_f32(s_p["heatmap"]), _f32(s_j["heatmap"]), atol=5e-3)
