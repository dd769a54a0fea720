"""Batches of pairs (``fvvdp.predict_batch``) and the
``do_temporal_channels=False`` ablation of fovvideovdp_tpu_torch on the CPU,
against the JAX package's ``predict_batch`` and ablation on the same
arrays, and against the port's own per-pair ``predict``.

Inputs follow tests/test_parallel.py:155-238 and
tests/test_core_options.py:23-31.  Bars: |dJOD| <= 1e-4 and Q_per_ch rtol
2e-3 / atol 2e-4 against JAX; |dJOD| <= 1e-5 against the port's per-pair
``predict`` (the same plain versions on the same frames, summed a chunk at
a time).
"""
import numpy as np
import pytest
import torch

import fovvideovdp_tpu as fv_jax
import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu_torch import csf, state
from fovvideovdp_tpu_torch.ops import masking as mask_ops
from fovvideovdp_tpu_torch.video_source import (PairBatch, fvvdp_video_source_array,
                                                rgb_to_y)

torch.set_num_threads(2)

JAX_JOD = 1e-4
JAX_Q = dict(rtol=2e-3, atol=2e-4)
SELF_JOD = 1e-5


def _carry_state(jax_metric, port_metric):
    """The port's metric on the JAX metric's parameters and LUTs."""
    params, luts = state.state_from_numpy(
        jax_metric.parameters,
        [{k: np.asarray(l[k]) for k in csf.LUT_FIELDS} for l in jax_metric._luts], "cpu")
    port_metric.load_state(params, luts)


def _pairs(seed, shape):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(*shape) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-25, 25, ref.shape),
                  0, 255).astype(np.uint8)
    return tst, ref


N, F, H, W = 3, 4, 32, 48
IMAGES = dict(shape=(N, H, W, 3), call=dict(dim_order="BHWC"))
CLIPS = dict(shape=(N, H, W, 3, F), call=dict(dim_order="BHWCF", frames_per_second=30))
PER_PAIR = np.stack([np.linspace(5, W - 5, N), np.linspace(5, H - 5, N)],
                    axis=1).astype(np.float32)
PER_FRAME = np.random.RandomState(13).rand(N, F, 2).astype(np.float32) * [W - 1, H - 1]

# name: (display, foveated, content, fixation_point)
JAX_CASES = {
    "images": ("standard_fhd", False, IMAGES, None),
    "clips": ("standard_fhd", False, CLIPS, None),
    "images_shared_gaze": ("standard_hmd", True, IMAGES, np.array([10.0, 20.0], np.float32)),
    "images_gaze_per_pair": ("standard_hmd", True, IMAGES, PER_PAIR),
    "clips_shared_gaze": ("standard_hmd", True, CLIPS, np.array([30.0, 5.0], np.float32)),
    "clips_gaze_per_pair": ("standard_hmd", True, CLIPS, PER_PAIR),
    "clips_gaze_per_frame": ("standard_hmd", True, CLIPS, PER_FRAME),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_predict_batch_matches_jax(case):
    display, foveated, content, gaze = JAX_CASES[case]
    tst, ref = _pairs(9, content["shape"])
    call = dict(content["call"], fixation_point=gaze)
    jm = fv_jax.fvvdp(display_name=display, foveated=foveated)
    pm = fv_port.fvvdp(display_name=display, foveated=foveated, device="cpu")
    _carry_state(jm, pm)
    j_jods, j_stats = jm.predict_batch(tst, ref, **call)
    p_jods, p_stats = pm.predict_batch(tst, ref, **call)
    assert isinstance(p_jods, np.ndarray) and p_jods.shape == (N,)
    np.testing.assert_allclose(p_jods, np.asarray(j_jods), rtol=0, atol=JAX_JOD)
    assert set(p_stats) == set(j_stats)
    for key in ("width", "height", "N_frames", "N_pairs", "frames_per_second"):
        assert p_stats[key] == j_stats[key], key
    if "Q_per_ch" in j_stats:
        assert p_stats["Q_per_ch"].shape == (pm._get_core(W, H).plan.height, 2, N, F)
        np.testing.assert_allclose(p_stats["Q_per_ch"], np.asarray(j_stats["Q_per_ch"]),
                                   **JAX_Q)


def _per_pair(fv, tst, ref, call, i):
    """Pair i through ``predict``: a per-pair gaze of an image becomes its
    one (1, 2) row, so that it takes the moving-gaze route as in the batch."""
    kw = dict(call, dim_order=call["dim_order"].replace("B", ""))
    gaze = kw.pop("fixation_point")
    if gaze is not None and gaze.ndim > 1:
        gaze = gaze[i] if gaze.ndim == 3 else gaze[i][None]
    return fv.predict(tst[i], ref[i], fixation_point=gaze, **kw)


N5 = 5
PER_PAIR5 = np.stack([np.linspace(3, W - 3, N5), np.linspace(3, H - 3, N5)],
                     axis=1).astype(np.float32)
PER_FRAME5 = np.random.RandomState(17).rand(N5, F, 2).astype(np.float32) * [W - 1, H - 1]


@pytest.mark.parametrize("block_frames", [2, 22], ids=["stream", "two_clips_a_chunk"])
@pytest.mark.parametrize("case", ["images", "clips", "images_shared_gaze",
                                  "images_gaze_per_pair", "clips_shared_gaze",
                                  "clips_gaze_per_frame"])
def test_predict_batch_matches_per_pair_predict(case, block_frames):
    """Chunks forced small: with ``block_frames=2`` images go 2 + 2 + 1 and
    each 4-frame clip (an 11-frame window at 30 fps) streams 2 frames at a
    time with its carry; with 22, clips go whole, 2 + 2 + 1 to a chunk."""
    foveated = "gaze" in case
    content = CLIPS if case.startswith("clips") else IMAGES
    shape = (N5,) + content["shape"][1:]
    tst, ref = _pairs(21, shape)
    gaze = {"images_shared_gaze": np.array([40.0, 3.0], np.float32),
            "clips_shared_gaze": np.array([8.0, 25.0], np.float32),
            "images_gaze_per_pair": PER_PAIR5, "clips_gaze_per_frame": PER_FRAME5}.get(case)
    fv = fv_port.fvvdp(display_name="standard_hmd" if foveated else "standard_fhd",
                       foveated=foveated, device="cpu", block_frames=block_frames)
    call = dict(content["call"], fixation_point=gaze)
    jods, stats = fv.predict_batch(tst, ref, **call)
    for i in range(N5):
        q, s = _per_pair(fv, tst, ref, call, i)
        assert abs(jods[i] - q) <= SELF_JOD, (i, jods[i], q)
        if "Q_per_ch" in stats:
            np.testing.assert_allclose(stats["Q_per_ch"][:, :, i], s["Q_per_ch"],
                                       rtol=1e-5, atol=1e-7)
    if case == "images_gaze_per_pair":
        assert not fv._get_core(W, H, with_heatmap=False)._fov_table_cache


@pytest.mark.parametrize("padding", ["circular", "pingpong"])
def test_predict_batch_streams_clips_with_their_padding(padding):
    """A streamed clip reads its padded warm-up frames by index; whole clips
    gather them: both give per-pair predict's JOD."""
    tst, ref = _pairs(23, (2, H, W, 1, 6))
    call = dict(dim_order="BHWCF", frames_per_second=30)
    for block_frames in (3, None):
        fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu", temp_padding=padding,
                           block_frames=block_frames)
        jods, _ = fv.predict_batch(tst, ref, **call)
        for i in range(2):
            q, _ = fv.predict(tst[i], ref[i], dim_order="HWCF", frames_per_second=30)
            assert abs(jods[i] - q) <= SELF_JOD


def test_predict_batch_takes_tensors_and_any_batch_axis():
    tst, ref = _pairs(25, (N, 1, H, W))                       # BCHW
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    jods, stats = fv.predict_batch(tst, ref, dim_order="BCHW")
    moved, _ = fv.predict_batch(torch.from_numpy(np.moveaxis(tst, 0, -1).copy()),
                                torch.from_numpy(np.moveaxis(ref, 0, -1).copy()),
                                dim_order="CHWB")
    np.testing.assert_array_equal(jods, moved)
    assert stats == {"width": W, "height": H, "N_frames": 1, "N_pairs": N,
                     "frames_per_second": 0}


def test_predict_batch_returns_no_heatmap():
    """A heatmap metric's batch scores on its kernels' route, as the same
    metric without a heatmap does: JAX drops the map."""
    tst, ref = _pairs(27, IMAGES["shape"])
    plain, _ = fv_port.fvvdp(display_name="standard_fhd", device="cpu").predict_batch(
        tst, ref, dim_order="BHWC")
    fv = fv_port.fvvdp(display_name="standard_fhd", heatmap="threshold", device="cpu")
    jods, stats = fv.predict_batch(tst, ref, dim_order="BHWC")
    np.testing.assert_array_equal(jods, plain)
    assert "heatmap" not in stats
    assert (W, H, "threshold") not in fv._cores


_BAD = np.zeros((N, H, W, 3), np.uint8)
# name: (metric kwargs, predict_batch args, kwargs)
ERROR_CASES = {
    "no_batch_axis": (dict(), (_BAD[0], _BAD[0]), dict(dim_order="HWC")),
    "shapes_differ": (dict(), (_BAD, _BAD[:, :-1]), dict(dim_order="BHWC")),
    "clip_without_fps": (dict(), (_BAD, _BAD), dict(dim_order="BHWF")),
    "two_channels": (dict(), (_BAD[..., :2], _BAD[..., :2]), dict(dim_order="BHWC")),
    "gaze_shape": (dict(foveated=True), (_BAD, _BAD),
                   dict(dim_order="BHWC", fixation_point=np.zeros((N, 3), np.float32))),
    "gaze_rows": (dict(foveated=True), (_BAD, _BAD),
                  dict(dim_order="BHWC", fixation_point=np.zeros((N + 1, 2), np.float32))),
    "foveated_content_mapping": (dict(foveated=True), (_BAD, _BAD), dict(dim_order="BHWC")),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_predict_batch_refuses_what_jax_refuses(case):
    """The same exception type and words as the JAX package."""
    kw, args, call = ERROR_CASES[case]
    jm = fv_jax.fvvdp(display_name="standard_hmd", **kw)
    pm = fv_port.fvvdp(display_name="standard_hmd", device="cpu", **kw)
    if case == "foveated_content_mapping":
        # the port refuses content mapping at construction (ROADMAP queue 1
        # item 3); the check of predict_batch is JAX's all the same
        jm.content_mapping = pm.content_mapping = object()
    with pytest.raises(Exception) as j_err:
        jm.predict_batch(*args, **call)
    with pytest.raises(type(j_err.value)) as p_err:
        pm.predict_batch(*args, **call)
    assert str(p_err.value) == str(j_err.value)


def test_predict_batch_mesh_names_its_item():
    """``mesh`` once raised here, naming ROADMAP queue 1 item 1; now the
    pairs split over a mesh of two CPU slots score as they do on one
    device (tests/test_torch_parallel.py holds the mesh against JAX)."""
    from fovvideovdp_tpu_torch.parallel import make_mesh
    tst, ref = _pairs(9, (N, H, W, 3))
    fv = fv_port.fvvdp(device="cpu")
    jods, _ = fv.predict_batch(tst, ref, dim_order="BHWC")
    jods_mesh, _ = fv.predict_batch(tst, ref, dim_order="BHWC", mesh=make_mesh(["cpu"] * 2))
    np.testing.assert_allclose(jods_mesh, jods, rtol=1e-6, atol=0)


def test_a_pair_that_cannot_fit_raises(monkeypatch):
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    monkeypatch.setattr(fv, "_free_device_bytes", lambda: 2 * 40 * H * W - 1)
    with pytest.raises(RuntimeError, match="over half of the card's free memory"):
        fv.predict_batch(_BAD, _BAD, dim_order="BHWC")
    # a clip's window that does not fit streams; a frame that fits is enough
    monkeypatch.setattr(fv, "_free_device_bytes", lambda: 2 * 40 * H * W)
    assert fv._pick_chunk(H, W, N, 11, "fused") == 0
    assert fv._pick_block_size(H, W, F, "fused") == 1
    monkeypatch.setattr(fv, "_free_device_bytes", lambda: 2 * 48 * H * W * 5)
    assert fv._pick_chunk(H, W, 64, 1, "fused", 8) == 5
    assert fv._pick_chunk(H, W, 3, 1, "fused", 8) == 3


@pytest.mark.parametrize("limit", [0, None], ids=["host_chunks", "resident"])
@pytest.mark.parametrize("dim_order", ["BHWCF", "BCFHW", "FHWCB"])
def test_pair_batch_luminance(monkeypatch, limit, dim_order):
    """A chunk of pairs, and frames of one pair by slice or index, equal the
    array source's luminance of each pair."""
    monkeypatch.setattr(fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES", limit)
    tst, ref = _pairs(29, (4, H, W, 3, 5))
    perm = ["BHWCF".index(d) for d in dim_order]
    dm = fv_port.fvvdp_display_photometry.load("standard_fhd")
    pairs = PairBatch(tst.transpose(perm), ref.transpose(perm), dim_order, 30, dm,
                      rgb_to_y("sRGB"), "cpu")
    assert pairs.shape == (4, 3, 5, H, W)
    lum_t, lum_r = pairs.luminance(1, 2)
    idx = np.array([0, 0, 3])
    sub_t, _ = pairs.luminance(2, 1, idx)
    run_t, _ = pairs.luminance(3, 1, slice(1, 4))
    for i in (1, 2, 3):
        vs = fvvdp_video_source_array(tst[i], ref[i], 30, dim_order="HWCF",
                                      display_photometry=dm, device="cpu")
        t, r = vs.get_luminance_block(0, 5)
        if i < 3:
            assert torch.equal(lum_t[i - 1], t) and torch.equal(lum_r[i - 1], r)
        if i == 2:
            assert torch.equal(sub_t[0], t[idx])
        if i == 3:
            assert torch.equal(run_t[0], t[1:4])


def test_temporal_pair_writes_into_out():
    """A clip's responses are written into its slice of a chunk's tensor."""
    from fovvideovdp_tpu_torch.ops.cuda.temporal import temporal_pair
    rng = np.random.RandomState(43)
    taps = torch.from_numpy(rng.rand(2, 5).astype(np.float32))
    x_t, x_r = (torch.from_numpy(rng.rand(9, 6, 7).astype(np.float32)) for _ in range(2))
    empty = torch.empty((0, 6, 7))
    want = temporal_pair(empty, x_t, empty, x_r, taps)
    R = torch.full((10, 4, 6, 7), float("nan"))
    got = temporal_pair(empty, x_t, empty, x_r, taps, out=R[5:])
    assert got.data_ptr() == R[5:].data_ptr() and torch.equal(R[5:], want)
    assert torch.isnan(R[:5]).all()
    with pytest.raises(ValueError, match="out must be"):
        temporal_pair(empty, x_t, empty, x_r, taps, out=R[:4])
    with pytest.raises(ValueError, match="without autograd"):
        temporal_pair(empty, x_t.clone().requires_grad_(), empty, x_r, taps, out=R[5:])


def test_pool_to_jod_pools_each_pair_as_its_own_clip():
    rng = np.random.RandomState(31)
    Q = torch.from_numpy(rng.rand(6, 2, 4, 7).astype(np.float32))
    args = (0.25, 2.0, 3.0, 4.0, -0.25, 0.1)
    jods = mask_ops.pool_to_jod(Q, *args)
    assert jods.shape == (4,)
    for i in range(4):
        assert torch.allclose(jods[i], mask_ops.pool_to_jod(Q[:, :, i], *args),
                              rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# do_temporal_channels=False: each frame of a video scored as an image
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_video():
    rng = np.random.RandomState(3)
    ref = (rng.rand(32, 48, 3, 5) * 255).astype(np.uint8)
    tst = np.clip(ref / 255.0 + rng.randn(*ref.shape) * 0.05, 0, 1)
    return (tst * 255).astype(np.uint8), ref


ABLATION_CASES = {
    "default": (dict(display_name="standard_fhd"), None),
    "fixed_gaze": (dict(display_name="standard_hmd", foveated=True),
                   np.array([12.0, 20.0], np.float32)),
    "gaze_per_frame": (dict(display_name="standard_hmd", foveated=True),
                       np.stack([np.linspace(0, 47, 5), np.linspace(31, 0, 5)],
                                axis=1).astype(np.float32)),
    "threshold_heatmap": (dict(display_name="standard_fhd", heatmap="threshold"), None),
}


@pytest.mark.parametrize("case", list(ABLATION_CASES))
def test_ablation_matches_jax(small_video, case):
    tst, ref = small_video
    kw, gaze = ABLATION_CASES[case]
    call = dict(dim_order="HWCF", frames_per_second=30, fixation_point=gaze)
    jm = fv_jax.fvvdp(do_temporal_channels=False, **kw)
    pm = fv_port.fvvdp(do_temporal_channels=False, device="cpu", **kw)
    _carry_state(jm, pm)
    Q_j, s_j = jm.predict(tst, ref, **call)
    Q_p, s_p = pm.predict(tst, ref, **call)
    assert abs(Q_p - Q_j) <= JAX_JOD
    assert np.all(s_p["Q_per_ch"][:, 1, :] == 0)
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], **JAX_Q)
    if "heatmap" in kw:
        assert s_p["heatmap"].shape == np.asarray(s_j["heatmap"]).shape == (1, 3, 5, 32, 48)
        np.testing.assert_allclose(s_p["heatmap"].astype(np.float32),
                                   np.asarray(s_j["heatmap"]).astype(np.float32), atol=5e-3)


@pytest.mark.parametrize("case", list(ABLATION_CASES))
def test_ablation_chunks_score_as_one(small_video, case):
    """Chunks of 2 frames give the whole clip's scores, and each frame the
    score it gets as an image."""
    tst, ref = small_video
    kw, gaze = ABLATION_CASES[case]
    call = dict(dim_order="HWCF", frames_per_second=30, fixation_point=gaze)
    whole = fv_port.fvvdp(do_temporal_channels=False, device="cpu", **kw)
    Q_w, s_w = whole.predict(tst, ref, **call)
    Q_c, s_c = fv_port.fvvdp(do_temporal_channels=False, device="cpu", block_frames=2,
                             **kw).predict(tst, ref, **call)
    assert abs(Q_c - Q_w) <= SELF_JOD
    np.testing.assert_allclose(s_c["Q_per_ch"], s_w["Q_per_ch"], rtol=1e-5, atol=1e-7)
    image = fv_port.fvvdp(device="cpu", **kw)
    _, s_i = image.predict(tst[..., 3], ref[..., 3], dim_order="HWC",
                           fixation_point=gaze if gaze is None or gaze.ndim == 1
                           else gaze[3:4])
    np.testing.assert_allclose(s_w["Q_per_ch"][:, :, 3], s_i["Q_per_ch"][:, :, 0],
                               rtol=1e-5, atol=1e-7)


def test_ablation_chunks_of_a_host_streamed_source(monkeypatch):
    """A source that streams its frames from the host has its prefetched
    block counted in the ablation's chunk, and its chunks capped at a
    streamed block's size (the pinned staging buffers hold a chunk)."""
    from fovvideovdp_tpu_torch.core import MetricCore
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu", do_temporal_channels=False)
    tst, ref = _pairs(41, (H, W, 1, 40))
    assert fvvdp_video_source_array(tst, ref, 30, dim_order="HWCF",
                                    device="cpu").host_block_bytes(3) == 0
    chunks = []
    score = MetricCore.score_frame_pairs

    def spy(self, frames, n, chunk, *args):
        chunks.append(chunk)
        return score(self, frames, n, chunk, *args)
    monkeypatch.setattr(MetricCore, "score_frame_pairs", spy)

    class Streamed(fvvdp_video_source_array):
        def host_block_bytes(self, count):
            return 2 * count * H * W                # a gray uint8 pair

    vs = Streamed(tst, ref, 30, dim_order="HWCF", device="cpu")
    # 5 frames fit at 40 + 8 B per pixel-frame, 4 with the prefetch's 2 B
    monkeypatch.setattr(fv, "_free_device_bytes", lambda: 2 * 48 * H * W * 5)
    q_small, _ = fv.predict_video_source(vs)
    monkeypatch.setattr(fv, "_free_device_bytes", lambda: 2 * 48 * H * W * 1000)
    q_big, _ = fv.predict_video_source(vs)
    assert chunks == [4, 32]
    assert abs(q_small - q_big) <= SELF_JOD
