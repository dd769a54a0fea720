"""fovvideovdp_tpu_torch's file sources against the JAX package on the CPU:
raw .yuv pairs, video files through stub ffmpeg/ffprobe executables (the
cases of ``tests/test_ffmpeg_source.py``), the OpenCV fallback on a video
written here with cv2 (the synthetic cases of ``tests/test_cv2_source.py``)
and the dispatcher.  The same files go through both packages.

Bars: luminance blocks rtol 1e-5 on an sRGB display; on a PQ display the
EOTF alone differs by up to 3.5e-5 relative between torch.pow and
jnp.power on identical inputs (its cancellation near black amplifies one
ulp of the inner power), so PQ blocks are held at rtol 1e-4; RGB atol 1e-6;
|dJOD| <= 1e-4; Q_per_ch rtol 2e-3 / atol 2e-4.  The file sources on a
card against ``device="cpu"`` are ``gpu`` cases of ``test_torch_package.py``,
which runs without JAX.
"""
import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

import fovvideovdp_tpu as fv_jax
import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu import video_source_file as jax_vsf
from fovvideovdp_tpu import video_source_yuv as jax_vsy
from fovvideovdp_tpu_torch import csf, state
from fovvideovdp_tpu_torch import video_source_file as port_vsf
from fovvideovdp_tpu_torch import video_source_yuv as port_vsy

torch.set_num_threads(2)

H, W, F, FPS = 48, 64, 6, 30.0
JOD_BAR = 1e-4
GOLDEN_BAR = dict(rtol=2e-3, atol=2e-4)
SDR_LUM = dict(rtol=1e-5)
PQ_LUM = dict(rtol=1e-4)


def _metrics(display, **kw):
    """A JAX metric and a port metric on the CPU with the JAX state carried across."""
    jm = fv_jax.fvvdp(display_name=display, **kw)
    pm = fv_port.fvvdp(display_name=display, device="cpu", **kw)
    params, luts = state.state_from_numpy(
        jm.parameters, [{k: np.asarray(l[k]) for k in csf.LUT_FIELDS} for l in jm._luts], "cpu")
    pm.load_state(params, luts)
    return jm, pm


def _same_scores(jm, pm, js, ps):
    Q_j, s_j = jm.predict_video_source(js)
    Q_p, s_p = pm.predict_video_source(ps)
    assert abs(Q_p - Q_j) <= JOD_BAR, (Q_p, Q_j)
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], **GOLDEN_BAR)
    return Q_p


def _lum(pair):
    return [np.asarray(x) for x in pair]


# ---------------------------------------------------------------------------
# raw .yuv pairs
# ---------------------------------------------------------------------------

def _write_yuv(path, bits, ss, seed, frames=F, h=H, w=W):
    rng = np.random.RandomState(seed)
    d = 2 ** (bits - 8)
    dt = np.uint8 if bits == 8 else np.uint16
    uv = (h, w) if ss == "444" else (h // 2, w // 2)
    with open(path, "wb") as f:
        for _ in range(frames):
            f.write(rng.randint(16 * d, 236 * d, (h, w)).astype(dt).tobytes())
            f.write(rng.randint(16 * d, 241 * d, uv).astype(dt).tobytes())
            f.write(rng.randint(16 * d, 241 * d, uv).astype(dt).tobytes())
    return str(path)


@pytest.fixture
def yuv_pairs(tmp_path):
    def make(bits, ss, space):
        return [_write_yuv(tmp_path / f"{tag}_{W}x{H}_{bits}b_{ss}_{space}_30fps.yuv",
                           bits, ss, seed)
                for tag, seed in (("test", 0), ("ref", 1))]
    return make


def test_yuv_reader_matches_jax(yuv_pairs):
    t, _ = yuv_pairs(10, "420", "2020")
    r = port_vsy.YUVReader(t)
    j = jax_vsy.YUVReader(t)
    assert (r.width, r.height, r.bit_depth, r.frame_count) == (W, H, 10, F)
    for p, q in zip(r.get_frame_yuv(2), j.get_frame_yuv(2)):
        np.testing.assert_array_equal(p, q)
    rgb = r.get_frame_rgb(1, device="cpu").numpy()
    assert rgb.shape == (H, W, 3) and (rgb >= 0).all() and (rgb <= 1).all()
    np.testing.assert_allclose(rgb, np.asarray(j.get_frame_rgb(1)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fmt", [(8, "420", "709", "standard_fhd"),
                                 (10, "420", "2020", "standard_hdr_pq"),
                                 (12, "444", "2020", "standard_hdr_pq"),
                                 (8, "444", "709", "standard_4k")],
                         ids=["8b-420-709", "10b-420-pq", "12b-444-pq", "8b-444"])
def test_yuv_source_matches_jax(yuv_pairs, fmt):
    bits, ss, space, display = fmt
    names = yuv_pairs(bits, ss, space)
    jm, pm = _metrics(display)
    js = jax_vsy.fvvdp_video_source_yuv_file(*names, display_photometry=display)
    ps = port_vsy.fvvdp_video_source_yuv_file(*names, display_photometry=display, device="cpu")
    assert ps.get_video_size() == js.get_video_size() == (H, W, F)
    assert ps.get_frames_per_second() == js.get_frames_per_second() == FPS
    tol = PQ_LUM if display == "standard_hdr_pq" else SDR_LUM
    for p, j in zip(_lum(ps.get_luminance_block(1, 3)), _lum(js.get_luminance_block(1, 3))):
        assert p.shape == (3, H, W) and p.dtype == np.float32
        np.testing.assert_allclose(p, j, **tol)
    np.testing.assert_allclose(ps.get_test_frame(4).numpy(), np.asarray(js.get_test_frame(4)),
                               **tol)
    _same_scores(jm, pm, js, port_vsy.fvvdp_video_source_yuv_file(
        *names, display_photometry=display, device="cpu"))


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest", "area"])
def test_yuv_source_full_screen_resize_matches_jax(yuv_pairs, method):
    names = yuv_pairs(8, "420", "709")
    kw = dict(display_photometry="standard_fhd", full_screen_resize=method,
              resize_resolution=(100, 70))
    js = jax_vsy.fvvdp_video_source_yuv_file(*names, **kw)
    ps = port_vsy.fvvdp_video_source_yuv_file(*names, device="cpu", **kw)
    assert ps.get_video_size() == js.get_video_size() == (70, 100, F)
    for p, j in zip(_lum(ps.get_luminance_block(0, F)), _lum(js.get_luminance_block(0, F))):
        np.testing.assert_allclose(p, j, **SDR_LUM)
    np.testing.assert_allclose(ps.get_reference_frame(2).numpy(),
                               np.asarray(js.get_reference_frame(2)), **SDR_LUM)


def test_yuv_source_upscaled_pq_scores_like_jax(yuv_pairs):
    names = yuv_pairs(10, "420", "2020")
    kw = dict(display_photometry="standard_hdr_pq", full_screen_resize="bicubic",
              resize_resolution=(96, 72))
    jm, pm = _metrics("standard_hdr_pq")
    _same_scores(jm, pm, jax_vsy.fvvdp_video_source_yuv_file(*names, **kw),
                 port_vsy.fvvdp_video_source_yuv_file(*names, device="cpu", **kw))


@pytest.mark.parametrize("padding", ["circular", "pingpong"])
def test_yuv_source_reordered_blocks_match_jax(yuv_pairs, padding):
    names = yuv_pairs(8, "420", "709")
    jm, pm = _metrics("standard_fhd", temp_padding=padding)
    kw = dict(display_photometry="standard_fhd")
    _same_scores(jm, pm, jax_vsy.fvvdp_video_source_yuv_file(*names, **kw),
                 port_vsy.fvvdp_video_source_yuv_file(*names, device="cpu", **kw))


def test_yuv_readers_give_the_same_luminance(yuv_pairs):
    names = yuv_pairs(10, "420", "2020")
    blocks = [port_vsy.fvvdp_video_source_yuv_file(
        *names, display_photometry="standard_hdr_pq", device="cpu",
        reader=reader).get_indexed_luminance_block(np.array([5, 0, 2]))
        for reader in ("native", "python")]
    for a, b in zip(*blocks):
        assert torch.equal(a, b)


def test_yuv_conversion_chunks_do_not_change_the_result(yuv_pairs, monkeypatch):
    """A block converted a chunk of frames at a time equals it converted whole."""
    from fovvideovdp_tpu_torch import video_source as vsrc
    names = yuv_pairs(8, "420", "709")
    src = lambda: port_vsy.fvvdp_video_source_yuv_file(  # noqa: E731
        *names, display_photometry="standard_fhd", device="cpu")
    whole = src().get_luminance_block(0, F)
    monkeypatch.setattr(vsrc, "CONVERT_CHUNK_PIXELS", 2 * H * W)
    chunked = src().get_luminance_block(0, F)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_yuv_source_empty_index_block(yuv_pairs):
    names = yuv_pairs(8, "420", "709")
    t, r = port_vsy.fvvdp_video_source_yuv_file(
        *names, display_photometry="standard_fhd", device="cpu").get_indexed_luminance_block([])
    assert t.shape == r.shape == (0, H, W)


def test_yuv_source_frames_cap(yuv_pairs):
    names = yuv_pairs(8, "420", "709")
    ps = port_vsy.fvvdp_video_source_yuv_file(*names, display_photometry="standard_fhd",
                                              frames=4, device="cpu")
    assert ps.get_video_size() == (H, W, 4)


# ---------------------------------------------------------------------------
# video files through stub ffmpeg/ffprobe executables
# ---------------------------------------------------------------------------

def _write_exe(path, body):
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"#!{sys.executable}\n{body}")
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


@pytest.fixture()
def fake_ffmpeg(tmp_path, monkeypatch):
    """ffprobe prints the sidecar <file>.probe.json; ffmpeg streams the raw
    file bytes to stdout (the 'videos' are stored as raw planes)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _write_exe(bindir / "ffprobe", "import sys\nprint(open(sys.argv[-1] + '.probe.json').read())\n")
    _write_exe(bindir / "ffmpeg", (
        "import sys\n"
        "path = sys.argv[sys.argv.index('-i') + 1]\n"
        "sys.stdout.buffer.write(open(path, 'rb').read())\n"))
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return tmp_path


def _make_video(tmp_path, name, seed, pix_fmt="yuv420p", gray=False, probe_overrides=None):
    """Raw planar video in a pix_fmt (420/444, 8/10/12-bit, or rgb24) plus
    its ffprobe sidecar; returns (path, frames)."""
    rng = np.random.RandomState(seed)
    bits = 8 if "p1" not in pix_fmt else int(pix_fmt.split("p")[1][:2])
    dt = np.uint8 if bits == 8 else np.uint16
    d = 2 ** (bits - 8)
    frames, planes = [], []
    if pix_fmt.startswith("rgb"):
        for _ in range(F):
            rgb = rng.randint(0, 256 * d, (H, W, 3)).astype(dt)
            frames.append(rgb)
            planes.append(rgb.tobytes())
    else:
        uv_shape = (H, W) if "444" in pix_fmt else (H // 2, W // 2)
        for _ in range(F):
            Y = rng.randint(16 * d, 236 * d, (H, W)).astype(dt)
            if gray:
                u = v = np.full(uv_shape, 128 * d, dtype=dt)
            else:
                u = rng.randint(16 * d, 241 * d, uv_shape).astype(dt)
                v = rng.randint(16 * d, 241 * d, uv_shape).astype(dt)
            frames.append((Y, u, v))
            planes += [Y.tobytes(), u.tobytes(), v.tobytes()]
    path = tmp_path / f"{name}.mp4"
    path.write_bytes(b"".join(planes))
    probe = {"streams": [{"codec_type": "video", "width": W, "height": H,
                          "pix_fmt": pix_fmt, "nb_frames": str(F),
                          "r_frame_rate": "30/1"}]}
    for k, val in (probe_overrides or {}).items():
        if val is None:
            probe["streams"][0].pop(k, None)
        else:
            probe["streams"][0][k] = val
    (tmp_path / f"{name}.mp4.probe.json").write_text(json.dumps(probe))
    return str(path), frames


def _host_yuv_to_rgb(Y, u, v, bits):
    """Independent host conversion: limited-range scaling and the
    BT.709-path matrix, clipped to [0, 1]."""
    d = 2.0 ** (bits - 8)
    Yf = np.clip(Y.astype(np.float64) / (d * 219.0) - 16.0 / 219.0, 0, 1)
    uf = np.clip(u.astype(np.float64) / (d * 224.0) - 128.0 / 224.0, -.5, .5)
    vf = np.clip(v.astype(np.float64) / (d * 224.0) - 128.0 / 224.0, -.5, .5)
    M = np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]])
    return np.clip(np.stack([Yf, uf, vf], -1) @ M.T, 0.0, 1.0)


def _pair(tmp, **kw):
    return (_make_video(tmp, "tst", seed=0, **kw)[0], _make_video(tmp, "ref", seed=1, **kw)[0])


@pytest.mark.parametrize("ffmpeg_cc", [False, True], ids=["yuv-device", "rgb-pipe"])
def test_streaming_matches_jax_and_preload(fake_ffmpeg, ffmpeg_cc):
    tst, ref = _pair(fake_ffmpeg, pix_fmt="rgb24" if ffmpeg_cc else "yuv420p")
    kw = dict(display_photometry="standard_fhd", ffmpeg_cc=ffmpeg_cc)
    jm, pm = _metrics("standard_fhd")
    vs = port_vsf.fvvdp_video_source_file(tst, ref, device="cpu", **kw)
    assert vs.get_video_size() == (H, W, F) and vs.get_frames_per_second() == FPS
    assert not vs.supports_random_access()
    Q_stream = _same_scores(jm, pm, jax_vsf.fvvdp_video_source_file(tst, ref, **kw), vs)
    pre = port_vsf.fvvdp_video_source_file(tst, ref, device="cpu", preload=True, **kw)
    assert pre.supports_random_access()
    Q_pre, _ = pm.predict_video_source(pre)
    assert Q_pre == Q_stream


def test_rgb_pipe_luminance_matches_jax(fake_ffmpeg):
    """rgb24 straight from the pipe (ffmpeg_cc): the frames as stored."""
    tst, _ = _make_video(fake_ffmpeg, "rgb", seed=4, pix_fmt="rgb24")
    kw = dict(display_photometry="standard_fhd", ffmpeg_cc=True)
    ps = port_vsf.fvvdp_video_source_file(tst, tst, device="cpu", **kw)
    js = jax_vsf.fvvdp_video_source_file(tst, tst, **kw)
    for p, j in zip(_lum(ps.get_luminance_block(0, F)), _lum(js.get_luminance_block(0, F))):
        np.testing.assert_allclose(p, j, **SDR_LUM)


def test_blocked_read_matches_per_frame_and_jax(fake_ffmpeg):
    tst, ref = _pair(fake_ffmpeg)
    blk = port_vsf.fvvdp_video_source_file(tst, ref, display_photometry="standard_fhd",
                                           device="cpu")
    t_blk, r_blk = blk.get_luminance_block(0, F)
    assert t_blk.shape == (F, H, W)
    pf = port_vsf.fvvdp_video_source_file(tst, ref, display_photometry="standard_fhd",
                                          device="cpu")
    t_pf = torch.cat([pf.get_test_frame(i)[0, 0] for i in range(F)])
    r_pf = torch.cat([pf.get_reference_frame(i)[0, 0] for i in range(F)])
    assert torch.equal(t_blk, t_pf) and torch.equal(r_blk, r_pf)
    js = jax_vsf.fvvdp_video_source_file(tst, ref, display_photometry="standard_fhd")
    for p, j in zip((t_blk, r_blk), _lum(js.get_luminance_block(0, F))):
        np.testing.assert_allclose(p.numpy(), j, **SDR_LUM)


def test_stream_refuses_random_access(fake_ffmpeg):
    tst, ref = _pair(fake_ffmpeg)
    vs = port_vsf.fvvdp_video_source_file(tst, ref, display_photometry="standard_fhd",
                                          device="cpu")
    with pytest.raises(RuntimeError, match="random access"):
        vs.get_indexed_luminance_block([3, 2, 1])
    with pytest.raises(RuntimeError, match="frame-by-frame"):
        vs.get_luminance_block(2, 2)


def test_gray_yuv_matches_array_source(fake_ffmpeg):
    """Neutral-chroma YUV equals an array source fed the same gray RGB."""
    tst, frames = _make_video(fake_ffmpeg, "tst", seed=3, gray=True)
    vs = port_vsf.fvvdp_video_source_file(tst, tst, display_photometry="standard_fhd",
                                          device="cpu")
    t_blk, _ = vs.get_luminance_block(0, F)
    y = np.stack([np.clip((f[0].astype(np.float32) - 16.0) / 219.0, 0, 1) for f in frames])
    rgb = np.repeat(y[..., None], 3, axis=-1).transpose(1, 2, 3, 0)
    t_arr, _ = fv_port.fvvdp_video_source_array(
        rgb, rgb, FPS, dim_order="HWCF", display_photometry="standard_fhd",
        device="cpu").get_luminance_block(0, F)
    np.testing.assert_allclose(t_blk.numpy(), t_arr.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pix_fmt,gray", [("yuv420p10le", True), ("yuv444p10le", False),
                                          ("yuv444p", False), ("yuv420p12le", True)])
def test_reader_unpack_matches_host_and_jax(fake_ffmpeg, pix_fmt, gray):
    tst, frames = _make_video(fake_ffmpeg, "fmt", seed=11, pix_fmt=pix_fmt, gray=gray)
    vr = port_vsf.video_reader_yuv_device(tst)
    bits = 8 if "p1" not in pix_fmt else int(pix_fmt.split("p")[1][:2])
    ss = "444" if "444" in pix_fmt else "420"
    assert (vr.bit_depth, vr.chroma_ss) == (bits, ss)
    assert vr.dtype == (np.uint8 if bits == 8 else np.uint16)
    n_ch = 3 if ss == "444" else 1.5
    assert vr.frame_bytes == int(H * W * n_ch * (1 if bits == 8 else 2))
    blk = vr.get_frames_block(2)
    vr.close()
    raw = torch.from_numpy(blk.view(np.int16) if blk.dtype == np.uint16 else blk)
    rgb = vr.unpack_block(raw).numpy()
    jr = jax_vsf.video_reader_yuv_device(tst)
    np.testing.assert_allclose(rgb, np.asarray(jr.unpack_block(jr.get_frames_block(2))),
                               rtol=0, atol=1e-6)
    jr.close()
    for i in range(2):
        Y, u, v = frames[i]
        if ss == "420":       # gray chroma: the upsample is value-neutral
            u = v = np.full((H, W), 128 * 2 ** (bits - 8))
        np.testing.assert_allclose(rgb[i], _host_yuv_to_rgb(Y, u, v, bits), atol=2e-4)


def test_10bit_end_to_end_matches_jax(fake_ffmpeg):
    tst, ref = _pair(fake_ffmpeg, pix_fmt="yuv420p10le")
    jm, pm = _metrics("standard_hdr_pq")
    kw = dict(display_photometry="standard_hdr_pq")
    _same_scores(jm, pm, jax_vsf.fvvdp_video_source_file(tst, ref, **kw),
                 port_vsf.fvvdp_video_source_file(tst, ref, device="cpu", **kw))


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_pipe_full_screen_resize_matches_jax(fake_ffmpeg, method):
    """The YUV pipe resizes on the device and clips after the resize only."""
    tst, _ = _make_video(fake_ffmpeg, "tst", seed=0)
    kw = dict(display_photometry="standard_fhd", full_screen_resize=method,
              resize_resolution=(90, 60))
    ps = port_vsf.fvvdp_video_source_file(tst, tst, device="cpu", **kw)
    js = jax_vsf.fvvdp_video_source_file(tst, tst, **kw)
    assert ps.get_video_size() == js.get_video_size() == (60, 90, F)
    for p, j in zip(_lum(ps.get_luminance_block(0, F)), _lum(js.get_luminance_block(0, F))):
        np.testing.assert_allclose(p, j, **SDR_LUM)


def test_nb_frames_fallback_from_duration(fake_ffmpeg):
    tst, _ = _make_video(fake_ffmpeg, "tst", seed=0,
                         probe_overrides={"nb_frames": None, "duration": str(F / FPS)})
    vr = port_vsf.video_reader_yuv_device(tst)
    assert vr.frames == F == jax_vsf.video_reader_yuv_device(tst).frames
    vr.close()


def test_no_metadata_requires_frames_arg(fake_ffmpeg):
    tst, _ = _make_video(fake_ffmpeg, "tst", seed=0, probe_overrides={"nb_frames": None})
    with pytest.raises(RuntimeError, match="frame count"):
        port_vsf.video_reader_yuv_device(tst)
    vr = port_vsf.video_reader_yuv_device(tst, frames=F)
    assert vr.frames == F
    vr.close()


def test_vfr_uses_avg_frame_rate(fake_ffmpeg):
    tst, _ = _make_video(fake_ffmpeg, "tst", seed=0, probe_overrides={
        "avg_frame_rate": "24000/1001", "r_frame_rate": "60000/1001"})
    vr = port_vsf.video_reader_yuv_device(tst)
    assert abs(vr.avg_fps - 23.976) < 0.01
    vr.close()
    tst2, _ = _make_video(fake_ffmpeg, "tst2", seed=0, probe_overrides={"avg_frame_rate": "0/0"})
    vr2 = port_vsf.video_reader_yuv_device(tst2)
    assert vr2.avg_fps == 30.0
    vr2.close()


def test_full_range_pix_fmt(fake_ffmpeg):
    tst, _ = _make_video(fake_ffmpeg, "tst", seed=0, probe_overrides={"pix_fmt": "yuvj420p"})
    vr = port_vsf.video_reader_yuv_device(tst)
    assert vr.chroma_ss == "420"
    assert vr.get_frame() is not None
    vr.close()


def test_unsupported_chroma_raises(fake_ffmpeg):
    tst, _ = _make_video(fake_ffmpeg, "tst", seed=0, probe_overrides={"pix_fmt": "yuv422p"})
    with pytest.raises(RuntimeError, match="chroma"):
        port_vsf.video_reader_yuv_device(tst)


def test_blocking_pipe_reads_match_native(fake_ffmpeg):
    tst, ref = _pair(fake_ffmpeg)
    lums = [port_vsf.fvvdp_video_source_file(
        tst, ref, display_photometry="standard_fhd", device="cpu",
        reader=reader).get_luminance_block(0, F) for reader in ("native", "python")]
    for a, b in zip(*lums):
        assert torch.equal(a, b)


def test_checkpoint_is_not_ported(fake_ffmpeg):
    """Checkpointing, which once raised here, runs on a preloaded pipe
    source (a checkpoint after every block, removed at the end) and scores
    what the JAX package scores; the streaming pipe source is refused in
    JAX's words."""
    tst, ref = _pair(fake_ffmpeg)
    ckpt = str(fake_ffmpeg / "s.ckpt")
    pm = fv_port.fvvdp(display_name="standard_fhd", block_frames=2, device="cpu")
    jm = fv_jax.fvvdp(display_name="standard_fhd", block_frames=2)

    def port_source(preload):
        return port_vsf.fvvdp_video_source_file(tst, ref, display_photometry="standard_fhd",
                                                device="cpu", preload=preload)
    q_p, s_p = pm.predict_video_source(port_source(True), checkpoint_path=ckpt,
                                       checkpoint_every=1)
    assert not os.path.exists(ckpt)
    q_plain, s_plain = pm.predict_video_source(port_source(True))
    assert q_p == q_plain and np.array_equal(s_p["Q_per_ch"], s_plain["Q_per_ch"])
    q_j, s_j = jm.predict_video_source(
        jax_vsf.fvvdp_video_source_file(tst, ref, display_photometry="standard_fhd",
                                        preload=True), checkpoint_path=ckpt)
    assert abs(q_p - q_j) <= 1e-4
    np.testing.assert_allclose(s_p["Q_per_ch"], np.asarray(s_j["Q_per_ch"]),
                               rtol=2e-3, atol=2e-4)
    with pytest.raises(RuntimeError, match="random-access") as port_err:
        pm.predict_video_source(port_source(False), checkpoint_path=ckpt)
    with pytest.raises(RuntimeError, match="random-access") as jax_err:
        jm.predict_video_source(jax_vsf.fvvdp_video_source_file(
            tst, ref, display_photometry="standard_fhd"), checkpoint_path=ckpt)
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# the OpenCV fallback, on a video written here
# ---------------------------------------------------------------------------

@pytest.fixture
def cv2_videos(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))  # no ffmpeg/ffprobe
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (8, H, W, 3), dtype=np.uint8)
    paths = []
    for k, name in enumerate(("ref", "tst")):
        path = str(tmp_path / f"{name}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (W, H))
        assert vw.isOpened()
        for f in base:
            vw.write(np.clip(f.astype(np.int16) + 9 * k, 0, 255).astype(np.uint8))
        vw.release()
        paths.append(path)
    return paths


def test_cv2_reader_props_and_eof(cv2_videos):
    ref, _ = cv2_videos
    with port_vsf.cv2_video_reader(ref, frames=5) as r:
        assert (r.width, r.height) == (W, H)
        assert r.avg_fps == pytest.approx(25.0) and r.frames == 5
        b = r.get_frames_block(3)
        assert b.shape == (3, W * H * 3) and b.dtype == np.uint8
        out = np.zeros((10, W * H * 3), dtype=np.uint8)
        assert r.get_frames_block(10, out=out) == 2       # the frame cap truncates
        assert r.get_frames_block(1) is None and r.get_frame() is None
    with jax_vsf.cv2_video_reader(ref, frames=5) as j:
        np.testing.assert_array_equal(j.get_frames_block(3), b)
        np.testing.assert_array_equal(j.get_frames_block(10), out[:2])


def test_cv2_file_source_matches_jax(cv2_videos):
    ref, tst = cv2_videos
    n = 6
    jm, pm = _metrics("standard_fhd")
    kw = dict(display_photometry="standard_fhd", frames=n)
    ps = port_vsf.fvvdp_video_source_file(tst, ref, device="cpu", **kw)
    assert ps.get_video_size() == (H, W, n)
    assert ps.get_frames_per_second() == pytest.approx(25.0)
    _same_scores(jm, pm, jax_vsf.fvvdp_video_source_file(tst, ref, **kw), ps)


def test_cv2_source_full_screen_resize(cv2_videos):
    ref, tst = cv2_videos
    kw = dict(display_photometry="standard_fhd", frames=3, full_screen_resize="bilinear",
              resize_resolution=(40, 30))
    ps = port_vsf.fvvdp_video_source_file(tst, ref, device="cpu", **kw)
    assert ps.get_video_size() == (30, 40, 3)
    js = jax_vsf.fvvdp_video_source_file(tst, ref, **kw)
    for p, j in zip(_lum(ps.get_luminance_block(0, 3)), _lum(js.get_luminance_block(0, 3))):
        assert p.shape == (3, 30, 40)
        np.testing.assert_allclose(p, j, **SDR_LUM)


def test_cv2_reader_pads_overreported_frame_count(cv2_videos):
    ref, _ = cv2_videos
    with port_vsf.cv2_video_reader(ref) as r:
        true_n = r.frames
        r.frames = true_n + 2          # a container that over-reports
        got, last = 0, None
        while (b := r.get_frames_block(16)) is not None:
            got += b.shape[0]
            last = b
        assert got == true_n + 2
        np.testing.assert_array_equal(last[-1], last[-2])
    with port_vsf.cv2_video_reader(ref) as r:
        r.frames = r.frames + 50       # a grossly wrong count still fails
        got = 0
        while (b := r.get_frames_block(16)) is not None:
            got += b.shape[0]
        assert got < r.frames - 1


def test_cv2_fallback_refuses_hdr_display(cv2_videos):
    ref, tst = cv2_videos
    with pytest.raises(RuntimeError, match="8-bit SDR"):
        port_vsf.fvvdp_video_source_file(tst, ref, display_photometry="standard_hdr_pq",
                                         frames=2, device="cpu")


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

def test_dispatcher_checks_its_inputs(tmp_path, yuv_pairs):
    cv2 = pytest.importorskip("cv2")
    img = str(tmp_path / "a.png")
    cv2.imwrite(img, np.zeros((8, 8, 3), np.uint8))
    t, _ = yuv_pairs(8, "420", "709")
    with pytest.raises(FileNotFoundError):
        port_vsf.fvvdp_video_source_file(str(tmp_path / "missing.png"), img, device="cpu")
    with pytest.raises(RuntimeError, match="reference is a video"):
        port_vsf.fvvdp_video_source_file(img, t, device="cpu")
    vs = port_vsf.fvvdp_video_source_file(img, img, device="cpu")
    assert vs.get_video_size() == (8, 8, 1) and vs.supports_random_access()


@pytest.mark.parametrize("entry", ["yuv", "dispatcher", "packed", "cli"])
def test_entry_points_run_on_the_card_and_raise_without_one(yuv_pairs, monkeypatch, entry):
    """The file entry points default to the card; with none they raise and
    name device="cpu" instead of moving to the CPU."""
    from fovvideovdp_tpu_torch import run_fvvdp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, r = yuv_pairs(8, "420", "709")
    header = np.array([1, 4, 4, 8, 420, 4, 4] + [100] * 24, dtype=np.uint16)
    run = {"yuv": lambda: port_vsy.fvvdp_video_source_yuv_file(t, r),
           "dispatcher": lambda: port_vsf.fvvdp_video_source_file(t, r),
           "packed": lambda: fv_port.fvvdp_video_source_packed_array(header, header, FPS),
           "cli": lambda: run_fvvdp.main(["--test", t, "--ref", r, "--quiet"])}[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run()
