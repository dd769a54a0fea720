"""The port's CLI (``python -m fovvideovdp_tpu_torch.run_fvvdp``, console
script ``fvvdp-torch``) on the CPU against the JAX package on the same
files: the printed JOD (to its 4 printed decimals), the ``--features`` JSON
(the same keys; Q_per_ch at rtol 2e-3 / atol 2e-4), ``--display ?``,
heatmaps, ``--metrics fvvdp pu-psnr`` and ``--checkpoint`` (what the JAX
CLI prints), and ``--all-devices``, which the port does not have yet: it
raises and names its ROADMAP item.
"""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fovvideovdp_tpu as fv_jax
from fovvideovdp_tpu.display_model import fvvdp_display_geometry as jax_geometry
from fovvideovdp_tpu.display_model import fvvdp_display_photometry as jax_photometry
from fovvideovdp_tpu.video_source_file import fvvdp_video_source_file as jax_file_source
from fovvideovdp_tpu_torch import fvvdp as port_fvvdp
from fovvideovdp_tpu_torch import run_fvvdp
from fovvideovdp_tpu_torch.display_model import fvvdp_display_geometry, fvvdp_display_photometry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_BAR = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture
def image_pair(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(7)
    ref = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-20, 20, ref.shape), 0, 255).astype(np.uint8)
    ref_p, tst_p = str(tmp_path / "ref.png"), str(tmp_path / "tst.png")
    cv2.imwrite(ref_p, ref[:, :, ::-1])
    cv2.imwrite(tst_p, tst[:, :, ::-1])
    return tst_p, ref_p


@pytest.fixture
def yuv_pair(tmp_path):
    """A small 10-bit 4:2:0 BT.2020 pair."""
    rng = np.random.RandomState(0)
    h, w, f = 32, 48, 4
    names = []
    for tag in ("test", "ref"):
        fname = tmp_path / f"{tag}_{w}x{h}_10b_420_2020_30fps.yuv"
        with open(fname, "wb") as fh:
            for _ in range(f):
                fh.write(rng.randint(64, 940, (h, w)).astype(np.uint16).tobytes())
                fh.write(rng.randint(64, 960, (h // 2, w // 2)).astype(np.uint16).tobytes())
                fh.write(rng.randint(64, 960, (h // 2, w // 2)).astype(np.uint16).tobytes())
        names.append(str(fname))
    return names


def _jax_scores(test, ref, display, **kw):
    """What the JAX package's CLI scores: its metric on its file source."""
    photometry = jax_photometry.load(display)
    geometry = jax_geometry.load(display)
    fv = fv_jax.fvvdp(display_photometry=photometry, display_geometry=geometry, **kw)
    vs = jax_file_source(test, ref, display_photometry=photometry,
                         resize_resolution=geometry.resolution)
    return fv, fv.predict_video_source(vs)


def _cli(capsys, *args):
    rc = run_fvvdp.main(list(args) + ["--device", "cpu"])
    return rc, capsys.readouterr().out.strip().splitlines()


def test_image_pair_features_and_heatmap(capsys, image_pair, tmp_path):
    tst, ref = image_pair
    out = tmp_path / "out"
    rc, lines = _cli(capsys, "--test", tst, "--ref", ref, "--display", "standard_fhd", "--quiet",
                     "--heatmap", "supra-threshold", "--features", "--output-dir", str(out))
    assert rc == 0
    fv, (Q_j, s_j) = _jax_scores(tst, ref, "standard_fhd", heatmap="supra-threshold")
    assert lines[-1] == f"{Q_j:0.4f}"
    assert (out / "tst_heatmap.png").exists()
    fv.write_features_to_json(s_j, str(tmp_path / "jax_fmap.json"))
    mine = json.loads((out / "tst_fmap.json").read_text())
    theirs = json.loads((tmp_path / "jax_fmap.json").read_text())
    assert sorted(mine) == sorted(theirs)
    for key in ("width", "height", "N_frames", "frames_per_second"):
        assert mine[key] == theirs[key]
    np.testing.assert_allclose(mine["rho_band"], theirs["rho_band"], rtol=1e-6)
    for key in (k for k in theirs if k.startswith("t")):
        np.testing.assert_allclose(mine[key], theirs[key], **GOLDEN_BAR)


def test_yuv_pair_jod(capsys, yuv_pair):
    rc, lines = _cli(capsys, "--test", yuv_pair[0], "--ref", yuv_pair[1],
                     "--display", "standard_hdr_pq")
    assert rc == 0
    _, (Q_j, _) = _jax_scores(*yuv_pair, "standard_hdr_pq")
    assert lines[-1] == f"FovVideoVDP={Q_j:0.4f} [JOD]"


def test_yuv_pair_video_heatmap_and_nframes(capsys, yuv_pair, tmp_path):
    pytest.importorskip("cv2")
    rc, lines = _cli(capsys, "--test", yuv_pair[0], "--ref", yuv_pair[1], "--display",
                     "standard_hdr_pq", "--quiet", "--nframes", "3", "--heatmap", "threshold",
                     "--output-dir", str(tmp_path))
    assert rc == 0 and 0.0 <= float(lines[-1]) <= 10.0
    assert (tmp_path / "test_48x32_10b_420_2020_30fps_heatmap.mp4").stat().st_size > 0


def _messages(caplog):
    out = [r.getMessage() for r in caplog.records]
    caplog.clear()
    return out


def test_display_list_and_verbose(caplog):
    with caplog.at_level(logging.INFO):
        assert run_fvvdp.main(["--display", "?"]) == 0
        listed = _messages(caplog)
        jax_photometry.list_displays()
        assert listed == _messages(caplog)
        assert "Photometric display model: standard_4k" in listed
        fvvdp_display_geometry.load("standard_4k").print()
        fvvdp_display_photometry.load("standard_hdr_pq").print()
        mine = _messages(caplog)
        jax_geometry.load("standard_4k").print()
        jax_photometry.load("standard_hdr_pq").print()
        assert mine == _messages(caplog)
    assert any(m.startswith("  Pixels-per-degree") for m in mine)


def test_module_runs_without_jax():
    code = ("import sys\n"
            "from fovvideovdp_tpu_torch import run_fvvdp\n"
            "rc = run_fvvdp.main(['--display', '?'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'fovvideovdp_tpu')]\n"
            "assert rc == 0 and not bad, (rc, bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=240)
    assert r.returncode == 0, r.stderr
    assert "standard_4k" in r.stderr


def _jax_cli(capsys, *args):
    """What the JAX package's CLI prints for the same arguments."""
    from fovvideovdp_tpu import run_fvvdp as jax_cli
    rc = jax_cli.main(list(args))
    return rc, capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("flags", [
    ["--metrics", "pu-psnr"], ["--metrics", "fvvdp", "pu-psnr"], ["--checkpoint", "state.ckpt"],
    ["--all-devices"]])
def test_unported_flags_raise_and_name_their_item(capsys, image_pair, tmp_path, flags):
    """``--metrics pu-psnr`` and ``--checkpoint`` once raised here, naming
    ROADMAP queue 1 item 5, and ``--all-devices`` naming item 1; now they
    print what the JAX CLI prints on the same pair (on an image,
    ``--checkpoint`` is ignored with a warning; ``--all-devices`` scores
    the pair on a mesh of CPU slots, the JAX CLI on its 8 virtual CPU
    devices)."""
    tst, ref = image_pair
    flags = [str(tmp_path / f) if f.endswith(".ckpt") else f for f in flags]
    args = ["--test", tst, "--ref", ref] + flags
    rc, lines = _cli(capsys, *args)
    rc_j, lines_j = _jax_cli(capsys, *args)
    assert rc == rc_j == 0 and lines == lines_j
    assert len(lines) == (2 if flags[-1] == "pu-psnr" and "fvvdp" in flags else 1)
    assert not os.path.exists(str(tmp_path / "state.ckpt"))


def test_metrics_and_checkpoint_on_a_video_pair(capsys, yuv_pair, tmp_path):
    """Both metrics and a checkpoint on a .yuv pair: the two lines the JAX
    CLI prints, the checkpoint used and removed."""
    ckpt = str(tmp_path / "state.ckpt")
    args = ["--test", yuv_pair[0], "--ref", yuv_pair[1], "--display", "standard_hdr_pq",
            "--metrics", "fvvdp", "pu-psnr", "--checkpoint", ckpt, "--block-frames", "2"]
    rc, lines = _cli(capsys, *args)
    rc_j, lines_j = _jax_cli(capsys, *args)
    assert rc == rc_j == 0 and lines == lines_j and len(lines) == 2
    assert lines[0].startswith("FovVideoVDP=") and lines[1].startswith("PU21-PSNR=")
    assert not os.path.exists(ckpt)


def test_checkpoint_takes_one_file_per_pair(monkeypatch, yuv_pair, tmp_path):
    seen = []
    real = run_fvvdp.pkg.fvvdp.predict_video_source

    def spy(self, vs, **kw):
        seen.append((kw.get("checkpoint_path"), vs.supports_random_access()))
        return real(self, vs, **kw)
    monkeypatch.setattr(run_fvvdp.pkg.fvvdp, "predict_video_source", spy)
    ckpt = str(tmp_path / "state.ckpt")
    rc = run_fvvdp.main(["--test", yuv_pair[0], yuv_pair[1], "--ref", yuv_pair[1],
                         "--display", "standard_hdr_pq", "--checkpoint", ckpt,
                         "--device", "cpu", "--quiet"])
    assert rc == 0 and seen == [(ckpt + ".0", True), (ckpt + ".1", True)]


def test_gpu_flag_selects_the_card(monkeypatch, image_pair):
    seen = {}

    class Recorder:
        def __init__(self, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(run_fvvdp.pkg, "fvvdp", Recorder)
    tst, ref = image_pair
    with pytest.raises(SystemExit):
        run_fvvdp.main(["--test", tst, "--ref", ref, "--gpu", "3"])
    assert seen["device"] == "cuda:3"


def test_missing_inputs_and_bad_heatmap(image_pair):
    tst, ref = image_pair
    assert run_fvvdp.main(["--device", "cpu"]) == 1
    assert run_fvvdp.main(["--test", tst, "--ref", ref, "--heatmap", "contours",
                           "--device", "cpu"]) == 1


@pytest.mark.parametrize("kwargs", [
    dict(do_temporal_channels=False), dict(ignore_boundary_pixels=True),
    dict(band_callback=lambda *a: None), dict(content_mapping="equirect"),
    dict(parameter_overrides={"contrast": "log"}),
    dict(parameter_overrides={"csf_sigma": -2.0}),
], ids=["temporal", "boundary", "callback", "content", "contrast", "csf"])
def test_unported_options_name_their_current_item(kwargs):
    """Options the port once lacked (each raised naming its ROADMAP item,
    3 or 4) score as the JAX package does: every case is ported now.
    "equirect" stands for each package's content mapping."""
    rng = np.random.RandomState(11)
    ref = (rng.rand(24, 40, 3, 4) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-20, 20, ref.shape),
                  0, 255).astype(np.uint8)
    call = dict(dim_order="HWCF", frames_per_second=30)
    j_kw, p_kw = dict(kwargs), dict(kwargs)
    if kwargs.get("content_mapping") == "equirect":
        from fovvideovdp_tpu.content_mapping import fvvdp_content_mapping_equirect as jax_cm
        from fovvideovdp_tpu_torch.content_mapping import fvvdp_content_mapping_equirect
        j_kw["content_mapping"], p_kw["content_mapping"] = (
            jax_cm(40, 24), fvvdp_content_mapping_equirect(40, 24))
    Q_p, s_p = port_fvvdp(device="cpu", **p_kw).predict(tst, ref, **call)
    Q_j, s_j = fv_jax.fvvdp(**j_kw).predict(tst, ref, **call)
    assert abs(Q_p - Q_j) <= 1e-4
    np.testing.assert_allclose(s_p["Q_per_ch"], np.asarray(s_j["Q_per_ch"]), **GOLDEN_BAR)
    if "do_temporal_channels" in kwargs:
        assert np.all(s_p["Q_per_ch"][:, 1] == 0)


def test_unported_call_options_name_their_current_item(image_pair, tmp_path):
    """``mesh`` once raised naming item 1, and the row split of an image
    over a 'space' axis > 1 naming item 2; now an image on a mesh of CPU
    slots scores as without one on either axis.  A checkpoint path, which
    once raised naming item 5, is ignored for an image, as the JAX package
    ignores it."""
    from fovvideovdp_tpu_torch.parallel import make_mesh
    fv = port_fvvdp(device="cpu")
    vs = run_fvvdp.fvvdp_video_source_file(*image_pair, device="cpu")
    q_one, s_one = fv.predict_video_source(vs)
    q_mesh, s_mesh = fv.predict_video_source(vs, mesh=make_mesh(["cpu"] * 2))
    assert q_mesh == q_one and np.array_equal(s_mesh["Q_per_ch"], s_one["Q_per_ch"])
    q_sp, s_sp = fv.predict_video_source(vs, mesh=make_mesh(["cpu"] * 2, data_parallel=1))
    np.testing.assert_allclose(q_sp, q_one, rtol=1e-6, atol=0)
    np.testing.assert_allclose(s_sp["Q_per_ch"], s_one["Q_per_ch"], rtol=1e-6, atol=0)
    ckpt = str(tmp_path / "state.ckpt")
    q, _ = fv.predict_video_source(vs, checkpoint_path=ckpt)
    assert q == fv.predict_video_source(vs)[0] and not os.path.exists(ckpt)


def test_np2vid_cv2_roundtrip(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(run_fvvdp.shutil, "which", lambda name: None)
    vid = np.random.RandomState(0).rand(6, 64, 96, 3).astype(np.float32)
    out = str(tmp_path / "heat.mp4")
    run_fvvdp.np2vid(vid, out, fps=30)
    cap = cv2.VideoCapture(out)
    assert cap.isOpened() and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) \
        == (96, 64)
    cap.release()


def test_np2vid_without_ffmpeg_or_cv2_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(run_fvvdp.shutil, "which", lambda name: None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="ffmpeg binary or the opencv-python"):
        run_fvvdp.np2vid(np.zeros((2, 8, 8, 3), np.float32), str(tmp_path / "h.mp4"), 30)


def test_np2img_writes_an_8bit_png(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = np.linspace(-0.5, 1.5, 4 * 5).reshape(1, 4, 5, 1).astype(np.float32)
    run_fvvdp.np2img(img, str(tmp_path / "h.png"))
    back = cv2.imread(str(tmp_path / "h.png"))
    assert back.shape == (4, 5, 3) and back.dtype == np.uint8
    assert back.min() == 0 and back.max() == 255


def test_wildcards(tmp_path):
    for n in ("b.png", "a.png", "c.jpg"):
        (tmp_path / n).write_bytes(b"")
    assert run_fvvdp.expand_wildcards([str(tmp_path / "*.png"), "x"]) == \
        [str(tmp_path / "a.png"), str(tmp_path / "b.png"), "x"]
    assert run_fvvdp.expand_wildcards("one") == ["one"]
