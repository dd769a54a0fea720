"""Checkpoint and resume of the port's streaming loop on the CPU, against
the port's own uninterrupted run and the JAX package.

The cases of tests/test_checkpoint.py through fovvideovdp_tpu_torch (crash
and resume, a fingerprint mismatch, another display, the heatmap refusal),
and beside them: a resume under another ``block_frames``, log contrast, a
fixed and a moving gaze, pingpong padding, the array source's residency
limit at 0, a file source with ``preload=True``, the refusal of a source
without random access, the warning for an image and the ablation, a corrupt
file, and a process killed by SIGKILL that a rerun resumes.

Bars: a resumed run equals the uninterrupted port run bit for bit (the same
block size) or at rtol 1e-5 (another block size), and the JAX package's
``predict`` at the repo's bars (|dJOD| <= 0.01, Q_per_ch rtol 2e-3 / atol
2e-4, tests/test_metric_e2e.py:13-17).
"""
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fovvideovdp_tpu_torch import fvvdp
from fovvideovdp_tpu_torch.video_source import fvvdp_video_source_array
from fovvideovdp_tpu_torch.video_source_file import fvvdp_video_source_file

torch.set_num_threads(2)

JOD_TOL = 0.01
Q_BAR = dict(rtol=2e-3, atol=2e-4)
F, H, W = 12, 32, 48


class CrashingSource(fvvdp_video_source_array):
    """Raises after serving ``limit`` luminance blocks: a simulated kill."""

    def __init__(self, *a, limit=10**9, **kw):
        super().__init__(*a, **kw)
        self.limit = limit
        self.calls = 0
        self.positions = []

    def get_luminance_block(self, pos, n):
        self.calls += 1
        if self.calls > self.limit:
            raise RuntimeError("simulated crash")
        self.positions.append((int(pos), int(n)))
        return super().get_luminance_block(pos, n)

    def block_starts(self):
        # blocks only: the 1-frame fingerprint probe is no re-read of scored frames
        return [p for p, n in self.positions if n > 1]


def _content(shape=(F, H, W, 3)):
    rng = np.random.RandomState(17)
    ref = (rng.rand(*shape) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-20, 20, ref.shape),
                  0, 255).astype(np.uint8)
    return tst, ref


def _source(fv, tst, ref, **kw):
    return CrashingSource(tst, ref, 30, dim_order="FHWC",
                          display_photometry=fv.display_photometry, device="cpu", **kw)


def _crash(fv, tst, ref, ckpt, limit=3, **call):
    """Probe + limit - 1 blocks, then the crash; the checkpoint stays."""
    with pytest.raises(RuntimeError, match="simulated crash"):
        fv.predict_video_source(_source(fv, tst, ref, limit=limit), checkpoint_path=ckpt,
                                checkpoint_every=1, **call)
    assert os.path.isfile(ckpt), "a crash leaves the checkpoint behind"


def _jax_predict(tst, ref, **kw):
    import fovvideovdp_tpu as fv_jax
    call = {k: kw.pop(k) for k in ("fixation_point",) if k in kw}
    q, s = fv_jax.fvvdp(display_name="standard_fhd", **kw).predict(
        tst, ref, dim_order="FHWC", frames_per_second=30, **call)
    return q, np.asarray(s["Q_per_ch"])


def test_resume_after_crash(tmp_path):
    tst, ref = _content()
    ckpt = str(tmp_path / "score.ckpt")
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu")
    q_full, s_full = fv.predict(tst, ref, dim_order="FHWC", frames_per_second=30)
    _crash(fv, tst, ref, ckpt)
    resumed = _source(fv, tst, ref)
    q2, s2 = fv.predict_video_source(resumed, checkpoint_path=ckpt, checkpoint_every=1)
    assert q2 == q_full
    assert np.array_equal(s2["Q_per_ch"], s_full["Q_per_ch"])
    # the resumed run reads nothing of the scored prefix
    assert resumed.block_starts() == [8]
    assert not os.path.isfile(ckpt), "the checkpoint is removed on completion"
    q_j, Q_j = _jax_predict(tst, ref)
    assert abs(q2 - q_j) <= JOD_TOL
    np.testing.assert_allclose(s2["Q_per_ch"], Q_j, **Q_BAR)


def test_checkpoint_fingerprint_mismatch(tmp_path):
    tst, ref = _content()
    ckpt = str(tmp_path / "score.ckpt")
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu")
    _crash(fv, tst, ref, ckpt, limit=2)
    # another frame count: the stale checkpoint is ignored
    q_short, _ = fv.predict(tst[:8], ref[:8], dim_order="FHWC", frames_per_second=30)
    vs = _source(fv, tst[:8], ref[:8])
    q2, _ = fv.predict_video_source(vs, checkpoint_path=ckpt)
    assert q2 == q_short
    assert vs.block_starts() == [0, 4]
    q_j, _ = _jax_predict(tst[:8], ref[:8])
    assert abs(q2 - q_j) <= JOD_TOL


def test_checkpoint_rejects_other_display(tmp_path):
    """Same geometry and frame count, another display model: the luminance
    probe refuses the stale state, and the run scores from scratch."""
    tst, ref = _content()
    ckpt = str(tmp_path / "score.ckpt")
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu")
    _crash(fv, tst, ref, ckpt, limit=2)
    fv2 = fvvdp(display_name="standard_hdr_pq", block_frames=4, device="cpu")
    q_clean, _ = fv2.predict(tst, ref, dim_order="FHWC", frames_per_second=30)
    vs = _source(fv2, tst, ref)
    q2, _ = fv2.predict_video_source(vs, checkpoint_path=ckpt)
    assert q2 == q_clean
    assert vs.block_starts() == [0, 4, 8]
    import fovvideovdp_tpu as fv_jax
    q_j, _ = fv_jax.fvvdp(display_name="standard_hdr_pq").predict(
        tst, ref, dim_order="FHWC", frames_per_second=30)
    assert abs(q2 - q_j) <= JOD_TOL


def test_checkpoint_rejects_heatmap(tmp_path):
    tst, ref = _content()
    fv = fvvdp(display_name="standard_fhd", heatmap="raw", device="cpu")
    vs = _source(fv, tst, ref)
    with pytest.raises(RuntimeError, match="heatmap"):
        fv.predict_video_source(vs, checkpoint_path=str(tmp_path / "c"))


def test_resume_under_another_block_size(tmp_path):
    """The fingerprint leaves the block size out: a process that picks
    another block resumes the checkpoint."""
    tst, ref = _content()
    ckpt = str(tmp_path / "score.ckpt")
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu")
    q_full, s_full = fv.predict(tst, ref, dim_order="FHWC", frames_per_second=30)
    _crash(fv, tst, ref, ckpt)
    fv3 = fvvdp(display_name="standard_fhd", block_frames=3, device="cpu")
    vs = _source(fv3, tst, ref)
    q2, s2 = fv3.predict_video_source(vs, checkpoint_path=ckpt)
    assert vs.positions == [(0, 1), (8, 3), (11, 1)]    # the probe, then two blocks
    np.testing.assert_allclose(s2["Q_per_ch"], s_full["Q_per_ch"], rtol=1e-5)
    assert abs(q2 - q_full) <= 1e-5


CASES = {
    "log_contrast": (dict(parameter_overrides={"contrast": "log"}), {}),
    "fixed_gaze": (dict(foveated=True), dict(fixation_point=np.array([30.0, 12.0]))),
    "moving_gaze": (dict(foveated=True),
                    dict(fixation_point=np.stack([np.linspace(5, 40, F),
                                                  np.linspace(4, 28, F)], 1))),
    "pingpong": (dict(temp_padding="pingpong"), {}),
    "circular": (dict(temp_padding="circular"), {}),
}
# luminance-block fetches before the crash: the probe and the blocks before
# frame 8, of which circular padding fetches the first by index
# (ops.temporal.padding_indices)
CRASH_AFTER = {"circular": 2}


@pytest.mark.parametrize("case", list(CASES))
def test_resume_equals_the_clean_run(tmp_path, case):
    kw, call = CASES[case]
    tst, ref = _content()
    ckpt = str(tmp_path / "score.ckpt")
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu", **kw)
    q_full, s_full = fv.predict(tst, ref, dim_order="FHWC", frames_per_second=30, **call)
    _crash(fv, tst, ref, ckpt, limit=CRASH_AFTER.get(case, 3), **call)
    if case == "log_contrast":
        # carried frames are saved as the loop carries them: log10 luminance
        with np.load(ckpt) as d:
            assert d["carry_t"].max() < 3.0 and d["carry_t"].shape == (7, H, W)
    vs = _source(fv, tst, ref)
    q2, s2 = fv.predict_video_source(vs, checkpoint_path=ckpt, **call)
    assert q2 == q_full
    assert np.array_equal(s2["Q_per_ch"], s_full["Q_per_ch"])
    assert vs.block_starts() == [8] and not os.path.isfile(ckpt)
    jkw = dict(parameter_overrides=kw["parameter_overrides"]) \
        if "parameter_overrides" in kw else {k: v for k, v in kw.items()}
    q_j, Q_j = _jax_predict(tst, ref, **jkw, **call)
    assert abs(q2 - q_j) <= JOD_TOL
    np.testing.assert_allclose(s2["Q_per_ch"], Q_j, **Q_BAR)


def test_resume_with_the_pair_on_the_host(tmp_path, monkeypatch):
    """The array source's residency limit at 0: the raw pair stays on the
    host and blocks are sliced from it (on the card, staged and
    prefetched); the probe's 1-frame fetch changes nothing."""
    monkeypatch.setattr(fvvdp_video_source_array, "DEVICE_PRELOAD_LIMIT_BYTES", 0)
    tst, ref = _content()
    ckpt = str(tmp_path / "score.ckpt")
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu")
    assert not _source(fv, tst, ref).resident
    q_full, s_full = fv.predict(tst, ref, dim_order="FHWC", frames_per_second=30)
    q_ck, s_ck = fv.predict_video_source(_source(fv, tst, ref), checkpoint_path=ckpt,
                                         checkpoint_every=1)
    assert q_ck == q_full and np.array_equal(s_ck["Q_per_ch"], s_full["Q_per_ch"])
    _crash(fv, tst, ref, ckpt)
    q2, s2 = fv.predict_video_source(_source(fv, tst, ref), checkpoint_path=ckpt)
    assert q2 == q_full and np.array_equal(s2["Q_per_ch"], s_full["Q_per_ch"])


def _write_yuv(path, frames):
    """8-bit 4:2:0 frames (n, h, w) of luma, chroma 128."""
    with open(path, "wb") as f:
        for y in frames:
            f.write(y.tobytes())
            f.write(np.full((y.shape[0] // 2, y.shape[1] // 2), 128, np.uint8).tobytes())
            f.write(np.full((y.shape[0] // 2, y.shape[1] // 2), 128, np.uint8).tobytes())


class CrashingFileSource(fvvdp_video_source_file):
    def __init__(self, *a, limit=10**9, **kw):
        super().__init__(*a, **kw)
        self.limit, self.calls, self.starts = limit, 0, []

    def get_luminance_block(self, start, count):
        self.calls += 1
        if self.calls > self.limit:
            raise RuntimeError("simulated crash")
        if count > 1:
            self.starts.append(int(start))
        return super().get_luminance_block(start, count)


def test_resume_from_a_file_source(tmp_path):
    tst, ref = _content((F, H, W))
    paths = [str(tmp_path / f"{tag}_{W}x{H}_8b_420_709_30fps.yuv") for tag in ("t", "r")]
    for p, clip in zip(paths, (tst, ref)):
        _write_yuv(p, clip)
    ckpt = str(tmp_path / "score.ckpt")
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu")

    def source(**kw):
        return CrashingFileSource(*paths, display_photometry="standard_fhd", preload=True,
                                  device="cpu", **kw)
    q_full, s_full = fv.predict_video_source(source())
    with pytest.raises(RuntimeError, match="simulated crash"):
        fv.predict_video_source(source(limit=3), checkpoint_path=ckpt, checkpoint_every=1)
    vs = source()
    q2, s2 = fv.predict_video_source(vs, checkpoint_path=ckpt)
    assert q2 == q_full and np.array_equal(s2["Q_per_ch"], s_full["Q_per_ch"])
    assert vs.starts == [8] and not os.path.isfile(ckpt)
    from fovvideovdp_tpu import fvvdp as jax_fvvdp
    from fovvideovdp_tpu.video_source_file import fvvdp_video_source_file as jax_file
    q_j, _ = jax_fvvdp(display_name="standard_fhd").predict_video_source(
        jax_file(*paths, display_photometry="standard_fhd", preload=True))
    assert abs(q2 - q_j) <= JOD_TOL


class StreamOnly(fvvdp_video_source_array):
    def supports_random_access(self):
        return False


def test_a_source_without_random_access_is_refused(tmp_path):
    tst, ref = _content()
    fv = fvvdp(display_name="standard_fhd", device="cpu")
    vs = StreamOnly(tst, ref, 30, dim_order="FHWC", display_photometry=fv.display_photometry,
                    device="cpu")
    with pytest.raises(RuntimeError, match="random-access"):
        fv.predict_video_source(vs, checkpoint_path=str(tmp_path / "c"))
    # without a checkpoint it scores
    assert np.isfinite(fv.predict_video_source(vs)[0])


@pytest.mark.parametrize("kind", ["image", "ablation"])
def test_image_and_ablation_warn_and_score(tmp_path, caplog, kind):
    tst, ref = _content()
    ckpt = str(tmp_path / "c")
    if kind == "image":
        fv = fvvdp(display_name="standard_fhd", device="cpu")
        args, fps = (tst[0], ref[0]), 0
        dims = "HWC"
    else:
        fv = fvvdp(display_name="standard_fhd", do_temporal_channels=False, device="cpu")
        args, fps, dims = (tst, ref), 30, "FHWC"
    q_plain, _ = fv.predict(*args, dim_order=dims, frames_per_second=fps)
    vs = fvvdp_video_source_array(*args, fps, dim_order=dims,
                                  display_photometry=fv.display_photometry, device="cpu")
    with caplog.at_level(logging.WARNING):
        q, _ = fv.predict_video_source(vs, checkpoint_path=ckpt)
    assert q == q_plain and not os.path.exists(ckpt)
    assert any("streaming video path only" in r.getMessage() for r in caplog.records)


def test_a_corrupt_checkpoint_starts_fresh(tmp_path, caplog):
    tst, ref = _content()
    ckpt = tmp_path / "score.ckpt"
    ckpt.write_bytes(b"not a checkpoint")
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu")
    q_full, _ = fv.predict(tst, ref, dim_order="FHWC", frames_per_second=30)
    vs = _source(fv, tst, ref)
    with caplog.at_level(logging.WARNING):
        q, _ = fv.predict_video_source(vs, checkpoint_path=str(ckpt))
    assert q == q_full and vs.block_starts() == [0, 4, 8] and not ckpt.exists()
    assert any("could not read checkpoint" in r.getMessage() for r in caplog.records)


def test_sigkill_and_resume(tmp_path):
    """A scoring process killed by SIGKILL mid-video (the worker kills
    itself after its third block fetch) leaves the checkpoint; a rerun
    resumes from it, reads only the unscored block and lands on the
    uninterrupted run's JOD; the worker imports no JAX."""
    worker = os.path.join(os.path.dirname(__file__), "_torch_checkpoint_worker.py")
    ckpt = str(tmp_path / "kill.ckpt")

    def run(*args):
        return subprocess.run([sys.executable, worker, *args], capture_output=True,
                              text=True, timeout=300)

    r1 = run(ckpt, "3")
    assert r1.returncode == -9, (r1.returncode, r1.stderr[-2000:])
    assert os.path.isfile(ckpt), "SIGKILL leaves the checkpoint on disk"
    r2 = run(ckpt)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert not os.path.isfile(ckpt), "the checkpoint is removed on completion"
    r3 = run(str(tmp_path / "clean.ckpt"))
    assert r3.returncode == 0, r3.stderr[-2000:]
    out, clean = (dict(line.split("=", 1) for line in r.stdout.split() if "=" in line)
                  for r in (r2, r3))
    assert out["FINAL_Q"] == clean["FINAL_Q"]
    assert out["STARTS"] == "8" and clean["STARTS"] == "0,4,8"
    assert int(out["FETCHES"]) < int(clean["FETCHES"])
    assert out["FORBIDDEN"] == clean["FORBIDDEN"] == "0"


@pytest.mark.gpu
def test_card_resume_equals_the_clean_run(tmp_path):
    """On the card: bit for bit against the uninterrupted run, and the
    resumed run's launches cover only the remaining block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fovvideovdp_tpu_torch.ops import cuda as cuda_ops
    tst, ref = _content((F, 144, 256, 3))
    ckpt = str(tmp_path / "score.ckpt")
    fv = fvvdp(display_name="standard_fhd", block_frames=4)
    q_full, s_full = fv.predict(tst, ref, dim_order="FHWC", frames_per_second=30)

    def source(**kw):
        return CrashingSource(tst, ref, 30, dim_order="FHWC",
                              display_photometry=fv.display_photometry, **kw)
    with pytest.raises(RuntimeError, match="simulated crash"):
        fv.predict_video_source(source(limit=3), checkpoint_path=ckpt, checkpoint_every=1)
    cuda_ops.reset_launch_counts()
    q2, s2 = fv.predict_video_source(source(), checkpoint_path=ckpt)
    counts = cuda_ops.launch_counts()
    n_levels = s_full["Q_per_ch"].shape[0]
    assert counts["temporal_pair"] == 1 and counts["expand_score2"] == n_levels
    assert q2 == q_full and np.array_equal(s2["Q_per_ch"], s_full["Q_per_ch"])
