"""Scoring over a mesh (``fovvideovdp_tpu_torch.parallel``) on the CPU:
the cases of tests/test_parallel.py through the port, on meshes of four CPU
slots (``make_mesh(["cpu"] * 4, data_parallel=2 or 4)``, the port's
counterpart of the JAX tests' virtual CPU devices).

Each case is held two ways: against the same port metric without a mesh
(JOD and Q_per_ch at rtol 1e-6: the slots run the same plain versions on
the same frames, only in other blocks), and against the JAX package's
``predict(mesh=make_mesh())`` / ``predict_batch(mesh=...)`` on its 8
virtual CPU devices at the repo's bars (|dJOD| <= 0.01, Q_per_ch rtol 2e-3
/ atol 2e-4, tests/test_metric_e2e.py:13-17; heatmaps atol 2e-3, as
tests/test_parallel.py holds them).  Beside them: streaming with a frame
count the block does not divide, heatmaps on the host and on the device,
fixed and moving gaze, batches of images and clips in the three gaze modes,
a lone image, a checkpoint resumed under a mesh, log contrast, circular
padding, a source read on the metric's device, the shard functions, the
refusals in JAX's words, a slot's exception, and the launch counters under
threads.  The ``gpu`` cases run a mesh of two slots on ``cuda:0``.
"""
import contextlib
import functools
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu_torch import parallel
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops
from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.video_source import fvvdp_video_source, fvvdp_video_source_array

torch.set_num_threads(2)

SELF = dict(rtol=1e-6, atol=0)
JAX_JOD = 0.01
JAX_Q = dict(rtol=2e-3, atol=2e-4)
HEAT_ATOL = 2e-3
DP = [2, 4]
F, H, W = 14, 32, 48


def _content(shape, seed=3, noise=20):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(*shape) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-noise, noise, ref.shape),
                  0, 255).astype(np.uint8)
    return tst, ref


def _mesh(dp):
    return parallel.make_mesh(["cpu"] * 4, data_parallel=dp)


@functools.lru_cache(maxsize=None)
def _jax_predict(key):
    """The JAX package's predict on its default mesh (8 virtual CPU devices)."""
    import fovvideovdp_tpu as fv_jax
    from fovvideovdp_tpu.parallel import make_mesh
    kw, call, content = CASES[key]
    tst, ref = content()
    q, s = fv_jax.fvvdp(**kw).predict(tst, ref, mesh=make_mesh(), **call)
    return q, np.asarray(s["Q_per_ch"]), \
        None if "heatmap" not in s else np.asarray(s["heatmap"], np.float32)


def _video(f=F):
    return lambda: _content((f, H, W, 3))


GAZE = np.stack([np.linspace(5, W - 5, 8), np.linspace(5, H - 5, 8)], axis=1).astype(np.float32)
CALL = dict(dim_order="FHWC", frames_per_second=30)
# name: (metric kwargs, call kwargs, content)
CASES = {
    "stream_heatmap": (dict(display_name="standard_fhd", heatmap="threshold", block_frames=7),
                       CALL, _video()),
    "fixed_gaze": (dict(display_name="standard_hmd", foveated=True),
                   dict(CALL, fixation_point=np.asarray([12.0, 7.0], np.float32)),
                   _video(8)),
    "moving_gaze": (dict(display_name="standard_hmd", foveated=True),
                    dict(CALL, fixation_point=GAZE), _video(8)),
    "log_contrast": (dict(display_name="standard_fhd", block_frames=4,
                          parameter_overrides={"contrast": "log"}), CALL, _video()),
    "circular": (dict(display_name="standard_fhd", block_frames=4, temp_padding="circular"),
                 CALL, _video()),
    "image": (dict(display_name="standard_4k"), dict(dim_order="HWC"),
              lambda: _content((48, 64, 3), seed=7)),
}


def _check_self(got, want):
    (q2, s2), (q1, s1) = got, want
    np.testing.assert_allclose(q2, q1, **SELF)
    assert s2["Q_per_ch"].shape == s1["Q_per_ch"].shape
    np.testing.assert_allclose(s2["Q_per_ch"], s1["Q_per_ch"], **SELF)


def _check_jax(got, key):
    q, s = got
    q_j, Q_j, heat_j = _jax_predict(key)
    assert abs(q - q_j) <= JAX_JOD
    np.testing.assert_allclose(s["Q_per_ch"], Q_j, **JAX_Q)
    if heat_j is not None:
        np.testing.assert_allclose(np.asarray(s["heatmap"], np.float32), heat_j,
                                   atol=HEAT_ATOL)


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dp", DP)
def test_make_mesh_layout_as_jax(dp):
    import jax
    from fovvideovdp_tpu.parallel import make_mesh as jax_make_mesh
    mesh = _mesh(dp)
    j_mesh = jax_make_mesh(jax.devices("cpu")[:4], data_parallel=dp)
    assert mesh.axis_names == tuple(j_mesh.axis_names) == ("data", "space")
    assert mesh.devices.shape == j_mesh.devices.shape == (dp, 4 // dp)
    assert mesh.devices.size == mesh.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert parallel.make_mesh(["cpu"] * 4).devices.shape == (4, 1)


@pytest.mark.parametrize("dp", [3, 8])
def test_make_mesh_refuses_a_bad_data_parallel_as_jax(dp):
    import jax
    from fovvideovdp_tpu.parallel import make_mesh as jax_make_mesh
    with pytest.raises(ValueError) as j_err:
        jax_make_mesh(jax.devices("cpu")[:4], data_parallel=dp)
    with pytest.raises(ValueError) as p_err:
        parallel.make_mesh(["cpu"] * 4, data_parallel=dp)
    assert str(p_err.value) == str(j_err.value)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA card"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA card"):
        parallel.make_mesh(["cuda:0"])


def test_split_rows():
    split = parallel.sharding.split_rows
    assert split(14, 4) == [(0, 4), (4, 8), (8, 11), (11, 14)]
    assert split(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert split(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]


def test_a_slots_exception_reaches_the_caller():
    mesh = _mesh(4)
    done = []

    def ok(k):
        return lambda: done.append(k) or k

    def bad():
        raise ValueError("slot 2 failed")
    with pytest.raises(ValueError, match="slot 2 failed"):
        mesh.run([ok(0), ok(1), bad, ok(3)])
    assert sorted(done) == [0, 1, 3]      # the others ran to their end
    assert mesh.run([ok(0), None, ok(2), ok(3)]) == [0, None, 2, 3]


class _YieldingCounts(dict):
    """A counter store that gives the GIL away between reading a count and
    writing it back: unguarded, two threads' increments then overwrite
    each other."""

    def __getitem__(self, key):
        count = super().__getitem__(key)
        time.sleep(1e-5)
        return count


def test_launch_counters_lose_no_count_under_threads(monkeypatch):
    """8 threads counting launches at once (the stubbed store above in
    place of the kernels' launches), half of them under a slot's scope: the
    totals and each scope's counts are exact, since the counters take a
    lock."""
    n = 200
    monkeypatch.setattr(_lib, "_counts", _YieldingCounts(_lib._counts))
    _lib.reset_launch_counts()

    def work(k):
        with _lib.launch_scope(k) if k % 2 else contextlib.nullcontext():
            for _ in range(n):
                _lib.count_launch("gausspyr_reduce")
                _lib.count_launch("expand_score2")
    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    counts = _lib.launch_counts()
    assert counts["gausspyr_reduce"] == counts["expand_score2"] == 8 * n
    for k in range(8):
        assert _lib.launch_counts(k)["gausspyr_reduce"] == (n if k % 2 else 0)
    _lib.reset_launch_counts()
    assert _lib.launch_counts() == {k: 0 for k in _lib.KERNELS} == _lib.launch_counts(1)


# ----------------------------------------------------------------------
# one video streamed over the mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dp", DP)
def test_streaming_with_a_frame_count_the_block_does_not_divide(dp):
    """14 frames in blocks of 7, rounded up to 8 (the slot count's
    multiple): two blocks of 8 and 6 frames, split 2-2-2-2 and 2-2-1-1."""
    kw, call, content = CASES["stream_heatmap"]
    tst, ref = content()
    fv = fv_port.fvvdp(device="cpu", **kw)
    mesh = _mesh(dp)
    assert fv._pick_mesh_block(H, W, F, mesh) == 8
    want = fv.predict(tst, ref, **call)
    got = fv.predict(tst, ref, mesh=mesh, **call)
    _check_self(got, want)
    np.testing.assert_allclose(got[1]["heatmap"].astype(np.float32),
                               want[1]["heatmap"].astype(np.float32), atol=HEAT_ATOL)
    assert got[1]["heatmap"].shape == (1, 3, F, H, W)
    _check_jax(got, "stream_heatmap")


def test_device_heatmap_is_gathered_on_the_metrics_device():
    kw, call, content = CASES["stream_heatmap"]
    tst, ref = content()
    q1, s1 = fv_port.fvvdp(device="cpu", **kw).predict(tst, ref, **call)
    q2, s2 = fv_port.fvvdp(device="cpu", device_heatmap=True, **kw).predict(
        tst, ref, mesh=_mesh(4), **call)
    assert torch.is_tensor(s2["heatmap"]) and s2["heatmap"].device == torch.device("cpu")
    np.testing.assert_allclose(q2, q1, **SELF)
    np.testing.assert_allclose(s2["heatmap"].float().numpy(), s1["heatmap"].astype(np.float32),
                               atol=HEAT_ATOL)
    _check_jax((q2, dict(s2, heatmap=s2["heatmap"].numpy())), "stream_heatmap")


@pytest.mark.parametrize("case", ["fixed_gaze", "moving_gaze", "log_contrast", "circular"])
@pytest.mark.parametrize("dp", DP)
def test_streaming_cases_match_no_mesh_and_jax(case, dp):
    kw, call, content = CASES[case]
    tst, ref = content()
    fv = fv_port.fvvdp(device="cpu", **kw)
    want = fv.predict(tst, ref, **call)
    got = fv.predict(tst, ref, mesh=_mesh(dp), **call)
    _check_self(got, want)
    _check_jax(got, case)


def test_fixed_gaze_builds_its_tables_once_per_card():
    kw, call, content = CASES["fixed_gaze"]
    tst, ref = content()
    fv = fv_port.fvvdp(device="cpu", **kw)
    fv.predict(tst, ref, mesh=_mesh(4), **call)
    core = fv._get_core(W, H)
    assert list(core._fov_table_cache) == [(12.0, 7.0)] and not core._replicas


class _FrameSource(fvvdp_video_source):
    """An array source's per-frame methods only: blocks are read on the
    metric's device and each slot's frames copied from there."""

    def __init__(self, inner):
        self.inner = inner

    def get_video_size(self):
        return self.inner.get_video_size()

    def get_frames_per_second(self):
        return self.inner.get_frames_per_second()

    def get_test_frame(self, frame, device=None):
        return self.inner.get_test_frame(frame)

    def get_reference_frame(self, frame, device=None):
        return self.inner.get_reference_frame(frame)


@pytest.mark.parametrize("padding", ["replicate", "pingpong"])
def test_a_source_read_on_the_metrics_device(padding):
    tst, ref = _content((F, H, W, 3))
    fv = fv_port.fvvdp(display_name="standard_fhd", block_frames=3, temp_padding=padding,
                       device="cpu")
    q1, s1 = fv.predict(tst, ref, **CALL)
    src = _FrameSource(fvvdp_video_source_array(tst, ref, 30, dim_order="FHWC",
                                                display_photometry=fv.display_photometry,
                                                device="cpu"))
    assert src.luminance_at is None
    _check_self(fv.predict_video_source(src, mesh=_mesh(4)), (q1, s1))


def test_a_mesh_of_one_device_is_no_mesh():
    kw, call, content = CASES["stream_heatmap"]
    tst, ref = content()
    fv = fv_port.fvvdp(device="cpu", **kw)
    q1, s1 = fv.predict(tst, ref, **call)
    q2, s2 = fv.predict(tst, ref, mesh=parallel.make_mesh(["cpu"]), **call)
    assert q2 == q1 and np.array_equal(s2["Q_per_ch"], s1["Q_per_ch"])


# ----------------------------------------------------------------------
# a lone image
# ----------------------------------------------------------------------
def test_a_lone_image_on_a_data_mesh():
    kw, call, content = CASES["image"]
    tst, ref = content()
    fv = fv_port.fvvdp(device="cpu", **kw)
    want = fv.predict(tst, ref, **call)
    _lib.reset_launch_counts()
    got = fv.predict(tst, ref, mesh=_mesh(4), **call)
    _check_self(got, want)
    _check_jax(got, "image")


def test_shard_image_fn_scores_on_the_first_slot():
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu", heatmap="raw")
    core = fv._get_core(64, 48)
    rng = np.random.RandomState(1)
    T = torch.as_tensor(rng.rand(48, 64).astype(np.float32) * 200 + 0.1)
    Rf = T + 1.0
    Q1, h1 = core.score_image(T, Rf)
    Q2, h2 = parallel.shard_image_fn(core, _mesh(4))(T, Rf)
    assert torch.equal(Q1, Q2) and torch.equal(h1, h2)


# ----------------------------------------------------------------------
# the shard functions called directly
# ----------------------------------------------------------------------
def _filters():
    fl = temporal_ops.filter_len_for_fps(30.0)
    return temporal_ops.temporal_filters(30.0, fl), fl


def test_shard_video_block_fn_matches_one_device():
    filt, fl = _filters()
    core = fv_port.fvvdp(display_name="standard_fhd", device="cpu")._get_core(64, 48)
    rng = np.random.RandomState(0)
    B = 8
    pt = torch.as_tensor(rng.rand(B + fl - 1, 48, 64).astype(np.float32) * 100 + 0.1)
    pr = pt * 1.02 + 0.3
    taps = torch.as_tensor(filt)
    Q1, _, _, _ = core.video_step(pt[:fl - 1], pr[:fl - 1], pt[fl - 1:], pr[fl - 1:], taps)
    Q2, heat = parallel.shard_video_block_fn(core, filt, _mesh(2))(pt, pr)
    assert heat is None
    np.testing.assert_allclose(Q2.numpy(), Q1.numpy(), **SELF)
    step = parallel.shard_video_block_step_fn(core, filt, _mesh(4))
    Q3, _, ct, cr = step(pt[:fl - 1], pr[:fl - 1], pt[fl - 1:], pr[fl - 1:])
    np.testing.assert_allclose(Q3.numpy(), Q1.numpy(), **SELF)
    assert torch.equal(ct, pt[-(fl - 1):]) and torch.equal(cr, pr[-(fl - 1):])


def test_shard_video_block_step_fn_with_a_fixed_gaze_and_log_contrast():
    filt, fl = _filters()
    fv = fv_port.fvvdp(display_name="standard_hmd", foveated=True, device="cpu")
    core = fv._get_core(64, 48)
    rng = np.random.RandomState(2)
    B = 4
    pt = torch.as_tensor(rng.rand(B + fl - 1, 48, 64).astype(np.float32) * 100 + 0.1)
    pr = pt * 1.03 + 0.2
    taps = torch.as_tensor(filt)
    Q1, _, _, _ = core.video_step(pt[:fl - 1], pr[:fl - 1], pt[fl - 1:], pr[fl - 1:], taps,
                                  core.fov_tables((20.0, 30.0)))
    step = parallel.shard_video_block_step_fn(core, filt, _mesh(4), static_gaze=(20.0, 30.0))
    Q2, _, _, _ = step(pt[:fl - 1], pr[:fl - 1], pt[fl - 1:], pr[fl - 1:])
    np.testing.assert_allclose(Q2.numpy(), Q1.numpy(), **SELF)
    # log contrast: the step encodes the new frames, the carry comes encoded
    enc = lambda x: torch.log10(torch.clamp(x, min=1e-6))  # noqa: E731
    lc = fv_port.fvvdp(display_name="standard_fhd", device="cpu",
                       parameter_overrides={"contrast": "log"})._get_core(64, 48)
    Q3, _, _, _ = lc.video_step(enc(pt[:fl - 1]), enc(pr[:fl - 1]), enc(pt[fl - 1:]),
                                enc(pr[fl - 1:]), taps)
    Q4, _, ct, _ = parallel.shard_video_block_step_fn(lc, filt, _mesh(2), log_contrast=True)(
        enc(pt[:fl - 1]), enc(pr[:fl - 1]), pt[fl - 1:], pr[fl - 1:])
    np.testing.assert_allclose(Q4.numpy(), Q3.numpy(), **SELF)
    assert torch.equal(ct, enc(pt[-(fl - 1):]))


def test_block_not_divisible_raises_as_jax():
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as ge
    from fovvideovdp_tpu.parallel import make_mesh as jax_make_mesh
    from fovvideovdp_tpu.parallel import shard_video_block_fn as jax_block_fn
    filt, fl = _filters()
    pt = np.random.RandomState(0).rand(3 + fl - 1, 48, 64).astype(np.float32) + 0.1
    with pytest.raises(ValueError) as j_err:
        jax_block_fn(ge._make_core(64, 48), filt,
                     jax_make_mesh(jax.devices("cpu")[:4], data_parallel=2))(
            jnp.asarray(pt), jnp.asarray(pt))
    core = fv_port.fvvdp(display_name="standard_fhd", device="cpu")._get_core(64, 48)
    t = torch.as_tensor(pt)
    with pytest.raises(ValueError) as p_err:
        parallel.shard_video_block_fn(core, filt, _mesh(2))(t, t)
    assert str(p_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="not divisible by 4 devices"):
        parallel.shard_video_block_step_fn(core, filt, _mesh(2))(t[:fl - 1], t[:fl - 1],
                                                                 t[fl - 1:], t[fl - 1:])


# ----------------------------------------------------------------------
# refusals, in the JAX package's words
# ----------------------------------------------------------------------
REFUSALS = {
    "ablation": (dict(display_name="standard_fhd", do_temporal_channels=False), CALL,
                 lambda: _content((4, H, W, 3))),
    "foveated_image": (dict(display_name="standard_hmd", foveated=True),
                       dict(dim_order="HWC"), lambda: _content((H, W, 3))),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_as_jax(case):
    import fovvideovdp_tpu as fv_jax
    from fovvideovdp_tpu.parallel import make_mesh as jax_make_mesh
    kw, call, content = REFUSALS[case]
    tst, ref = content()
    with pytest.raises(Exception) as j_err:
        fv_jax.fvvdp(**kw).predict(tst, ref, mesh=jax_make_mesh(), **call)
    with pytest.raises(type(j_err.value)) as p_err:
        fv_port.fvvdp(device="cpu", **kw).predict(tst, ref, mesh=_mesh(4), **call)
    assert str(p_err.value) == str(j_err.value)


def test_an_image_split_over_space_names_its_item():
    kw, call, content = CASES["image"]
    tst, ref = content()
    fv = fv_port.fvvdp(device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\b"):
        fv.predict(tst, ref, mesh=_mesh(2), **call)
    with pytest.raises(NotImplementedError, match="'space' axis"):
        parallel.shard_image_fn(fv._get_core(64, 48), parallel.make_mesh(["cpu"] * 2, 1))


# ----------------------------------------------------------------------
# batches over the mesh
# ----------------------------------------------------------------------
NB, FB = 5, 4
PER_PAIR = np.stack([np.linspace(5, W - 5, NB), np.linspace(5, H - 5, NB)],
                    axis=1).astype(np.float32)
PER_FRAME = np.random.RandomState(13).rand(NB, FB, 2).astype(np.float32) * [W - 1, H - 1]
BATCH_CONTENT = {"images": ((NB, H, W, 3), dict(dim_order="BHWC")),
                 "clips": ((NB, FB, H, W, 3), dict(dim_order="BFHWC", frames_per_second=30))}
GAZES = {"none": None, "shared": np.array([10.0, 20.0], np.float32), "per_pair": PER_PAIR,
         "per_frame": PER_FRAME}


@functools.lru_cache(maxsize=None)
def _jax_batch(content, gaze):
    import fovvideovdp_tpu as fv_jax
    from fovvideovdp_tpu.parallel import make_mesh
    shape, call = BATCH_CONTENT[content]
    tst, ref = _content(shape, seed=9, noise=25)
    jm = fv_jax.fvvdp(display_name="standard_hmd", foveated=gaze != "none")
    jods, s = jm.predict_batch(tst, ref, mesh=make_mesh(), fixation_point=GAZES[gaze], **call)
    return np.asarray(jods), None if "Q_per_ch" not in s else np.asarray(s["Q_per_ch"])


# an image has one frame: its gaze per pair is its gaze per frame
@pytest.mark.parametrize("content,gaze", [(c, g) for c in BATCH_CONTENT for g in GAZES
                                          if (c, g) != ("images", "per_frame")])
def test_predict_batch_over_a_mesh(content, gaze):
    shape, call = BATCH_CONTENT[content]
    tst, ref = _content(shape, seed=9, noise=25)
    call = dict(call, fixation_point=GAZES[gaze])
    fv = fv_port.fvvdp(display_name="standard_hmd", foveated=gaze != "none", device="cpu")
    j1, s1 = fv.predict_batch(tst, ref, **call)
    for dp in DP:
        j2, s2 = fv.predict_batch(tst, ref, mesh=_mesh(dp), **call)
        assert j2.shape == (NB,) and set(s2) == set(s1)
        np.testing.assert_allclose(j2, j1, **SELF)
        if "Q_per_ch" in s1:
            np.testing.assert_allclose(s2["Q_per_ch"], s1["Q_per_ch"], **SELF)
    j_j, Q_j = _jax_batch(content, gaze)
    np.testing.assert_allclose(j2, j_j, rtol=0, atol=JAX_JOD)
    if Q_j is not None:
        np.testing.assert_allclose(s2["Q_per_ch"], Q_j, **JAX_Q)


def test_predict_batch_rows_go_to_their_slots(monkeypatch):
    """Each slot builds its own PairBatch of its rows on its device: no slot
    converts the whole batch."""
    from fovvideovdp_tpu_torch import video_source
    seen = []
    real = video_source.PairBatch.__init__

    def spy(self, test, reference, *a, **kw):
        seen.append(np.shape(test)[0])
        real(self, test, reference, *a, **kw)
    monkeypatch.setattr(video_source.PairBatch, "__init__", spy)
    tst, ref = _content((NB, H, W, 3), seed=9)
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    fv.predict_batch(tst, ref, dim_order="BHWC", mesh=_mesh(4))
    assert sorted(seen) == [1, 1, 1, 2]


def test_predict_batch_keeps_an_indexed_or_cpu_metric_on_its_device():
    """mesh=None means every visible card only for the unindexed "cuda"
    metric; a CPU metric scores on the CPU (no card is needed)."""
    tst, ref = _content((2, H, W, 3), seed=9)
    fv = fv_port.fvvdp(display_name="standard_fhd", device="cpu")
    jods, stats = fv.predict_batch(tst, ref, dim_order="BHWC")
    assert jods.shape == (2,) and "n_processes" not in stats


# ----------------------------------------------------------------------
# checkpoint and resume under a mesh
# ----------------------------------------------------------------------
class _CrashingSource(fvvdp_video_source_array):
    """Raises once it has served ``limit`` reads of more than one frame,
    whether blocks on its device or a slot's frames (``luminance_at``)."""

    def __init__(self, *a, limit=10**9, **kw):
        super().__init__(*a, **kw)
        self.limit, self.reads, self.frames = limit, 0, []
        self.lock = threading.Lock()

    def _count(self, idx):
        if len(idx) <= 1:        # the fingerprint's probe of frame 0
            return
        with self.lock:
            self.reads += 1
            if self.reads > self.limit:
                raise RuntimeError("simulated crash")
            self.frames.extend(int(i) for i in idx)

    def get_luminance_block(self, pos, n):
        self._count(np.arange(pos, pos + n))
        return super().get_luminance_block(pos, n)

    def luminance_at(self, indices, device):
        self._count(np.asarray(indices))
        return super().luminance_at(indices, device)


# reads before the crash: under the mesh, block 0's four slots and the
# carried frames the checkpoint saves; without, block 0 (the carry is the
# loop's)
READS_BEFORE_CRASH = {"mesh": 5, "no_mesh": 1}


@pytest.mark.parametrize("first", ["mesh", "no_mesh"])
def test_checkpoint_resumed_under_a_mesh(tmp_path, first):
    """Crashed after the first block of 8 frames by a run with or without a
    mesh; resumed under the mesh, it reads no frame of the first block but
    the second block's halo, and equals the clean mesh run bit for bit
    (crashed under the mesh) or at rtol 1e-6 (its first block scored
    without one), and the run without a mesh at rtol 1e-6."""
    tst, ref = _content((F, H, W, 3), seed=17)
    ckpt = str(tmp_path / "score.ckpt")
    fv = fv_port.fvvdp(display_name="standard_fhd", block_frames=8, device="cpu")
    mesh = _mesh(4)
    q_full, s_full = fv.predict(tst, ref, mesh=mesh, **CALL)

    def source(limit=10**9):
        return _CrashingSource(tst, ref, 30, dim_order="FHWC",
                               display_photometry=fv.display_photometry, device="cpu",
                               limit=limit)
    crash = dict(mesh=mesh) if first == "mesh" else {}
    fv_crash = fv if first == "mesh" else fv_port.fvvdp(display_name="standard_fhd",
                                                        block_frames=8, device="cpu")
    with pytest.raises(RuntimeError, match="simulated crash"):
        fv_crash.predict_video_source(source(limit=READS_BEFORE_CRASH[first]),
                                      checkpoint_path=ckpt, checkpoint_every=1, **crash)
    assert os.path.isfile(ckpt)
    resumed = source()
    q2, s2 = fv.predict_video_source(resumed, checkpoint_path=ckpt, mesh=mesh)
    assert not os.path.isfile(ckpt)
    fl = temporal_ops.filter_len_for_fps(30)
    assert min(resumed.frames) == 8 - (fl - 1) and resumed.reads == 4
    if first == "mesh":
        assert q2 == q_full and np.array_equal(s2["Q_per_ch"], s_full["Q_per_ch"])
    _check_self((q2, s2), (q_full, s_full))
    _check_self((q2, s2), fv.predict(tst, ref, **CALL))


# ----------------------------------------------------------------------
# the card: a mesh of two slots on cuda:0
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_two_slots_stream_as_one(cuda):
    from fovvideovdp_tpu_torch.ops import cuda as cuda_ops
    tst, ref = _content((16, 144, 256, 3))
    fv = fv_port.fvvdp(display_name="standard_fhd", block_frames=8)
    mesh = parallel.make_mesh(["cuda:0", "cuda:0"])
    q1, s1 = fv.predict(tst, ref, **CALL)
    cuda_ops.reset_launch_counts()
    q2, s2 = fv.predict(tst, ref, mesh=mesh, **CALL)
    n_levels = s1["Q_per_ch"].shape[0]
    for k in range(2):     # two blocks of 8 frames, 4 per slot each
        counts = cuda_ops.launch_counts(k)
        assert counts["temporal_pair"] == 2 and counts["expand_score2"] == 2 * n_levels
    assert q2 == q1 and np.array_equal(s2["Q_per_ch"], s1["Q_per_ch"])


@pytest.mark.gpu
@pytest.mark.parametrize("gaze", ["shared", "per_pair"])
def test_card_two_slots_batch_as_one(cuda, gaze):
    tst, ref = _content((NB, 64, 96, 3), seed=9)
    fv = fv_port.fvvdp(display_name="standard_hmd", foveated=True, device="cuda:0")
    fp = {"shared": np.array([30.0, 20.0], np.float32),
          "per_pair": np.stack([np.linspace(5, 90, NB), np.linspace(5, 60, NB)], 1)}[gaze]
    j1, _ = fv.predict_batch(tst, ref, dim_order="BHWC", fixation_point=fp)
    j2, _ = fv.predict_batch(tst, ref, dim_order="BHWC", fixation_point=fp,
                             mesh=parallel.make_mesh(["cuda:0", "cuda:0"]))
    np.testing.assert_allclose(j2, j1, rtol=1e-6, atol=0)
