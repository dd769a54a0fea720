"""Foveation of fovvideovdp_tpu_torch end to end on the CPU, with a fixed
fixation point and with a gaze per frame: ``fvvdp(foveated=True).predict``
against the reference goldens and against the JAX package's ``predict`` on
the same input.

Bars: the repo's own (tests/test_metric_e2e.py:13-17): |dJOD| <= 0.01,
Q_per_ch rtol 2e-3 / atol 2e-4.  The JAX package runs its jnp composition
(``pallas_cfg.forced(False)``) and, where the frame is at least 128 wide,
its Pallas kernels through the interpreter as well.
"""
import numpy as np
import pytest
import torch

import fovvideovdp_tpu as fv_jax
import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu.ops import pallas as pallas_cfg
from fovvideovdp_tpu_torch import csf, memory, state

torch.set_num_threads(2)

BAR = dict(rtol=2e-3, atol=2e-4)


def _carry_state(jax_metric, port_metric):
    params, luts = state.state_from_numpy(
        jax_metric.parameters,
        [{k: np.asarray(l[k]) for k in csf.LUT_FIELDS} for l in jax_metric._luts], "cpu")
    port_metric.load_state(params, luts)


def _content(kind, seed=30):
    rng = np.random.default_rng(seed)
    shape = (64, 160, 3, 6) if kind == "video" else (64, 160, 3)
    ref = rng.integers(0, 256, size=shape, dtype=np.uint8)
    test = np.clip(ref.astype(np.int16) + rng.integers(-14, 14, size=shape),
                   0, 255).astype(np.uint8)
    call = dict(dim_order="HWCF", frames_per_second=30) if kind == "video" \
        else dict(dim_order="HWC")
    return test, ref, call


def test_foveated_image_matches_golden(goldens):
    g = goldens("foveated_image")
    fv = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    Q, stats = fv.predict(g["test"], g["ref"], dim_order="HWC",
                          fixation_point=np.array([5, 7]))
    assert abs(Q - float(g["Q_jod"])) <= 0.01
    np.testing.assert_allclose(stats["Q_per_ch"], g["Q_per_ch"], **BAR)
    assert "foveated" in fv.get_info_string() and "non-foveated" not in fv.get_info_string()


def test_foveated_video_matches_golden_with_its_moving_gaze(goldens):
    """The reference's own score of a 6-frame video whose gaze moves from
    (0, 0) to (35, 39): the counterpart of
    tests/test_metric_e2e.py::test_foveated_video."""
    g = goldens("foveated_video")
    fv = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    assert g["gaze"].shape == (6, 2)
    Q, stats = fv.predict(g["test"], g["ref"], dim_order="HWCF", frames_per_second=30,
                          fixation_point=g["gaze"])
    assert abs(Q - float(g["Q_jod"])) <= 0.01
    np.testing.assert_allclose(stats["Q_per_ch"], g["Q_per_ch"], **BAR)
    assert fv._get_core(36, 40).moving_route == "banded"
    assert not fv._get_core(36, 40)._fov_table_cache       # no tables were built


def test_foveated_video_golden_with_its_first_gaze_held(goldens):
    """Held at the golden's first gaze point the port must agree with the
    JAX package on the same fixed point."""
    g = goldens("foveated_video")
    gaze = np.asarray(g["gaze"][0], np.float32)
    call = dict(dim_order="HWCF", frames_per_second=30, fixation_point=gaze)
    jm = fv_jax.fvvdp(display_name="htc_vive_pro", foveated=True)
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    _carry_state(jm, pm)
    with pallas_cfg.forced(False):
        Q_j, s_j = jm.predict(g["test"], g["ref"], **call)
    Q_p, s_p = pm.predict(g["test"], g["ref"], **call)
    assert abs(Q_p - Q_j) <= 0.01
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], **BAR)


@pytest.mark.parametrize("jax_mode", ["jnp", "interpret"])
@pytest.mark.parametrize("kind,gaze", [("video", None), ("image", None),
                                       ("video", (20.0, 50.0)), ("image", (150.0, 3.0))],
                         ids=["video-centre", "image-centre", "video-offcentre",
                              "image-offcentre"])
def test_fixed_gaze_matches_jax_predict(kind, gaze, jax_mode):
    test, ref, call = _content(kind)
    if gaze is not None:
        call["fixation_point"] = np.array(gaze)
    jm = fv_jax.fvvdp(display_name="htc_vive_pro", foveated=True)
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    _carry_state(jm, pm)
    mode = pallas_cfg.forced(False) if jax_mode == "jnp" \
        else pallas_cfg.forced(True, interpret=True)
    with mode:
        Q_j, s_j = jm.predict(test, ref, **call)
    Q_p, s_p = pm.predict(test, ref, **call)
    assert abs(Q_p - Q_j) <= 0.01
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], **BAR)
    np.testing.assert_array_equal(s_p["rho_band"], s_j["rho_band"])
    if kind == "image":
        assert np.all(s_p["Q_per_ch"][:, 1] == 0.0)


def test_fixation_point_matters_and_defaults_to_the_centre():
    test, ref, call = _content("image")
    # differences only in the left quarter of the frame
    test = ref.copy()
    test[:, :40] = np.clip(ref[:, :40].astype(np.int16) + 12, 0, 255).astype(np.uint8)
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    q_centre, _ = pm.predict(test, ref, **call)
    q_explicit, _ = pm.predict(test, ref, fixation_point=np.array([80, 32]), **call)
    q_left, _ = pm.predict(test, ref, fixation_point=np.array([20, 32]), **call)
    q_right, _ = pm.predict(test, ref, fixation_point=np.array([150, 32]), **call)
    assert q_centre == q_explicit
    assert q_left < q_centre < q_right          # looking at the fault shows it most
    q_plain, _ = fv_port.fvvdp(display_name="htc_vive_pro", device="cpu").predict(
        test, ref, **call)
    assert q_plain <= q_left


@pytest.mark.parametrize("shape", [(6, 2), (1, 2), (3,)])
def test_per_frame_fixation_point_raises(shape):
    """A row per frame scores (and equals the same point held); a trajectory
    shorter than the video and a shape that is neither (2,) nor (N, 2) raise."""
    test, ref, call = _content("video")
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    if shape == (6, 2):
        q_moving, _ = pm.predict(test, ref, fixation_point=np.full(shape, 10.0), **call)
        q_fixed, _ = pm.predict(test, ref, fixation_point=np.full((2,), 10.0), **call)
        assert np.isfinite(q_moving) and abs(q_moving - q_fixed) <= 1e-3
    elif shape == (1, 2):
        with pytest.raises(RuntimeError, match="1 per-frame rows but the video has 6"):
            pm.predict(test, ref, fixation_point=np.full(shape, 10.0), **call)
    else:
        with pytest.raises(ValueError, match="fixation_point"):
            pm.predict(test, ref, fixation_point=np.full(shape, 10.0), **call)
    # a metric that is not foveated ignores the point, but refuses a
    # trajectory shorter than the video, as the JAX package does
    plain = fv_port.fvvdp(display_name="htc_vive_pro", device="cpu")
    if shape == (1, 2):
        with pytest.raises(RuntimeError, match="1 per-frame rows but the video has 6"):
            plain.predict(test, ref, fixation_point=np.full(shape, 10.0), **call)
    else:
        q, _ = plain.predict(test, ref, fixation_point=np.full(shape, 10.0), **call)
        assert np.isfinite(q)


def test_table_cache_stays_bounded_and_is_dropped_with_the_state():
    test, ref, call = _content("image")
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    core = pm._get_core(160, 64)
    limit = memory.fov_cache_entries(core.device, core.fov_table_bytes())
    assert limit == 2
    knots = core._fov_trim[1] - core._fov_trim[0] + 1
    assert 4 <= knots < 32                       # the Y trim took hold
    assert core.fov_table_bytes() == knots * 2 * 4 * sum(
        h * w for h, w in core.plan.level_shapes[:core.plan.height])
    first = None
    for x in range(10, 150, 20):
        q, _ = pm.predict(test, ref, fixation_point=np.array([x, 30]), **call)
        first = q if first is None else first
        assert len(core._fov_table_cache) <= limit
    assert list(core._fov_table_cache) == [(110.0, 30.0), (130.0, 30.0)]
    # a point used again moves to the back of the queue and is not rebuilt
    tabs = core.fov_tables((110.0, 30.0))
    assert core.fov_tables((110.0, 30.0)) is tabs
    assert list(core._fov_table_cache) == [(130.0, 30.0), (110.0, 30.0)]
    # an evicted point gives the same score when it is built again
    q_again, _ = pm.predict(test, ref, fixation_point=np.array([10, 30]), **call)
    assert q_again == first
    pm.load_state(pm.parameters, pm._luts)
    assert not core._fov_table_cache and not pm._cores


def test_fov_tables_match_jax():
    jm = fv_jax.fvvdp(display_name="htc_vive_pro", foveated=True)
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    _carry_state(jm, pm)
    jc, pc = jm._get_core(160, 64), pm._get_core(160, 64)
    assert pc._fov_trim == jc._fov_trim and pc.fov_table_bytes() == jc.fov_table_bytes()
    jt, pt = jc.fov_tables((33.0, 21.0)), pc.fov_tables((33.0, 21.0))
    for bb in range(pc.plan.height):
        for cc in range(2):
            # the resolution magnification differs by up to 1.5e-4 relative
            # between the two frameworks (a difference of tangents, see
            # test_torch_fov_ops.py), 2e-4 octaves of rho; past the CSF's
            # cutoff log2 S falls by tens of units per octave, so the
            # tables differ by up to 7e-3 there (measured) and by 1e-6
            # where rho is flat.  On the same rho and ecc maps the two
            # reductions agree to 1e-5 (test_torch_fov_ops.py).
            np.testing.assert_allclose(pt[bb][cc].numpy(), np.asarray(jt[bb][cc]),
                                       rtol=0, atol=1e-2)
            assert pt[bb][cc].shape == (pc._fov_trim[1] - pc._fov_trim[0] + 1,) \
                + pc.plan.level_shapes[bb]


# ---------------------------------------------------------------------------
# a gaze per frame
# ---------------------------------------------------------------------------

def _moving_content(kind):
    """The inputs of tests/test_moving_gaze_fused.py:57-101."""
    H, W, F = 64, 256, 4
    if kind == "video":
        rng = np.random.RandomState(11)
        ref = rng.randint(0, 255, (H, W, 3, F), dtype=np.uint8)
        gaze = np.stack([np.linspace(5, W - 5, F), np.linspace(5, H - 5, F)], axis=1)
        call = dict(dim_order="HWCF", frames_per_second=30, fixation_point=gaze)
    else:
        rng = np.random.RandomState(12)
        ref = rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
        call = dict(dim_order="HWC", fixation_point=np.asarray([[30.0, 40.0]]))
    test = np.clip(ref.astype(np.int16) + rng.randint(-18, 18, ref.shape),
                   0, 255).astype(np.uint8)
    return test, ref, call


@pytest.mark.parametrize("jax_mode", ["jnp", "interpret"])
@pytest.mark.parametrize("kind", ["video", "image"])
def test_moving_gaze_matches_jax_predict(kind, jax_mode):
    """The JAX package's bars between its own two paths on these inputs
    (Q_per_ch rtol 2e-4 / atol 2e-5, |dJOD| <= 2e-3) hold for the port
    against either of them."""
    test, ref, call = _moving_content(kind)
    jm = fv_jax.fvvdp(display_name="htc_vive_pro", foveated=True)
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    _carry_state(jm, pm)
    mode = pallas_cfg.forced(False) if jax_mode == "jnp" \
        else pallas_cfg.forced(True, interpret=True)
    with mode:
        Q_j, s_j = jm.predict(test, ref, **call)
    Q_p, s_p = pm.predict(test, ref, **call)
    assert abs(Q_p - Q_j) <= 2e-3
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], rtol=2e-4, atol=2e-5)
    if kind == "image":
        assert np.all(s_p["Q_per_ch"][:, 1] == 0.0)


@pytest.mark.parametrize("kind", ["video", "image"])
def test_constant_per_frame_gaze_equals_the_fixed_gaze_route(kind):
    test, ref, call = _content(kind)
    n = 6 if kind == "video" else 1
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    q_fixed, s_fixed = pm.predict(test, ref, fixation_point=np.array([20.0, 50.0]), **call)
    core = pm._get_core(160, 64)
    assert len(core._fov_table_cache) == 1
    q_moving, s_moving = pm.predict(test, ref, fixation_point=np.tile([20.0, 50.0], (n, 1)),
                                    **call)
    assert not core._fov_table_cache             # the moving route frees the tables
    assert abs(q_moving - q_fixed) <= 1e-3
    np.testing.assert_allclose(s_moving["Q_per_ch"], s_fixed["Q_per_ch"], rtol=2e-4, atol=2e-5)
    # rows beyond the last frame are ignored
    q_long, _ = pm.predict(test, ref, fixation_point=np.tile([20.0, 50.0], (n + 3, 1)), **call)
    assert q_long == q_moving


def test_moving_gaze_blocks_take_their_own_rows():
    """Scored in blocks of 4 + 2 frames or in one block of 6: the same."""
    test, ref, call = _content("video")
    gaze = np.stack([np.linspace(0, 159, 6), np.linspace(63, -10, 6)], axis=1)
    one = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    two = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu",
                        block_frames=4)
    q1, s1 = one.predict(test, ref, fixation_point=gaze, **call)
    q2, s2 = two.predict(test, ref, fixation_point=gaze, **call)
    assert abs(q1 - q2) <= 1e-5
    np.testing.assert_allclose(s2["Q_per_ch"], s1["Q_per_ch"], rtol=1e-5, atol=1e-7)
    # and the gaze matters: held at its first point the score differs
    q_held, _ = one.predict(test, ref, fixation_point=gaze[0], **call)
    assert abs(q_held - q1) > 1e-3


@pytest.mark.parametrize("kind", ["video", "image"])
def test_moving_gaze_heatmap_matches_jax(kind):
    """heatmap="raw" with a gaze per frame: the composed route with the
    trilinear CSF of each frame, against the JAX package."""
    test, ref, call = _moving_content(kind)
    jm = fv_jax.fvvdp(display_name="htc_vive_pro", foveated=True, heatmap="raw")
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, heatmap="raw",
                       device="cpu")
    _carry_state(jm, pm)
    with pallas_cfg.forced(False):
        Q_j, s_j = jm.predict(test, ref, **call)
    Q_p, s_p = pm.predict(test, ref, **call)
    assert pm._get_core(256, 64).route == "composed"
    assert abs(Q_p - Q_j) <= 2e-3
    np.testing.assert_allclose(s_p["Q_per_ch"], s_j["Q_per_ch"], rtol=2e-4, atol=2e-5)
    hp, hj = s_p["heatmap"].astype(np.float32), np.asarray(s_j["heatmap"], np.float32)
    assert hp.shape == hj.shape == (1, 1, 4 if kind == "video" else 1, 64, 256)
    # float16 maps: half a unit in the last place of values up to 4
    np.testing.assert_allclose(hp, hj, rtol=2e-3, atol=2e-3)
    # the score does not depend on the heatmap
    plain = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    _carry_state(jm, plain)
    assert abs(plain.predict(test, ref, **call)[0] - Q_p) <= 1e-3


def test_moving_gaze_on_luts_with_a_monotone_axis_takes_the_composed_route():
    """mov_score indexes the rho and eccentricity axes by arithmetic; LUTs
    flagged non-uniform there go through the composition's cell search, with
    the same score on the shipped (in fact uniform) LUTs."""
    test, ref, call = _moving_content("video")
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    q_kernel_route, s_k = pm.predict(test, ref, **call)
    luts = [dict(l, _uniform=dict(l["_uniform"], rho_log=False)) for l in pm._luts]
    pm.load_state(pm.parameters, luts)
    core = pm._get_core(256, 64)
    assert core.route == "banded" and core.moving_route == "composed"
    q_composed, s_c = pm.predict(test, ref, **call)
    assert abs(q_composed - q_kernel_route) <= 1e-3
    np.testing.assert_allclose(s_c["Q_per_ch"], s_k["Q_per_ch"], rtol=2e-4, atol=2e-5)


def test_short_trajectory_raises():
    test, ref, call = _content("video")
    pm = fv_port.fvvdp(display_name="htc_vive_pro", foveated=True, device="cpu")
    with pytest.raises(RuntimeError, match="5 per-frame rows but the video has 6 frames"):
        pm.predict(test, ref, fixation_point=np.zeros((5, 2)), **call)
    with pytest.raises(ValueError, match="fixation_point"):
        pm.predict(test, ref, fixation_point=np.zeros((6, 3)), **call)
    with pytest.raises(ValueError, match="one row per frame"):
        pm._get_core(160, 64).score_frames(torch.zeros((2, 4, 64, 160)), 2,
                                           gaze=torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="either"):
        pm._get_core(160, 64).score_frames(torch.zeros((2, 4, 64, 160)), 2)
