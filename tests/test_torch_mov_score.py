"""The moving-gaze scorer of fovvideovdp_tpu_torch on the CPU: the plain
version of the mov_score kernel, the band data it works on and the CSF
functions beside it, each against the JAX package on the same inputs.

Inputs are those of tests/test_mov_score.py (levels 0-2 of a 256x64 plan,
seeds 0, 3, 7; level 2 is 16x64, below the Pallas kernel's minimum),
tests/test_csf_trilinear.py and tests/test_moving_gaze_fused.py, made with
numpy from the seed.  The JAX package runs its Pallas kernel through the
interpreter (``cfg.forced(True, interpret=True)``) where the kernel takes the
level, and its jnp composition everywhere.  The kernel itself is held
against the plain version on the card (``gpu`` tests of
tests/test_torch_package.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fvt
from fovvideovdp_tpu import core as jcore
from fovvideovdp_tpu import csf as jcsf
from fovvideovdp_tpu.ops import pallas as cfg
from fovvideovdp_tpu.ops.pallas import mov_score as jms
from fovvideovdp_tpu_torch import core as pcore
from fovvideovdp_tpu_torch import csf, state
from fovvideovdp_tpu_torch.ops import pyramid
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms

torch.set_num_threads(2)

W, H = 256, 64
SUMS = dict(rtol=5e-5, atol=1e-6)      # the bar of tests/test_mov_score.py


def _lut_arrays(lut):
    return {k: np.asarray(lut[k]) for k in csf.LUT_FIELDS}


def _port_core(jax_core):
    """The port's core built from the JAX core's state, on the same geometry
    (the one of ``__graft_entry__._make_core``)."""
    params, luts = state.state_from_numpy(
        jax_core.params, [_lut_arrays(l) for l in jax_core.luts], "cpu")
    geometry = fvt.fvvdp_display_geometry((W, H), distance_m=0.7472,
                                          diagonal_size_inches=30)
    plan = pyramid.PyramidPlan(W, H, geometry.get_ppd())
    return pcore.MetricCore(plan, params, luts, "cpu", peak_luminance=200.0,
                            geometry=geometry, foveated=True)


@pytest.fixture(scope="module")
def jax_core():
    import __graft_entry__ as ge
    return ge._make_core(W, H, foveated=True)


@pytest.fixture(scope="module")
def port_core(jax_core):
    return _port_core(jax_core)


@pytest.fixture(scope="module")
def off5_cores(jax_core):
    """Both packages' cores on a state whose omega = 5 LUT is the omega = 0
    LUT plus a constant, which takes the one-table arm."""
    lut5 = dict(jax_core.luts[0])
    lut5["S_log"] = jax_core.luts[0]["S_log"] + np.float32(0.375)
    jc = jcore.MetricCore(jax_core.plan, jax_core.params, (jax_core.luts[0], lut5),
                          geometry=jax_core.geometry, foveated=True, peak_luminance=200.0)
    return jc, _port_core(jc)


def _mov_inputs(jax_core, bb=0, F=3, seed=0):
    rng = np.random.RandomState(seed)
    h, w = jax_core.plan.level_shapes[bb]
    band = rng.randn(F, 4, h, w).astype(np.float32) * np.float32(0.05)
    L = (rng.rand(F, h, w) * 80 + 0.5).astype(np.float32)
    gaze_px = np.stack([np.linspace(5, w - 5, F), np.linspace(5, h - 5, F)],
                       axis=1).astype(np.float32)
    return band, L, gaze_px


def _jax_score(jax_core, bb, band, L, gaze_dir, fn):
    p = jax_core.params
    corr = 10.0 ** (p["sensitivity_correction"] / 20)
    return np.asarray(fn(
        jnp.asarray(band), jnp.asarray(L), jax_core._moving_band_data(bb),
        jax_core._band_view_dir[bb], jnp.asarray(gaze_dir), jax_core.luts[0],
        jax_core._fov_lut or jax_core.luts[0], p["mask_p"], p["mask_q_sust"],
        p["mask_q_trans"], p["mask_c"], corr, p["beta"]))


def _jax_gaze_dir(jax_core, gaze_px):
    return np.array(jnp.transpose(jax_core._gaze_directions(jnp.asarray(gaze_px))))


def _port_score_on_jax_data(jax_core, port_core, bb, band, L, gaze_dir):
    """The port's scorer fed the JAX core's static data, so that only the
    scorer's arithmetic is compared.  The JAX package scales the band by the
    level's gain; the port folds the gain into the correction."""
    jd = jax_core._moving_band_data(bb)
    meta = port_core._moving_band_data(bb)["meta"]
    assert (meta.ny, meta.nr) == (jd["ny"], jd["nr"])
    meta = meta._replace(score=port_core._score_meta(
        port_core._fov_lut or port_core.luts[0], bb)._replace(
            corr=10.0 ** (jax_core.params["sensitivity_correction"] / 20)))

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    V2t = None if jd["V2_5"] is None else t(jd["V2_5"])
    return ms.band_score2_mov(
        t(band), t(L), t(jax_core._band_view_dir[bb]), t(jd["t_r"]), t(gaze_dir),
        t(jd["V2"]), V2t, meta).numpy()


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bb,seed", [(0, 0), (1, 3), (2, 7)])
def test_mov_plain_matches_jax_kernel_and_composition(jax_core, port_core, bb, seed):
    band, L, gaze_px = _mov_inputs(jax_core, bb=bb, seed=seed)
    gaze_dir = _jax_gaze_dir(jax_core, gaze_px)
    got = _port_score_on_jax_data(jax_core, port_core, bb, band, L, gaze_dir)
    assert got.shape == (3, 2) and np.all(got > 0)
    want = _jax_score(jax_core, bb, band, L, gaze_dir, jms.band_score2_mov_jnp)
    np.testing.assert_allclose(got, want, **SUMS)
    h, w = jax_core.plan.level_shapes[bb]
    assert jms.supports(h, w) == (bb < 2)       # the port takes every level
    if jms.supports(h, w):
        with cfg.forced(True, interpret=True):
            kern = _jax_score(jax_core, bb, band, L, gaze_dir, jms.band_score2_mov_pallas)
        np.testing.assert_allclose(got, kern, **SUMS)


@pytest.mark.parametrize("bb,seed", [(0, 0), (1, 3), (2, 7)])
def test_mov_score_on_the_ports_own_data_matches_jax(jax_core, port_core, bb, seed):
    """Each package on its own static data (view directions, rho window,
    gaze directions).  The pixels-per-degree maps differ by up to 2e-4
    relative between the frameworks, which moves t_r; the sums then agree to
    5e-4."""
    band, L, gaze_px = _mov_inputs(jax_core, bb=bb, seed=seed)
    d = port_core._moving_band_data(bb)
    t = torch.from_numpy
    got = ms.band_score2_mov(t(band), t(L), port_core._band_view_dir[bb], d["t_r"],
                             port_core._gaze_directions(t(gaze_px)), d["V2"], d["V2_5"],
                             d["meta"]).numpy()
    gain = jax_core.plan.band_gain(bb, jax_core.plan.get_band_count())
    want = _jax_score(jax_core, bb, band * np.float32(gain), L,
                      _jax_gaze_dir(jax_core, gaze_px), jms.band_score2_mov_jnp)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("bb", [0, 2])
def test_mov_plain_matches_the_trilinear_block_oracle(port_core, jax_core, bb):
    """The windowed, trimmed LUT of the scorer against the whole LUT through
    sensitivity_trilinear_block: knots outside the window carry weight 0."""
    band, L, gaze_px = _mov_inputs(jax_core, bb=bb, seed=5)
    t = torch.from_numpy
    d = port_core._moving_band_data(bb)
    vd = port_core._band_view_dir[bb]
    gaze_dir = port_core._gaze_directions(t(gaze_px))
    got = ms.band_score2_mov(t(band), t(L), vd, d["t_r"], gaze_dir, d["V2"], d["V2_5"],
                             d["meta"])
    ecc = torch.sqrt((vd[0] - gaze_dir[:, 0, None, None]) ** 2
                     + (vd[1] - gaze_dir[:, 1, None, None]) ** 2)
    m = d["meta"].score
    want = torch.stack([
        bs._d_beta_sum(t(band)[:, 2 * cc], t(band)[:, 2 * cc + 1],
                       csf.sensitivity_trilinear_block(port_core.luts[cc],
                                                       port_core._band_rho[bb], t(L), ecc)
                       * m.corr, m, (m.q_s, m.q_t)[cc])
        for cc in range(2)], dim=-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)
    # and without the window, which the global-memory instance of the kernel takes
    full = port_core._moving_band_data(bb, windowed=False)
    n = port_core.luts[0]["S_log"].shape[0]
    assert (full["meta"].ny, full["meta"].nr, full["r_lo"], full["r_hi"]) == (n, n, 0, n - 1)
    assert full["V2"].shape == (n, n * n) and d["V2"].shape[1] < n * n // 4
    got_full = ms.band_score2_mov(t(band), t(L), vd, full["t_r"], gaze_dir, full["V2"],
                                  full["V2_5"], full["meta"])
    np.testing.assert_allclose(got_full.numpy(), got.numpy(), rtol=2e-5, atol=1e-6)


def test_forced_off5_arm_matches_jax(off5_cores):
    jc, pc = off5_cores
    for bb in (0, 2):
        jd, pd = jc._moving_band_data(bb), pc._moving_band_data(bb)
        assert jd["V2_5"] is None and pd["V2_5"] is None
        assert pd["meta"].off5 == pytest.approx(0.375, abs=1e-6)
        assert pd["meta"].off5 == pytest.approx(jd["off5"], abs=1e-7)
        band, L, gaze_px = _mov_inputs(jc, bb=bb, seed=2)
        gaze_dir = _jax_gaze_dir(jc, gaze_px)
        got = _port_score_on_jax_data(jc, pc, bb, band, L, gaze_dir)
        want = _jax_score(jc, bb, band, L, gaze_dir, jms.band_score2_mov_jnp)
        np.testing.assert_allclose(got, want, **SUMS)
    with cfg.forced(True, interpret=True):
        kern = _jax_score(jc, 0, *_mov_inputs(jc, seed=2)[:2],
                          _jax_gaze_dir(jc, _mov_inputs(jc, seed=2)[2]),
                          jms.band_score2_mov_pallas)
    band, L, gaze_px = _mov_inputs(jc, seed=2)
    got = _port_score_on_jax_data(jc, pc, 0, band, L, _jax_gaze_dir(jc, gaze_px))
    np.testing.assert_allclose(got, kern, **SUMS)


def test_shipped_luts_take_the_two_table_arm(jax_core, port_core):
    for bb in range(port_core.plan.height):
        d = port_core._moving_band_data(bb)
        assert d["meta"].off5 is None and d["V2_5"] is not None
        assert jax_core._moving_band_data(bb)["off5"] is None


@pytest.mark.parametrize("where", ["pixel_centre", "outside", "far_outside"])
def test_gaze_on_a_pixel_centre_and_outside_the_frame(jax_core, port_core, where):
    bb = 1
    band, L, _ = _mov_inputs(jax_core, bb=bb, seed=9)
    h, w = jax_core.plan.level_shapes[bb]
    vd = np.asarray(jax_core._band_view_dir[bb])
    if where == "pixel_centre":
        # the gaze direction equals a pixel's view direction: ecc = 0 there
        gaze_dir = np.stack([vd[:, 3, 7], vd[:, h - 1, w - 1], vd[:, 0, 0]]).astype(np.float32)
    elif where == "outside":
        gaze_dir = _jax_gaze_dir(jax_core, np.array(
            [[0.0, 0.0], [-40.0, 10.0], [W + 30.0, H + 5.0]], np.float32))
    else:
        gaze_dir = np.array([[170.0, 0.0], [0.0, -170.0], [-89.0, 89.0]], np.float32)
    got = _port_score_on_jax_data(jax_core, port_core, bb, band, L, gaze_dir)
    want = _jax_score(jax_core, bb, band, L, gaze_dir, jms.band_score2_mov_jnp)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **SUMS)


@pytest.mark.parametrize("bad", ["L_bkg", "gaze", "contrast"])
def test_a_nan_input_gives_a_nan_sum_for_its_frame_only(jax_core, port_core, bad):
    """The decision for every scorer: NaN in, NaN out (torch.clamp and
    jnp.clip keep a NaN; the kernels' clamps are written to keep it too).
    The JAX package's Pallas kernel does the same; its jnp composition agrees
    for L_bkg and the contrast, and maps a NaN gaze to eccentricity 0 (its
    gradient-safe square root), which the port does not copy."""
    bb = 2
    band, L, gaze_px = _mov_inputs(jax_core, bb=bb, seed=4)
    gaze_dir = _jax_gaze_dir(jax_core, gaze_px)
    clean = _port_score_on_jax_data(jax_core, port_core, bb, band, L, gaze_dir)
    if bad == "L_bkg":
        L[1, 3, 5] = np.nan
    elif bad == "gaze":
        gaze_dir[1, 0] = np.nan
    else:
        band[1, 0, 2, 2] = np.nan
    got = _port_score_on_jax_data(jax_core, port_core, bb, band, L, gaze_dir)
    nan_at = np.zeros((3, 2), bool)
    nan_at[1, :1 if bad == "contrast" else 2] = True
    np.testing.assert_array_equal(np.isnan(got), nan_at)
    np.testing.assert_array_equal(got[~nan_at], clean[~nan_at])
    if bad != "gaze":
        want = _jax_score(jax_core, bb, band, L, gaze_dir, jms.band_score2_mov_jnp)
        np.testing.assert_array_equal(np.isnan(want), nan_at)


def test_band_scorers_keep_a_nan_too(port_core):
    """band_score and band_score2_fov share the decision."""
    band, L = (torch.from_numpy(a) for a in _mov_inputs_like(2, 12, 20))
    L[1, 4, 4] = float("nan")
    meta = port_core._fov_meta[0]
    table = torch.linspace(1.0, 3.0, 18)
    one = bs.band_score(band[:, 0], band[:, 1], L, table, meta, meta.q_s)
    tabs = table[:, None, None].expand(18, 12, 20).contiguous()
    two = bs.band_score2_fov(band, L, tabs, tabs, meta)
    assert torch.isnan(one[1]) and torch.isfinite(one[0])
    assert torch.isnan(two[1]).all() and torch.isfinite(two[0]).all()


def _mov_inputs_like(F, h, w, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(F, 4, h, w).astype(np.float32) * np.float32(0.05),
            (rng.rand(F, h, w) * 80 + 0.5).astype(np.float32))


def test_image_arm_zero_transient_scores_zero(port_core):
    bb = 0
    h, w = port_core.plan.level_shapes[bb]
    band, L = _mov_inputs_like(1, h, w)
    band[:, 2:] = 0.0
    d = port_core._moving_band_data(bb)
    got = ms.band_score2_mov(
        torch.from_numpy(band), torch.from_numpy(L), port_core._band_view_dir[bb], d["t_r"],
        port_core._gaze_directions(torch.tensor([[30.0, 40.0]])), d["V2"], d["V2_5"], d["meta"])
    assert got.shape == (1, 2) and got[0, 0] > 0 and got[0, 1] == 0.0


def test_wrapper_rejects_what_the_kernel_cannot_take(port_core):
    bb = 2
    h, w = port_core.plan.level_shapes[bb]
    band, L = (torch.from_numpy(a) for a in _mov_inputs_like(2, h, w))
    d = port_core._moving_band_data(bb)
    vd, gaze = port_core._band_view_dir[bb], torch.zeros((2, 2))
    good = (band, L, vd, d["t_r"], gaze, d["V2"], d["V2_5"], d["meta"])
    assert ms.band_score2_mov(*good).shape == (2, 2)

    def swapped(i, v):
        return good[:i] + (v,) + good[i + 1:]

    for args in (swapped(0, band[:, :3]), swapped(1, L[:1]), swapped(2, vd[:1]),
                 swapped(3, d["t_r"][:-1]), swapped(4, gaze[:1]),
                 swapped(5, d["V2"][:, :-1]), swapped(6, None),
                 swapped(7, d["meta"]._replace(off5=0.1))):
        with pytest.raises(ValueError):
            ms.band_score2_mov(*args)
    with pytest.raises(TypeError):
        ms.band_score2_mov(*swapped(3, d["t_r"].double()))
    with pytest.raises(RuntimeError):
        ms.band_score2_mov(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                             for a in good))


# ---------------------------------------------------------------------------
# the band data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bb", [0, 1, 2])
def test_moving_band_data_matches_jax(jax_core, port_core, bb):
    jd, pd = jax_core._moving_band_data(bb), port_core._moving_band_data(bb)
    meta = pd["meta"]
    assert (meta.ny, meta.nr) == (jd["ny"], jd["nr"])
    assert meta.nr == pd["r_hi"] - pd["r_lo"] + 1
    np.testing.assert_array_equal(pd["V2"].numpy(), jd["V2"])
    np.testing.assert_array_equal(pd["V2_5"].numpy(), jd["V2_5"])
    assert meta.off5 is None and jd["off5"] is None
    assert pd["V2"].shape == (32, meta.ny * meta.nr) and pd["V2"].is_contiguous()
    # the port's own rho map carries the recorded difference of tangents
    # (resolution magnification up to 2e-4 relative, 3e-4 octaves of rho,
    # 7e-4 of a knot spacing of 0.39 octaves)
    np.testing.assert_allclose(pd["t_r"].numpy(), jd["t_r"], rtol=0, atol=2e-3)
    assert pd["t_r"].shape == port_core.plan.level_shapes[bb]
    assert float(pd["t_r"].min()) >= 0.0 and float(pd["t_r"].max()) <= meta.nr - 1
    # the kernel's scalars against the JAX package's
    jm = jms._mov_meta(jd, jax_core.luts[0], jax_core._fov_lut or jax_core.luts[0],
                       *(jax_core.params[k] for k in ("mask_p", "mask_q_sust", "mask_q_trans",
                                                      "mask_c")), 1.0, jax_core.params["beta"])
    s = meta.score
    assert (s.y0, s.dy, s.Ymin, s.Ymax, meta.es0, meta.des, meta.emin, meta.emax, meta.off5,
            s.p, s.q_s, s.q_t, s.c10) == jm[:13]
    assert (s.beta, meta.ny, meta.nr) == jm[14:]
    # fed the JAX package's rho map, the window and the coordinate are its own
    fed = _port_core(jax_core)
    fed._band_rho[bb] = torch.from_numpy(np.array(jax_core._band_rho[bb]))
    fd = fed._moving_band_data(bb)
    r_lo, r_hi, _ = jcsf.rho_window_weights(jax_core.luts[0], np.asarray(jax_core._band_rho[bb]))
    assert (fd["r_lo"], fd["r_hi"]) == (r_lo, r_hi) == (pd["r_lo"], pd["r_hi"])
    np.testing.assert_allclose(fd["t_r"].numpy(), jd["t_r"], rtol=0, atol=4e-6)


@pytest.mark.parametrize("bb", [0, 2])
def test_rho_coordinate_is_the_hat_form_of_the_window_weights(port_core, bb):
    """hat(t_r - k) equals the 2-point weight on knot k of the window."""
    d = port_core._moving_band_data(bb)
    r_lo, r_hi, w_r = csf.rho_window_weights(port_core.luts[0], port_core._band_rho[bb])
    assert (r_lo, r_hi) == (d["r_lo"], d["r_hi"])
    k = np.arange(r_hi - r_lo + 1, dtype=np.float32)
    hat = np.clip(1.0 - np.abs(d["t_r"].numpy()[..., None] - k), 0.0, 1.0)
    np.testing.assert_allclose(hat, w_r, rtol=0, atol=4e-6)
    np.testing.assert_allclose(w_r.sum(-1), 1.0, atol=1e-6)


def test_band_data_is_cached_on_the_cores_device(port_core):
    d = port_core._moving_band_data(1)
    assert port_core._moving_band_data(1) is d
    assert port_core._moving_band_data(1, windowed=False) is not d
    for k in ("V2", "V2_5", "t_r"):
        assert d[k].device == port_core.device and d[k].dtype == torch.float32


def test_gaze_directions_match_jax(jax_core, port_core):
    gaze_px = np.array([[0.0, 0.0], [35.0, 39.0], [255.0, 63.0], [-20.0, 100.0]], np.float32)
    got = port_core._gaze_directions(torch.from_numpy(gaze_px))
    assert got.shape == (4, 2) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _jax_gaze_dir(jax_core, gaze_px),
                               rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# csf functions
# ---------------------------------------------------------------------------

def _monotone(lut, flag):
    """The same LUT with its rho and eccentricity axes declared non-uniform,
    which sends both packages through the reference cell search."""
    out = dict(lut)
    out["_uniform"] = dict(lut["_uniform"], rho_log=flag, ecc_sqrt=flag, Y_log=flag)
    return out


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "monotone"])
@pytest.mark.parametrize("bb", [0, 2])
def test_rho_window_weights_match_jax(jax_core, port_core, bb, uniform):
    rho = np.asarray(jax_core._band_rho[bb])
    jl, pl = _monotone(jax_core.luts[0], uniform), _monotone(port_core.luts[0], uniform)
    j_lo, j_hi, j_w = jcsf.rho_window_weights(jl, rho)
    p_lo, p_hi, p_w = csf.rho_window_weights(pl, torch.from_numpy(rho.copy()))
    assert (p_lo, p_hi) == (j_lo, j_hi)
    np.testing.assert_array_equal(p_w, j_w)
    assert p_w.dtype == np.float32 and p_w.shape == rho.shape + (j_hi - j_lo + 1,)
    # the dense rows of the whole grid are zero outside the window
    # (tests/test_moving_gaze_fused.py:17-34)
    q = torch.log2(torch.clamp(torch.from_numpy(rho.copy()).reshape(-1), pl["rho"][0],
                             pl["rho"][-1]))
    dense = csf._grid_weights(q, pl["rho_log"], uniform).numpy()
    assert np.abs(dense[:, :p_lo]).max(initial=0.0) == 0.0
    assert np.abs(dense[:, p_hi + 1:]).max(initial=0.0) == 0.0
    np.testing.assert_allclose(p_w.reshape(-1, p_w.shape[-1]), dense[:, p_lo:p_hi + 1],
                               atol=4e-6)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "monotone"])
def test_ecc_weights_match_jax(jax_core, port_core, uniform):
    ecc = np.random.RandomState(5).uniform(0, 130, (500,)).astype(np.float32)
    ecc[:3] = (0.0, 1e-8, 200.0)
    jl, pl = _monotone(jax_core.luts[0], uniform), _monotone(port_core.luts[0], uniform)
    want = np.asarray(jcsf.ecc_weights(jl, jnp.asarray(ecc)))
    got = csf.ecc_weights(pl, torch.from_numpy(ecc)).numpy()
    assert got.shape == (500, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "monotone"])
@pytest.mark.parametrize("omega", [0, 1], ids=["omega0", "omega5"])
def test_sensitivity_trilinear_block_matches_jax(jax_core, port_core, omega, uniform,
                                                 monkeypatch):
    """The inputs of tests/test_csf_trilinear.py::test_trilinear_block_matches_per_frame;
    the second case runs in several passes over the frames."""
    rng = np.random.RandomState(7)
    jl, pl = _monotone(jax_core.luts[omega], uniform), _monotone(port_core.luts[omega], uniform)
    F, h, w = 5, 19, 23
    rho = 2.0 ** rng.uniform(-3, 6, (h, w)).astype(np.float32)
    L = 10.0 ** rng.uniform(-3, 4, (F, h, w)).astype(np.float32)
    ecc = rng.uniform(0, 120, (F, h, w)).astype(np.float32)
    t = torch.from_numpy
    got = csf.sensitivity_trilinear_block(pl, t(rho), t(L), t(ecc)).numpy()
    want = np.asarray(jcsf.sensitivity_trilinear_block(
        jl, jnp.asarray(rho), jnp.asarray(L), jnp.asarray(ecc)))
    assert got.shape == (F, h, w)
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)

    h2, w2 = 70, 131
    rho2 = 2.0 ** rng.uniform(-3, 6, (h2, w2)).astype(np.float32)
    L2 = 10.0 ** rng.uniform(-2, 3, (3, h2, w2)).astype(np.float32)
    ecc2 = rng.uniform(0, 100, (h2, w2)).astype(np.float32)     # broadcast over frames
    want = np.asarray(jcsf.sensitivity_trilinear_block(
        jl, jnp.asarray(rho2), jnp.asarray(L2), jnp.asarray(ecc2)))
    whole = csf.sensitivity_trilinear_block(pl, t(rho2), t(L2), t(ecc2)).numpy()
    monkeypatch.setattr(csf, "_TRILINEAR_CHUNK", h2 * w2)       # one frame per pass
    passes = csf.sensitivity_trilinear_block(pl, t(rho2), t(L2), t(ecc2)).numpy()
    np.testing.assert_array_equal(passes, whole)
    np.testing.assert_allclose(whole, want, rtol=5e-5, atol=1e-6)


def test_sensitivity_trilinear_block_matches_golden(goldens, port_core):
    """The reference's interp3 values (tests/test_csf_trilinear.py)."""
    g = goldens("csf_lut")
    t = torch.from_numpy
    for cc in (0, 1):
        rho = np.broadcast_to(g["rho"], g["L"].shape).astype(np.float32)
        ecc = np.broadcast_to(g["ecc"], g["L"].shape).astype(np.float32)
        got = torch.stack([csf.sensitivity_trilinear_block(
            port_core.luts[cc], t(rho.reshape(-1)[i:i + 1]),
            t(g["L"].astype(np.float32).reshape(-1)[None, i:i + 1]),
            t(ecc.reshape(-1)[None, i:i + 1]))[0, 0] for i in range(0, rho.size, 37)])
        want = g[f"S_omega{(0, 5)[cc]}"].reshape(-1)[::37]
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=1e-5)


def test_two_knots_at_the_ends_and_on_nan():
    u = torch.tensor([0.0, 0.25, 3.0, 2.999, float("nan")])
    i0, i1, f = csf.two_knots(u, 4)
    assert i0.tolist() == [0, 0, 3, 2, 0] and i1.tolist() == [1, 1, 3, 3, 1]
    np.testing.assert_allclose(f[:4].numpy(), [0.0, 0.25, 0.0, 0.999], atol=1e-6)
    assert torch.isnan(f[4])
