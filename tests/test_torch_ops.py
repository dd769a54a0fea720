"""fovvideovdp_tpu_torch ops against the JAX package, on the CPU.

Each port function runs its plain PyTorch version (CPU tensors) on the same
seeded numpy inputs as its JAX counterpart.  Where the JAX function reaches
a Pallas kernel it runs as tests/test_band_pipeline.py runs it: through the
Pallas interpreter (``pallas_cfg.forced(True, interpret=True)``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fvt
from fovvideovdp_tpu import csf as jcsf
from fovvideovdp_tpu import display_model as jdm
from fovvideovdp_tpu.ops import masking as jmask
from fovvideovdp_tpu.ops import pallas as pallas_cfg
from fovvideovdp_tpu.ops import pyramid as jpyr
from fovvideovdp_tpu.ops import temporal as jtemp
from fovvideovdp_tpu.ops.pallas import score_math as jsm
from fovvideovdp_tpu_torch import csf, state
from fovvideovdp_tpu_torch.core import MetricCore
from fovvideovdp_tpu_torch.display_model import fvvdp_display_geometry
from fovvideovdp_tpu_torch.ops import masking, pyramid
from fovvideovdp_tpu_torch.ops import temporal as ptemp
from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
from fovvideovdp_tpu_torch.ops.cuda import score_math
from fovvideovdp_tpu_torch.ops.cuda.reduce import gausspyr_reduce
from fovvideovdp_tpu_torch.ops.cuda.temporal import temporal_pair

torch.set_num_threads(2)

REDUCE_SHAPES = [(2, 4, 96, 256), (1, 4, 67, 131), (1, 4, 135, 240),
                 (1, 4, 68, 120), (1, 4, 34, 60), (1, 4, 17, 30),
                 (1, 3, 50, 126), (1, 2, 2, 2), (1, 1, 3, 5)]


def _rand(shape, seed, scale=100.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32) * scale + offset)


def _jax_core(w, h):
    import __graft_entry__ as ge
    return ge._make_core(w, h)


def _port_core(jax_core):
    """Port core on the JAX core's geometry, parameters and LUTs."""
    g = jax_core.geometry
    geometry = fvvdp_display_geometry(g.resolution, distance_m=g.distance_m,
                                      diagonal_size_inches=30)
    params, luts = state.state_from_numpy(
        jax_core.params,
        [{k: np.asarray(l[k]) for k in csf.LUT_FIELDS} for l in jax_core.luts], "cpu")
    plan = pyramid.PyramidPlan(jax_core.plan.W, jax_core.plan.H, geometry.get_ppd())
    return MetricCore(plan, params, luts, "cpu", peak_luminance=jax_core.peak_luminance)


@pytest.mark.parametrize("shape", REDUCE_SHAPES)
def test_reduce_matches_jax(shape):
    x = _rand(shape, 1)
    want = np.asarray(jpyr._gausspyr_reduce_jnp(jnp.asarray(x)))
    got = gausspyr_reduce(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_reduce_matches_jax_pallas_kernel():
    from fovvideovdp_tpu.ops.pallas.reduce import gausspyr_reduce_pallas
    x = _rand((1, 4, 136, 384), 2)
    with pallas_cfg.forced(True, interpret=True):
        want = np.asarray(gausspyr_reduce_pallas(jnp.asarray(x)))
    got = gausspyr_reduce(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", REDUCE_SHAPES)
def test_expand_matches_jax(shape):
    *lead, H, W = shape
    x = _rand(tuple(lead) + (-(-H // 2), -(-W // 2)), 3)
    want = np.asarray(jpyr.gausspyr_expand(jnp.asarray(x), (H, W)))
    got = pyramid.gausspyr_expand(torch.from_numpy(x), (H, W)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("hw", [(96, 144), (67, 131), (160, 384), (96, 256), (67, 256)])
def test_expand_score2_matches_jax_pallas_kernel(hw):
    from fovvideovdp_tpu.ops.pallas import band_pipeline as jbp
    H, W = hw
    core = _jax_core(W, H)
    p = core.params
    tables = np.asarray(core._score_tables[0])
    assert tables.shape == (2, 19)
    lut = core._score_lut
    sens_corr = 10.0 ** (p["sensitivity_correction"] / 20.0)
    gf = _rand((2, 4, H, W), 4, 80.0, 0.5)
    gc = _rand((2, 4, -(-H // 2), -(-W // 2)), 5, 80.0, 0.5)
    args = (p["mask_p"], p["mask_q_sust"], p["mask_q_trans"], p["mask_c"], sens_corr,
            p["beta"])
    with pallas_cfg.forced(True, interpret=True):
        want = np.asarray(jbp.expand_score2(jnp.asarray(gf), jnp.asarray(gc), tables,
                                            lut, *args), np.float64)
    meta = bs.score_meta({k: np.asarray(lut[k]) for k in ("Y_log", "Y")}, *args)
    got = bp.expand_score2(torch.from_numpy(gf), torch.from_numpy(gc),
                           torch.from_numpy(tables), meta).double().numpy()
    rel = np.max(np.abs(got - want) / np.abs(want))
    assert rel < 1e-4, rel


@pytest.mark.parametrize("fps,ncarry", [(30, 7), (60, 14), (30, 0)])
def test_temporal_pair_matches_jax_pallas_kernel(fps, ncarry):
    fl = jtemp.filter_len_for_fps(fps)
    taps = jtemp.temporal_filters(fps, fl)
    B = 6 if ncarry else 6 + fl - 1
    ct, cr = _rand((ncarry, 24, 128), 6), _rand((ncarry, 24, 128), 7)
    nt, nr = _rand((B, 24, 128), 8), _rand((B, 24, 128), 9)
    with pallas_cfg.forced(True, interpret=True):
        if ncarry:
            want = jtemp.temporal_channels_pair(*map(jnp.asarray, (ct, nt, cr, nr)), taps)
        else:  # the padded-window kernel (empty carry)
            want = jtemp.temporal_channels(jnp.asarray(nt), jnp.asarray(nr), taps)
    got = temporal_pair(*map(torch.from_numpy, (ct, nt, cr, nr)), torch.from_numpy(taps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fps", [4, 24, 25, 30, 60, 120])
def test_temporal_filters_match_jax(fps):
    fl = ptemp.filter_len_for_fps(fps)
    assert fl == jtemp.filter_len_for_fps(fps)
    np.testing.assert_array_equal(ptemp.temporal_filters(fps, fl, 0.5, 0.06),
                                  jtemp.temporal_filters(fps, fl, 0.5, 0.06))


@pytest.mark.parametrize("mode", ["replicate", "circular", "pingpong"])
@pytest.mark.parametrize("n_frames,fl", [(12, 8), (5, 8), (60, 15), (2, 3)])
def test_padding_indices_match_jax(mode, n_frames, fl):
    np.testing.assert_array_equal(ptemp.padding_indices(n_frames, fl, mode),
                                  jtemp.padding_indices(n_frames, fl, mode))


@pytest.mark.parametrize("hw", [(96, 144), (2160, 3840), (1080, 1920)])
def test_band_tables_and_trim_match_jax(hw):
    H, W = hw
    jcore = _jax_core(W, H)
    pcore = _port_core(jcore)
    assert pcore.plan.level_shapes == jcore.plan.level_shapes
    np.testing.assert_array_equal(pcore.plan.get_freqs(), jcore.plan.get_freqs())
    for bb in range(jcore.plan.height):
        np.testing.assert_array_equal(
            np.stack(pcore._band_tables[bb]), np.stack(jcore._band_tables[bb][:2]))
        np.testing.assert_array_equal(pcore._score_tables[bb].numpy(),
                                      np.asarray(jcore._score_tables[bb]))
    for k in ("Y_log", "Y"):
        np.testing.assert_array_equal(csf._np(pcore._score_lut[k]),
                                      np.asarray(jcore._score_lut[k]))


def test_reduce_lut_to_1d_matches_jax_off_axis():
    jlut = jcsf.CSFCache().get(0.0, -1.5, 0.604562)
    _, (plut,) = state.state_from_numpy({}, [{k: np.asarray(jlut[k]) for k in csf.LUT_FIELDS}],
                                        "cpu")
    for rho, ecc in [(0.3, 0.0), (7.7, 3.0), (60.0, 12.5), (1e3, 1e3)]:
        np.testing.assert_array_equal(csf.reduce_lut_to_1d(plut, rho, ecc),
                                      jcsf.reduce_lut_to_1d(jlut, rho, ecc))
    assert plut["_uniform"] == jlut["_uniform"]


@pytest.mark.parametrize("display", ["standard_4k", "standard_hdr_pq", "absolute",
                                     "gamma"])
def test_eotf_matches_jax(display):
    rng = np.random.default_rng(10)
    V = rng.random((37, 53), dtype=np.float32) * 1.2 - 0.1
    if display == "absolute":
        V = V * 5000.0
        jd, pd = jdm.fvvdp_display_photo_absolute(4000), fvt.fvvdp_display_photo_absolute(4000)
    elif display == "gamma":
        jd = jdm.fvvdp_display_photo_eotf(300, contrast=800, EOTF="gamma", gamma=2.4)
        pd = fvt.fvvdp_display_photo_eotf(300, contrast=800, EOTF="gamma", gamma=2.4)
    else:
        jd = jdm.fvvdp_display_photometry.load(display)
        pd = fvt.fvvdp_display_photometry.load(display)
    want = np.asarray(jd.forward(jnp.asarray(V)))
    got = pd.forward(torch.from_numpy(V)).numpy()
    rtol = 1e-5 if display == "standard_hdr_pq" else 1e-6   # PQ: two chained powers
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("display", ["standard_4k", "standard_fhd", "htc_vive_pro",
                                     "standard_hdr_linear"])
def test_display_geometry_matches_jax(display):
    assert fvt.fvvdp_display_geometry.load(display).get_ppd() == \
        jdm.fvvdp_display_geometry.load(display).get_ppd()


def test_pool_to_jod_matches_jax():
    Q = _rand((7, 2, 9), 11, 0.5, 1e-3)
    params = (0.25, 1.0, 0.666092, 1.0, -0.0161713, -0.228)
    want = float(jmask.pool_to_jod(jnp.asarray(Q), *params))
    got = float(masking.pool_to_jod(torch.from_numpy(Q), *params))
    assert abs(got - want) <= 1e-6


def test_masking_model_matches_jax():
    T, R = _rand((2, 33, 41), 12, 2.0, -1.0), _rand((2, 33, 41), 13, 2.0, -1.0)
    N = _rand((2, 33, 41), 14, 0.05, 1e-3)
    want = np.asarray(jmask.apply_masking_model(*map(jnp.asarray, (T, R, N)), 2.4, 2.43685,
                                                -0.973838))
    got = masking.apply_masking_model(*map(torch.from_numpy, (T, R, N)), 2.4, 2.43685,
                                      -0.973838).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_score_math_matches_jax():
    T, R = _rand((3, 40, 50), 15, 4.0, -2.0), _rand((3, 40, 50), 16, 4.0, -2.0)
    R[0, :5] = T[0, :5]                      # D(T, T) = 0
    T[1, :5] = 0.0                           # min(|T|, |R|) = 0
    ls = _rand((3, 40, 50), 17, 6.0, 2.0)
    args = (2.4, 2.43685, float(np.log2(10 ** -0.973838)), 1.52134)
    want = np.asarray(jsm.d_beta_log2(*map(jnp.asarray, (T, R, ls)), *args))
    got = score_math.d_beta_log2(*map(torch.from_numpy, (T, R, ls)), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    tab = _rand((19,), 18, 10.0)
    u = _rand((500,), 19, 20.0, -0.5)
    want_t = np.interp(np.clip(u, 0, 18), np.arange(19), tab)
    got_t = score_math.table_interp(torch.from_numpy(tab), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=1e-6, atol=1e-5)
