"""The ops of the fixed-gaze, heatmap and per-channel-LUT routes of
fovvideovdp_tpu_torch against the JAX package, on the CPU.

Each port function runs its plain PyTorch version (CPU tensors) on the same
seeded numpy inputs as its JAX counterpart.  Where the JAX function reaches
a Pallas kernel it runs through the Pallas interpreter
(``pallas_cfg.forced(True, interpret=True)``), as
tests/test_band_score_interpret.py runs it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fvt
from fovvideovdp_tpu import csf as jcsf
from fovvideovdp_tpu import display_model as jdm
from fovvideovdp_tpu import visualize as jvis
from fovvideovdp_tpu.ops import pallas as pallas_cfg
from fovvideovdp_tpu.ops import pyramid as jpyr
from fovvideovdp_tpu.ops.pallas import band_score as jbs
from fovvideovdp_tpu.ops.pallas import expand as jexpand
from fovvideovdp_tpu_torch import csf, memory, state, visualize
from fovvideovdp_tpu_torch.ops import pyramid
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
from fovvideovdp_tpu_torch.ops.cuda.expand_contrast import expand_contrast

torch.set_num_threads(2)


def _rand(shape, seed, scale=100.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return rng.random(shape, dtype=np.float32) * scale + offset


@pytest.fixture(scope="module")
def jax_core():
    import __graft_entry__ as ge
    return ge._make_core(256, 64)


@pytest.fixture(scope="module")
def luts():
    """The omega = 0 LUT in both packages' forms."""
    jlut = jcsf.CSFCache().get(0.0, -1.5, 0.604562)
    _, (plut,) = state.state_from_numpy(
        {}, [{k: np.asarray(jlut[k]) for k in csf.LUT_FIELDS}], "cpu")
    return jlut, plut


# ---------------------------------------------------------------------------
# expand_contrast
# ---------------------------------------------------------------------------

# the last shape is one the TPU kernel's gate refuses (expand.supports)
@pytest.mark.parametrize("shape,pallas", [((2, 4, 48, 160), True), ((2, 2, 37, 131), True),
                                          ((1, 4, 17, 30), False)])
def test_expand_contrast_matches_jax(shape, pallas):
    F, C, H, W = shape
    fine = _rand(shape, 1, 80.0, 0.5)
    coarse = _rand((F, C, -(-H // 2), -(-W // 2)), 2, 80.0, 0.5)
    coarse[0, 1, :3] = 0.01                       # L_bkg clamps at 0.1
    got_c, got_l = expand_contrast(torch.from_numpy(fine), torch.from_numpy(coarse), 1)
    assert got_c.shape == shape and got_l.shape == (F, 1, H, W)
    assert float(got_l.min()) == pytest.approx(0.1)
    refs = [jpyr._expand_contrast_jnp(jnp.asarray(fine), jnp.asarray(coarse), (H, W), 1)]
    assert jexpand.supports(H, W) == pallas
    if pallas:
        with pallas_cfg.forced(True, interpret=True):
            refs.append(jexpand.expand_contrast_pallas(jnp.asarray(fine),
                                                       jnp.asarray(coarse), 1))
    for want_c, want_l in refs:
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=2e-5, atol=1e-4)


def test_expand_contrast_wrapper_rejects_what_the_kernel_cannot_take():
    fine, coarse = torch.zeros((1, 4, 8, 8)), torch.zeros((1, 4, 4, 4))
    with pytest.raises(ValueError):
        expand_contrast(fine[:, :3], coarse[:, :3])           # C = 3
    with pytest.raises(ValueError):
        expand_contrast(fine, coarse[..., :3])                # shapes disagree
    with pytest.raises(ValueError):
        expand_contrast(fine, coarse, bkg_channel=4)
    with pytest.raises(TypeError):
        expand_contrast(fine.double(), coarse.double())
    with pytest.raises(RuntimeError):
        expand_contrast(fine.to("meta"), coarse.to("meta"))


# ---------------------------------------------------------------------------
# band scorers (inputs of tests/test_band_score_interpret.py)
# ---------------------------------------------------------------------------

def _meta(jax_core):
    p = jax_core.params
    lut = {k: np.asarray(jax_core.luts[0][k]) for k in ("Y_log", "Y")}
    return bs.score_meta(lut, p["mask_p"], p["mask_q_sust"], p["mask_q_trans"], p["mask_c"],
                         10.0 ** (p["sensitivity_correction"] / 20), p["beta"])


def _jax_args(jax_core):
    p = jax_core.params
    return p, 10.0 ** (p["sensitivity_correction"] / 20)


def test_band_score_matches_jax_pallas_kernel(jax_core):
    p, corr = _jax_args(jax_core)
    rng = np.random.RandomState(0)
    T = rng.randn(2, 64, 256).astype(np.float32)
    R = T + np.float32(0.03)
    L = (rng.rand(2, 64, 256) * 300 + 0.5).astype(np.float32)
    tbl = np.asarray(jax_core._band_tables[0][0])
    with pallas_cfg.forced(True, interpret=True):
        want = np.asarray(jbs.band_score_pallas(
            jnp.asarray(T), jnp.asarray(R), jnp.asarray(L), tbl, jax_core.luts[0],
            p["mask_p"], p["mask_q_sust"], p["mask_c"], corr, p["beta"]))
    meta = _meta(jax_core)
    got = bs.band_score(*map(torch.from_numpy, (T, R, L, tbl)), meta, meta.q_s)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5)


def test_band_score_takes_channel_views_of_a_stack(jax_core):
    band = torch.from_numpy(_rand((3, 4, 9, 13), 3, 0.2, -0.1))
    L = torch.from_numpy(_rand((3, 1, 9, 13), 4, 200.0, 0.5))
    tbl = torch.from_numpy(np.asarray(jax_core._band_tables[0][1]))
    meta = _meta(jax_core)
    got = bs.band_score(band[:, 2], band[:, 3], L[:, 0], tbl, meta, meta.q_t)
    want = bs.band_score(band[:, 2].contiguous(), band[:, 3].contiguous(),
                         L[:, 0].contiguous(), tbl, meta, meta.q_t)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_band_score2_matches_jax_pallas_kernel(jax_core):
    p, corr = _jax_args(jax_core)
    rng = np.random.RandomState(3)
    band = rng.randn(2, 4, 64, 256).astype(np.float32)
    L = (rng.rand(2, 64, 256) * 300 + 0.5).astype(np.float32)
    tabs = np.stack(jax_core._band_tables[0][:2])
    with pallas_cfg.forced(True, interpret=True):
        want = np.asarray(jbs.band_score2_pallas(
            jnp.asarray(band), jnp.asarray(L), tabs, jax_core.luts[0], p["mask_p"],
            p["mask_q_sust"], p["mask_q_trans"], p["mask_c"], corr, p["beta"]))
    got = bs.band_score2(*map(torch.from_numpy, (band, L, tabs)), _meta(jax_core))
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5)


def test_band_score2_fov_matches_jax_pallas_kernel(jax_core):
    """Per-pixel tables, odd sizes (the TPU kernel pads rows and columns)."""
    p, corr = _jax_args(jax_core)
    rng = np.random.RandomState(3)
    F, h, w = 3, 37, 200
    band = (rng.randn(F, 4, h, w) * 0.05).astype(np.float32)
    L = (10.0 ** rng.uniform(-1, 2.3, (F, h, w))).astype(np.float32)
    n = jax_core.luts[0]["S_log"].shape[0]
    tabs_s = rng.uniform(-5, 10, (n, h, w)).astype(np.float32)
    tabs_t = tabs_s + rng.uniform(-1, 1, (n, h, w)).astype(np.float32)
    with pallas_cfg.forced(True, interpret=True):
        want = np.asarray(jbs.band_score2_fov_pallas(
            *map(jnp.asarray, (band, L, tabs_s, tabs_t)), jax_core.luts[0], p["mask_p"],
            p["mask_q_sust"], p["mask_q_trans"], p["mask_c"], corr, p["beta"]))
    got = bs.band_score2_fov(*map(torch.from_numpy, (band, L, tabs_s, tabs_t)),
                             _meta(jax_core))
    assert got.shape == (F, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)


def test_band_scorers_at_the_top_knot_and_on_zero_contrast(jax_core):
    """u may equal n - 1 exactly (the upper tap clamps), and D(0, 0) = 0."""
    meta = _meta(jax_core)
    n = 32
    band = torch.zeros((1, 4, 4, 6))
    band[0, 0] = 0.02
    L = torch.full((1, 4, 6), meta.Ymax * 4.0)       # clamps to Ymax: u = n - 1
    tabs = torch.from_numpy(_rand((2, n), 5, 8.0))
    per_px = tabs[:, :, None, None].expand(2, n, 4, 6).contiguous()
    two = bs.band_score2(band, L, tabs, meta)
    fov = bs.band_score2_fov(band, L, per_px[0], per_px[1], meta)
    one = bs.band_score(band[:, 0], band[:, 1], L, tabs[0], meta, meta.q_s)
    assert torch.isfinite(two).all() and float(two[0, 1]) == 0.0 and float(two[0, 0]) > 0
    np.testing.assert_allclose(fov.numpy(), two.numpy(), rtol=1e-5)
    np.testing.assert_allclose(one.numpy(), two[:, 0].numpy(), rtol=1e-6)


def test_band_score_wrappers_reject_what_the_kernels_cannot_take(jax_core):
    meta = _meta(jax_core)
    band, L = torch.zeros((2, 4, 8, 8)), torch.ones((2, 8, 8))
    tabs = torch.zeros((2, 32))
    with pytest.raises(ValueError):
        bs.band_score2(band[:, :2], L, tabs, meta)              # not 4 channels
    with pytest.raises(ValueError):
        bs.band_score2(band, L[:1], tabs, meta)                 # frames disagree
    with pytest.raises(ValueError):
        bs.band_score2(band, L, tabs[0], meta)                  # one table
    with pytest.raises(ValueError):
        bs.band_score2_fov(band, L, torch.zeros((32, 8, 4)), torch.zeros((32, 8, 4)), meta)
    with pytest.raises(ValueError):
        bs.band_score(band[:, 0], band[:, 1, :4], L, tabs[0], meta, 2.0)
    with pytest.raises(TypeError):
        bs.band_score2(band.double(), L.double(), tabs.double(), meta)
    with pytest.raises(RuntimeError):
        bs.band_score2(band.to("meta"), L.to("meta"), tabs.to("meta"), meta)


# ---------------------------------------------------------------------------
# per-pixel CSF tables and display geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("monotone", [False, True], ids=["uniform", "monotone"])
def test_reduce_lut_to_pixel_tables_matches_jax(luts, monotone):
    jlut, plut = luts
    if monotone:       # the same grids through the cell search of non-uniform axes
        flags = dict(jlut["_uniform"], rho_log=False, ecc_sqrt=False)
        jlut, plut = dict(jlut, _uniform=flags), dict(plut, _uniform=flags)
    rho = _rand((23, 31), 6, 40.0, 0.05)
    ecc = _rand((23, 31), 7, 70.0)
    ecc[0, :4] = 0.0
    rho[1, :4] = 1e3                                   # beyond the grid: clamps
    want = np.asarray(jcsf.reduce_lut_to_pixel_tables(jlut, jnp.asarray(rho),
                                                      jnp.asarray(ecc)))
    got = csf.reduce_lut_to_pixel_tables(plut, torch.from_numpy(rho), torch.from_numpy(ecc))
    assert got.shape == (32, 23, 31) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a scalar rho broadcasts over the eccentricity map
    got_s = csf.reduce_lut_to_pixel_tables(plut, 3.5, torch.from_numpy(ecc))
    want_s = np.asarray(jcsf.reduce_lut_to_pixel_tables(jlut, 3.5, jnp.asarray(ecc)))
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)


def test_reduce_lut_to_pixel_tables_is_chunked(luts, monkeypatch):
    _, plut = luts
    rho, ecc = torch.from_numpy(_rand((40, 50), 8, 30.0, 0.1)), \
        torch.from_numpy(_rand((40, 50), 9, 60.0))
    whole = csf.reduce_lut_to_pixel_tables(plut, rho, ecc)
    monkeypatch.setattr(memory, "pixel_table_chunk", lambda n, device: 333)
    np.testing.assert_array_equal(csf.reduce_lut_to_pixel_tables(plut, rho, ecc).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("lead", [(), (3,)], ids=["plane", "frames"])
def test_sensitivity_pixel_tables_matches_jax(luts, lead):
    jlut, plut = luts
    rng = np.random.default_rng(10)
    tables = np.asarray(jcsf.reduce_lut_to_pixel_tables(
        jlut, jnp.asarray(_rand((19, 27), 20, 40.0, 0.05)),
        jnp.asarray(_rand((19, 27), 21, 70.0)))).copy()
    L = (10.0 ** rng.uniform(-4, 5, lead + (19, 27))).astype(np.float32)   # past both ends
    want = np.asarray(jcsf.sensitivity_pixel_tables(jlut, jnp.asarray(tables), jnp.asarray(L)))
    got = csf.sensitivity_pixel_tables(plut, torch.from_numpy(tables), torch.from_numpy(L))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("monotone", [False, True], ids=["uniform", "monotone"])
def test_sensitivity_1d_matches_jax(luts, monotone):
    jlut, plut = luts
    if monotone:
        flags = dict(jlut["_uniform"], Y_log=False)
        jlut, plut = dict(jlut, _uniform=flags), dict(plut, _uniform=flags)
    rng = np.random.default_rng(11)
    table = jcsf.reduce_lut_to_1d(jlut, 4.0, 0.0)
    L = (10.0 ** rng.uniform(-4, 5, (2, 33, 41))).astype(np.float32)
    want = np.asarray(jcsf.sensitivity_1d(jlut, table, jnp.asarray(L)))
    got = csf.sensitivity_1d(plut, table, torch.from_numpy(L))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("uniform", [True, False])
def test_grid_weights_and_index_coord_match_jax(luts, uniform):
    jlut, plut = luts
    q = _rand((257,), 12, 14.0, -7.0)                  # log2 rho, past both ends
    want_w = np.asarray(jcsf._grid_weights(jnp.asarray(q), jlut["rho_log"], uniform))
    got_w = csf._grid_weights(torch.from_numpy(q), plut["rho_log"], uniform)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-5, atol=1e-6)
    want_u = np.asarray(jcsf.grid_index_coord(jnp.asarray(q), jlut["rho_log"], uniform))
    got_u = csf.grid_index_coord(torch.from_numpy(q), plut["rho_log"], uniform)
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=1e-5, atol=1e-5)


def _band_grid(w, h):
    xv = np.linspace(0.5, w - 0.5, w, dtype=np.float32)
    yv = np.linspace(0.5, h - 0.5, h, dtype=np.float32)
    return np.meshgrid(xv, yv)


def test_geometry_maps_match_golden(goldens):
    g = goldens("geometry_maps")
    gm = fvt.fvvdp_display_geometry.load("htc_vive_pro")
    w, h = int(g["w_band"]), int(g["h_band"])
    xx, yy = _band_grid(w, h)
    view_dir = gm.pix2view_direction((w, h), torch.from_numpy(xx), torch.from_numpy(yy))
    np.testing.assert_allclose(view_dir.numpy(), g["view_dir"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gm.get_resolution_magnification(view_dir).numpy(),
                               g["res_mag"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gm.get_ppd(view_dir).numpy(), g["ppd_map"],
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("display", ["htc_vive_pro", "standard_4k", "fixed_ppd"])
def test_geometry_maps_match_jax(display):
    if display == "fixed_ppd":
        jg = jdm.fvvdp_display_geometry((640, 480), pix_per_deg=42.0)
        pg = fvt.fvvdp_display_geometry((640, 480), pix_per_deg=42.0)
    else:
        jg, pg = (m.fvvdp_display_geometry.load(display) for m in (jdm, fvt))
    xx, yy = _band_grid(37, 29)
    want_vd = jg.pix2view_direction((37, 29), jnp.asarray(xx), jnp.asarray(yy))
    got_vd = pg.pix2view_direction((37, 29), torch.from_numpy(xx), torch.from_numpy(yy))
    np.testing.assert_allclose(got_vd.numpy(), np.asarray(want_vd), rtol=1e-5, atol=1e-5)
    # ppd is a difference of two tangents half a pixel (~0.01 deg) apart: one
    # float32 ulp of tan (6e-8 x ~0.5) against a difference of ~2e-4 is 2e-4
    # relative, and the two frameworks' tan differ by an ulp.  Hence 1e-3,
    # where the fixed-ppd display (no tangents) agrees exactly.
    rtol = 0.0 if display == "fixed_ppd" else 1e-3
    np.testing.assert_allclose(pg.get_resolution_magnification(got_vd).numpy(),
                               np.asarray(jg.get_resolution_magnification(want_vd)),
                               rtol=rtol)
    np.testing.assert_allclose(pg.get_ppd(got_vd).numpy(),
                               np.asarray(jg.get_ppd(want_vd)), rtol=rtol)


# ---------------------------------------------------------------------------
# pyramid decompositions against the reference goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["even", "odd", "oddw"])
def test_decompose_and_reconstruct_match_golden(goldens, tag):
    g = goldens(f"pyramid_{tag}")
    img = torch.from_numpy(g["img"])                   # (4, 1, H, W)
    H, W = img.shape[-2:]
    plan = pyramid.PyramidPlan(W, H, float(g["ppd"]))
    assert plan.height == int(g["height"])
    lbands, gbands = plan.decompose(img)
    for i in range(plan.height + 1):
        np.testing.assert_allclose(gbands[i].numpy(), g[f"gband_{i}"], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(lbands[i].numpy(), g[f"lband_{i}"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(plan.reconstruct(lbands).numpy(), g["recon"],
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("tag", ["even", "odd", "oddw"])
def test_decompose_contrast_matches_golden(goldens, tag):
    g = goldens(f"pyramid_{tag}")
    img = torch.from_numpy(g["img"]).squeeze(1)[None]  # (1, 4, H, W)
    H, W = img.shape[-2:]
    plan = pyramid.PyramidPlan(W, H, float(g["ppd"]))
    cbands, lbkg = plan.decompose_contrast(img, bkg_channel=1)
    assert len(cbands) == plan.height + 1 and len(lbkg) == plan.height
    for i in range(plan.height + 1):
        np.testing.assert_allclose(cbands[i].numpy()[0][:, None], g[f"cband_{i}"],
                                   rtol=2e-5, atol=1e-4, err_msg=f"cband {i}")
    for i in range(plan.height):
        np.testing.assert_allclose(lbkg[i].numpy()[0][:, None], g[f"lbkg_{i}"],
                                   rtol=1e-5, atol=1e-3, err_msg=f"lbkg {i}")
    # the level-at-a-time generator yields the same pairs
    for i, (c, lb) in enumerate(plan.contrast_levels(img, bkg_channel=1)):
        np.testing.assert_array_equal(c.numpy(), cbands[i].numpy())
        np.testing.assert_array_equal(lb.numpy(), lbkg[i].numpy())


# ---------------------------------------------------------------------------
# visualisation
# ---------------------------------------------------------------------------

def _context(kind):
    rng = np.random.default_rng(13)
    if kind == "flat":                                 # narrow range: no tone mapping
        return (50.0 + rng.random((1, 72, 108), dtype=np.float32)).astype(np.float32)
    y = (10.0 ** rng.uniform(-1.5, 2.3, (1, 72, 108))).astype(np.float32)
    y[0, :2] = 0.0                                     # log_luminance clamps these
    return y


@pytest.mark.parametrize("kind", ["textured", "flat"])
def test_vis_tonemap_matches_jax(kind):
    y = _context(kind)
    want_l = np.asarray(jvis.log_luminance(jnp.asarray(y)))
    got_l = visualize.log_luminance(torch.from_numpy(y))
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-6, atol=1e-6)
    want = np.asarray(jvis.vis_tonemap(jnp.asarray(want_l), 0.6))
    got = fvt.vis_tonemap(got_l, 0.6)
    assert (float(np.ptp(want_l)) < 0.6) == (kind == "flat")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("kind", ["textured", "flat", "no_context"])
@pytest.mark.parametrize("cmap", ["threshold", "supra-threshold", "monochromatic"])
def test_visualize_diff_map_matches_jax(kind, cmap):
    rng = np.random.default_rng(14)
    d = (rng.random((1, 72, 108), dtype=np.float32) * 1.4 - 0.2).astype(np.float32)
    d[0, 0, :5] = [0.0, 0.25, 0.5, 0.75, 1.0]          # the colour map's knots
    y = None if kind == "no_context" else _context(kind)
    want = np.asarray(jvis.visualize_diff_map(
        jnp.asarray(d), None if y is None else jnp.asarray(y), cmap))
    got = fvt.visualize_diff_map(torch.from_numpy(d),
                                 None if y is None else torch.from_numpy(y), cmap)
    assert got.shape == (3, 72, 108)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_visualize_diff_map_frames_matches_jax():
    rng = np.random.default_rng(15)
    d = rng.random((3, 1, 40, 56), dtype=np.float32)
    y = (10.0 ** rng.uniform(-1, 2, (3, 1, 40, 56))).astype(np.float32)
    want = np.asarray(jvis.visualize_diff_map_frames(jnp.asarray(d), jnp.asarray(y),
                                                     "threshold"))
    got = visualize.visualize_diff_map_frames(torch.from_numpy(d), torch.from_numpy(y),
                                              "threshold")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    with pytest.raises(RuntimeError, match="Unknown colormap"):
        fvt.visualize_diff_map(torch.from_numpy(d[0]), None, "rainbow")
