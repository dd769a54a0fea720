"""A lone image split by rows over a mesh's 'space' axis
(``parallel.shard_image_fn`` through ``predict(mesh=make_mesh(...,
data_parallel=1))``) on the CPU.

The port splits each pyramid level's rows over the slots of the mesh's
first 'data' row in runs of whole 16-row tiles (``sharding.image_strip``); every
slot builds the whole Gaussian pyramid and scores its strip; the metric's
device adds the strips' sums before the beta root and gathers the heatmap's
rows and the callback's bands.  Meshes of 2, 3, 4 and 8 CPU slots on 48x64
(whose coarse levels have fewer tile rows than slots, so that some strips
are empty) and 144x256 images, on every route a lone image takes: the
default (expand_score2 with a row range), per-channel LUTs (band_score on
row views), threshold and raw heatmaps, the "global", "simple" and "gpyr2"
adaptations, log contrast, ignored boundary pixels, the band callback,
``pu_dilate`` (whose blur of the masking signal reaches rows beyond a
strip) and the two masking ablations.

Each is held against the same metric without a mesh (Q_per_ch and JOD at
rtol 1e-6: the strips' sums are added in another order; the heatmap within
1e-6; the callback's bands whole, in the same order and with the same
values), and against the JAX package's ``predict(mesh=make_mesh(
data_parallel=1))`` and ``shard_image_fn`` on its 8 virtual CPU devices at
the repo's bars (|dJOD| <= 0.01, Q_per_ch rtol 2e-3 / atol 2e-4,
tests/test_metric_e2e.py:13-17; heatmaps atol 2e-3, callback arrays rtol
1e-5).  The ``gpu`` cases run two and three slots on ``cuda:0``.
"""
import numpy as np
import pytest
import torch

import fovvideovdp_tpu_torch as fv_port
from fovvideovdp_tpu_torch import parallel
from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
from fovvideovdp_tpu_torch.ops.pyramid import gausspyr_reduce
from fovvideovdp_tpu_torch.parallel.sharding import image_strip

torch.set_num_threads(2)

SELF = dict(rtol=1e-6, atol=0)
HEAT_SELF = 1e-6
JAX_JOD = 0.01
JAX_Q = dict(rtol=2e-3, atol=2e-4)
HEAT_ATOL = 2e-3
SIZES = [(48, 64), (144, 256)]
SLOTS = [2, 3, 4, 8]

# name: (metric options, the core's route)
ROUTES = {
    "default": ({}, "fused"),
    "per_channel_luts": (dict(cut_luts=True), "banded"),
    "heatmap_threshold": (dict(heatmap="threshold"), "composed"),
    "heatmap_raw": (dict(heatmap="raw"), "composed"),
    "local_adapt_global": (dict(parameter_overrides={"local_adapt": "global"}), "composed"),
    "local_adapt_simple": (dict(parameter_overrides={"local_adapt": "simple"}), "composed"),
    "local_adapt_gpyr2": (dict(parameter_overrides={"local_adapt": "gpyr2"}), "composed"),
    "log_contrast": (dict(parameter_overrides={"contrast": "log"}), "composed"),
    "ignore_boundary_pixels": (dict(ignore_boundary_pixels=True), "composed"),
    "band_callback": (dict(band_callback=True), "composed"),
    "pu_dilate": (dict(parameter_overrides={"pu_dilate": 1.0}), "composed"),
    "masking_contrast_difference": (
        dict(parameter_overrides={"masking_model": "contrast_difference"}), "composed"),
    "masking_perc_norm": (
        dict(parameter_overrides={"masking_model": "contrast_difference_perc_norm"}),
        "composed"),
}


def _pair(hw, seed=7):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-20, 20, ref.shape), 0, 255)
    return tst.astype(np.uint8), ref


def _space(n):
    return parallel.make_mesh(["cpu"] * n, data_parallel=1)


def _recorder(calls):
    def cb(bb, n_bands, cc, T_f, R_f, N):
        calls.append(((int(bb), int(n_bands), int(cc)),
                      [np.array(np.asarray(a)) for a in (T_f, R_f, N)]))
    return cb


def _cut_luts(luts):
    """The omega = 5 LUT cut by its last Y knot (above any display's peak),
    so that the temporal channels' Y grids differ."""
    lut5 = dict(luts[1])
    for k in ("Y", "Y_log", "S_log"):
        lut5[k] = lut5[k][:-1]
    return (luts[0], lut5)


def _port(route, calls=None, device="cpu"):
    kw = dict(ROUTES[route][0])
    cut = kw.pop("cut_luts", False)
    if kw.pop("band_callback", False):
        kw["band_callback"] = _recorder(calls)
    fv = fv_port.fvvdp(display_name="standard_4k", device=device, **kw)
    if cut:
        fv.load_state(fv.parameters, _cut_luts(fv._luts))
    return fv


def _jax(route, calls=None):
    import fovvideovdp_tpu as fv_jax
    kw = dict(ROUTES[route][0])
    cut = kw.pop("cut_luts", False)
    if kw.pop("band_callback", False):
        kw["band_callback"] = _recorder(calls)
    fv = fv_jax.fvvdp(display_name="standard_4k", **kw)
    if cut:
        fv._luts = _cut_luts(fv._luts)
        fv._cores = {}
    return fv


def _heat(stats):
    return np.asarray(stats["heatmap"], np.float32) if "heatmap" in stats else None


# ----------------------------------------------------------------------
# the strips
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("h", [3, 16, 17, 48, 68, 135, 144, 2160])
def test_strips_cover_the_level_in_tile_rows(h, n):
    """Part k's rows follow part k-1's; each starts on a tile row; together
    they are the level; a part beyond the level's tile rows is empty."""
    strips = [image_strip(h, k, n) for k in range(n)]
    assert strips[0][0] == 0 and strips[-1][1] == h
    for (a0, a1), (b0, b1) in zip(strips, strips[1:]):
        assert a1 == b0
    tiles = -(-h // bp.TILE_H)
    for k, (r0, r1) in enumerate(strips):
        assert r0 % bp.TILE_H == 0 or r0 == h
        assert (r1 > r0) == (k < tiles)
    sizes = [-(-r1 // bp.TILE_H) - r0 // bp.TILE_H for r0, r1 in strips if r1 > r0]
    assert max(sizes) - min(sizes) <= 1


# ----------------------------------------------------------------------
# against the same metric without a mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("route", list(ROUTES))
def test_space_split_scores_as_one_device(route, hw, n):
    tst, ref = _pair(hw)
    calls = []
    fv = _port(route, calls)
    q1, s1 = fv.predict(tst, ref, dim_order="HWC")
    one_calls = list(calls)
    calls.clear()
    q2, s2 = fv.predict(tst, ref, dim_order="HWC", mesh=_space(n))
    assert fv._get_core(hw[1], hw[0]).route == ROUTES[route][1]
    np.testing.assert_allclose(q2, q1, **SELF)
    assert s2["Q_per_ch"].shape == s1["Q_per_ch"].shape
    np.testing.assert_allclose(s2["Q_per_ch"], s1["Q_per_ch"], **SELF)
    assert np.all(s2["Q_per_ch"][:, 1] == 0.0)
    if _heat(s1) is not None:
        assert _heat(s2).shape == _heat(s1).shape
        assert np.max(np.abs(_heat(s2) - _heat(s1))) <= HEAT_SELF
    if route == "band_callback":
        assert [c[0] for c in calls] == [c[0] for c in one_calls]
        for (key, got), (_, want) in zip(calls, one_calls):
            for g, w in zip(got, want):
                assert g.shape == w.shape, key          # whole bands, not strips
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=str(key))


def test_a_space_split_on_a_data_and_space_mesh_uses_the_first_data_row():
    """On a 2 x 4 mesh the strips go to the first 'data' row's four slots;
    the other row's slots run nothing."""
    tst, ref = _pair(SIZES[1])
    fv = _port("default")
    q1, s1 = fv.predict(tst, ref, dim_order="HWC")
    mesh = parallel.make_mesh(["cpu"] * 8, data_parallel=2)
    ran = []
    run = mesh.run

    def spy(fns):
        ran.append([fn is not None for fn in fns])
        return run(fns)
    mesh.run = spy
    q2, s2 = fv.predict(tst, ref, dim_order="HWC", mesh=mesh)
    assert ran == [[True] * 4]
    np.testing.assert_allclose(s2["Q_per_ch"], s1["Q_per_ch"], **SELF)


def test_slots_without_rows_run_nothing():
    """48 rows are three tile rows: of eight slots, five have no rows at any
    level and are not run; the strips of level 1 (24 rows) lie on slots 0
    and 1 only."""
    fv = _port("default")
    core = fv._get_core(64, 48)
    T = torch.rand(48, 64) * 100 + 0.1
    Rf = T * 1.01
    levels = [core.score_image_strip(T, Rf, [image_strip(h, k, 8) for h, _ in
                                             core.plan.level_shapes[:core.plan.height]])
              for k in range(8)]
    assert [sum(lv is not None for lv in p) for p in levels] == [4, 2, 1, 0, 0, 0, 0, 0]
    assert [lv.rows for lv in levels[0] if lv is not None] == [(0, 16), (0, 16), (0, 12),
                                                               (0, 6)]
    assert levels[1][1].rows == (16, 24) and levels[1][1].partials.shape == (1, 1, 2)
    Q, heat = core.combine_image_strips(levels, T)
    Q1, _ = core.score_image(T, Rf)
    assert heat is None
    np.testing.assert_allclose(Q.numpy(), Q1.numpy(), **SELF)


def test_strip_partials_are_the_whole_levels_tiles():
    """On the default route the strips' tile partials, laid end to end in row
    order, are the whole level's, and sum_tile_partials of them gives its
    per-frame sums."""
    fv = _port("default")
    core = fv._get_core(256, 144)
    g = torch.rand(1, 4, 144, 256) * 80 + 0.5
    gpyr = core.plan.gaussian_pyramid(g)
    for bb in range(core.plan.height):
        fine, coarse = gpyr[bb], gpyr[bb + 1]
        tabs, meta = core._score_tables[bb], core._meta[bb]
        whole = bp.expand_score2(fine, coarse, tabs, meta, partials=True)
        parts = [bp.expand_score2(fine, coarse, tabs, meta, rows=image_strip(
            fine.shape[-2], k, 3), partials=True) for k in range(3)]
        joined = torch.cat(parts, dim=1)
        assert joined.shape == whole.shape
        np.testing.assert_allclose(joined.numpy(), whole.numpy(), rtol=1e-6, atol=0)
        np.testing.assert_allclose(bp.sum_tile_partials(joined).numpy(),
                                   bp.expand_score2(fine, coarse, tabs, meta).numpy(),
                                   rtol=1e-6, atol=0)


def test_rows_pass_through_the_autograd_function():
    """expand_score2's row range is an argument the Function's backward
    hands back to the plain version: the gradient through a strip is the
    plain version's, zero on fine rows the strip's expansion does not
    reach."""
    fv = _port("default")
    core = fv._get_core(256, 144)
    g = torch.rand(2, 4, 144, 256, dtype=torch.float32) * 80 + 0.5
    coarse = gausspyr_reduce(g)
    tabs, meta = core._score_tables[0], core._meta[0]
    rows = (32, 80)
    x = g.clone().requires_grad_()
    bp.expand_score2(x, coarse, tabs, meta, rows=rows).sum().backward()
    y = g.clone().requires_grad_()
    bp.expand_score2_plain(y, coarse, tabs, meta, rows=rows).sum().backward()
    assert torch.equal(x.grad, y.grad)
    assert bool((x.grad[:, :, :rows[0]] == 0).all()) and bool((x.grad[:, :, rows[1]:] == 0).all())
    assert bool((x.grad[:, :, rows[0]:rows[1]] != 0).any())


def test_a_foveated_core_is_not_split():
    fv = fv_port.fvvdp(display_name="standard_4k", device="cpu", foveated=True)
    core = fv._get_core(64, 48)
    with pytest.raises(ValueError, match="foveated"):
        core.score_image_strip(torch.ones(48, 64), torch.ones(48, 64), [(0, 16)] * 4)


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
JAX_CASES = [(route, SIZES[0]) for route in ROUTES] + \
    [("default", SIZES[1]), ("heatmap_threshold", SIZES[1])]


@pytest.mark.parametrize("route,hw", JAX_CASES,
                         ids=[f"{r}-{h}x{w}" for r, (h, w) in JAX_CASES])
def test_space_split_matches_jax_predict_on_a_space_mesh(route, hw):
    """JAX's predict(mesh=make_mesh(data_parallel=1)) on 8 virtual CPU
    devices (W split over 'space') against the port's 8 CPU slots (rows)."""
    from fovvideovdp_tpu.parallel import make_mesh as jax_make_mesh
    tst, ref = _pair(hw)
    j_calls, p_calls = [], []
    q_j, s_j = _jax(route, j_calls).predict(tst, ref, dim_order="HWC",
                                             mesh=jax_make_mesh(data_parallel=1))
    q_p, s_p = _port(route, p_calls).predict(tst, ref, dim_order="HWC", mesh=_space(8))
    assert abs(q_p - q_j) <= JAX_JOD
    np.testing.assert_allclose(s_p["Q_per_ch"], np.asarray(s_j["Q_per_ch"]), **JAX_Q)
    if _heat(s_p) is not None:
        np.testing.assert_allclose(_heat(s_p), _heat(s_j), atol=HEAT_ATOL)
    if route == "band_callback":
        # JAX's callbacks are unordered within a band: compared sorted
        j_calls.sort(key=lambda c: c[0])
        assert [c[0] for c in p_calls] == [c[0] for c in j_calls]
        for (key, got), (_, want) in zip(p_calls, j_calls):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(key))


@pytest.mark.parametrize("heatmap", [None, "raw"])
def test_shard_image_fn_matches_jax(heatmap):
    """The shard functions called directly on the same luminance, JAX's on
    8 virtual CPU devices, the port's on 8 CPU slots (tests/test_parallel.py:
    test_sharded_image_matches_single_device)."""
    import jax
    import jax.numpy as jnp
    import fovvideovdp_tpu as fv_jax
    from fovvideovdp_tpu.parallel import make_mesh as jax_make_mesh
    from fovvideovdp_tpu.parallel import shard_image_fn as jax_shard_image_fn
    rng = np.random.RandomState(1)
    T = rng.rand(48, 64).astype(np.float32) * 200 + 0.1
    Rf = T + 1.0
    kw = {} if heatmap is None else dict(heatmap=heatmap)
    j_core = fv_jax.fvvdp(display_name="standard_4k", **kw)._get_core(64, 48)
    Q_j, h_j = jax_shard_image_fn(j_core, jax_make_mesh(jax.devices("cpu")[:8],
                                                        data_parallel=1))(
        jnp.asarray(T), jnp.asarray(Rf))
    core = fv_port.fvvdp(display_name="standard_4k", device="cpu", **kw)._get_core(64, 48)
    Q_p, h_p = parallel.shard_image_fn(core, _space(8))(torch.as_tensor(T), torch.as_tensor(Rf))
    np.testing.assert_allclose(Q_p.numpy(), np.asarray(Q_j), **JAX_Q)
    if heatmap is None:
        assert h_p is None
    else:
        np.testing.assert_allclose(h_p.float().numpy(), np.asarray(h_j, np.float32),
                                   atol=HEAT_ATOL)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3])
def test_space_split_on_the_card_is_one_card_bit_for_bit(cuda, n):
    """Two and three slots on cuda:0, default route: each slot launches the
    reduce at every level and expand_score2 only where its strip has rows;
    Q_per_ch and JOD are the one-card run's bit for bit."""
    tst, ref = _pair((544, 960))
    fv = _port("default", device="cuda:0")
    q1, s1 = fv.predict(tst, ref, dim_order="HWC")
    mesh = parallel.make_mesh(["cuda:0"] * n, data_parallel=1)
    _lib.reset_launch_counts()
    q2, s2 = fv.predict(tst, ref, dim_order="HWC", mesh=mesh)
    plan = fv._get_core(960, 544).plan
    for k in range(n):
        got = _lib.launch_counts(k)
        rows = sum(image_strip(h, k, n)[1] > image_strip(h, k, n)[0]
                   for h, _ in plan.level_shapes[:plan.height])
        assert got["gausspyr_reduce"] == plan.height and got["expand_score2"] == rows
    assert q2 == q1 and np.array_equal(s2["Q_per_ch"], s1["Q_per_ch"])


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [(0, 16), (16, 544), (17, 301), (528, 544), (530, 544),
                                  (40, 40)])
def test_expand_score2_rows_matches_plain_on_the_card(cuda, rows):
    """A strip at a tile row, at an odd row, the last partial tile and an
    empty strip, on both arms, against the plain version (relative 1e-4)."""
    fv = _port("default", device="cuda:0")
    core = fv._get_core(960, 544)
    g = torch.rand(2, 4, 544, 960, device="cuda:0") * 80 + 0.5
    gpyr = core.plan.gaussian_pyramid(g)
    tabs, meta = core._score_tables[0], core._meta[0]
    for fine in (gpyr[0], gpyr[0][..., :-1].contiguous()):
        coarse = gausspyr_reduce(fine)
        got = bp.expand_score2(fine, coarse, tabs, meta, rows=rows).double()
        want = bp.expand_score2_plain(fine, coarse, tabs, meta, rows=rows).double()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        assert rel <= 1e-4 or rows[0] == rows[1], rel
        if rows[0] == rows[1]:
            assert torch.equal(got, torch.zeros_like(got))


def jax_gaps():
    """{(route, size): (|dJOD|, max relative Q_per_ch difference)} of the
    port's 8 CPU slots against JAX's space mesh of 8 virtual CPU devices,
    on the cases of test_space_split_matches_jax_predict_on_a_space_mesh."""
    from fovvideovdp_tpu.parallel import make_mesh as jax_make_mesh
    gaps = {}
    for route, hw in JAX_CASES:
        tst, ref = _pair(hw)
        q_j, s_j = _jax(route, []).predict(tst, ref, dim_order="HWC",
                                           mesh=jax_make_mesh(data_parallel=1))
        q_p, s_p = _port(route, []).predict(tst, ref, dim_order="HWC", mesh=_space(8))
        Q_j = np.asarray(s_j["Q_per_ch"], np.float64)
        rel = np.abs(s_p["Q_per_ch"] - Q_j) / np.maximum(np.abs(Q_j), 1e-30)
        gaps[(route, f"{hw[0]}x{hw[1]}")] = (abs(q_p - q_j), float(rel[Q_j != 0].max()))
    return gaps


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    #     python tests/test_torch_space_split.py
    for key, (djod, dq) in jax_gaps().items():
        print(*key, f"|dJOD| {djod:.3e}", f"Q_per_ch rel {dq:.3e}")
