"""What Python decides for the CUDA kernels ``expand_score2``,
``mov_score``, the band scorers and ``gausspyr_reduce``: the arm (16-byte loads, or 4-byte loads each masked), the grid
and the size of the partial sums, as pure functions of shapes, strides and
addresses; and the arithmetic decision those kernels rest on, that one
reciprocal and a multiply may stand for each division.

Everything here runs on the CPU.  The kernels themselves are held against
their plain versions on the card (``-m gpu tests/test_torch_package.py``).
"""
import numpy as np
import pytest
import torch

from fovvideovdp_tpu_torch import fvvdp
from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
from fovvideovdp_tpu_torch.ops.cuda import reduce as red
from fovvideovdp_tpu_torch.ops.pyramid import gausspyr_expand

torch.set_num_threads(2)

F = 32   # frames of a 4K block

# (H, W) of the seven scored levels of a 3840 x 2160 frame, with the tiles
# (across, down), frames per group and groups of expand_score2, and the
# blocks, frames per group and groups of mov_score
LEVELS_4K = [
    ((2160, 3840), (30, 135, 32, 1), (8100, 32, 1)),
    ((1080, 1920), (15, 68, 32, 1), (2025, 32, 1)),
    ((540, 960), (8, 34, 32, 1), (507, 32, 1)),
    ((270, 480), (4, 17, 8, 4), (127, 11, 3)),
    ((135, 240), (2, 9, 3, 11), (32, 4, 8)),
    ((68, 120), (1, 5, 1, 32), (8, 1, 32)),
    ((34, 60), (1, 3, 1, 32), (2, 1, 32)),
]


def _check_groups(n_blocks, frames_per_group, groups, n_frames):
    """The groups cover the frames and none is empty; a level that cannot fill
    the card alone is split until it nearly does or has a frame per group."""
    assert (groups - 1) * frames_per_group < n_frames <= groups * frames_per_group
    assert groups == 1 or frames_per_group == 1 or n_blocks * groups >= bs.FILL_BLOCKS * 0.75
    assert groups > 1 or n_blocks >= bs.FILL_BLOCKS or n_frames == 1


def _rand(shape, seed, scale=80.0, offset=0.5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape, dtype=np.float32) * scale + offset)


def _offset_by_one_float(t):
    """The same values in storage that starts 4 bytes past a 16-byte
    boundary (torch aligns what it allocates to 64 bytes)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    assert buf.data_ptr() % 16 == 0
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# ---------------------------------------------------------------------------
# expand_score2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,tiles,_", LEVELS_4K, ids=[f"{h}x{w}" for (h, w), _, _ in LEVELS_4K])
def test_expand_score2_plan_at_the_4k_levels(hw, tiles, _):
    plan = bp.launch_plan((F, 4) + hw, 0)
    assert plan.vec
    assert plan.tiles + (plan.frames_per_group, plan.groups) == tiles
    assert plan.n_tiles == tiles[0] * tiles[1]
    _check_groups(plan.n_tiles, plan.frames_per_group, plan.groups, F)
    # every pixel is inside a tile, and no tile is empty
    assert (tiles[0] - 1) * bp.TILE_W < hw[1] <= tiles[0] * bp.TILE_W
    assert (tiles[1] - 1) * bp.TILE_H < hw[0] <= tiles[1] * bp.TILE_H


@pytest.mark.parametrize("hw,tiles", [((67, 131), (2, 5)), ((17, 30), (1, 2)), ((2, 2), (1, 1))])
def test_expand_score2_plan_takes_the_scalar_arm_off_a_multiple_of_4(hw, tiles):
    plan = bp.launch_plan((2, 4) + hw, 0)
    assert not plan.vec
    assert plan.tiles == tiles and plan.n_tiles == tiles[0] * tiles[1]
    assert (plan.frames_per_group, plan.groups) == (1, 2)


@pytest.mark.parametrize("ptr,vec", [(0, True), (256, True), (4, False), (8, False), (20, False)])
def test_expand_score2_plan_needs_an_aligned_address_for_the_vector_arm(ptr, vec):
    assert bp.launch_plan((2, 4, 96, 144), ptr).vec == vec


def test_expand_score2_plan_for_reads_the_tensor():
    fine, coarse = _rand((2, 4, 96, 144), 2), _rand((2, 4, 48, 72), 3)
    tables = torch.zeros((2, 19))
    assert bp.plan_for(fine, coarse, tables) == bp.launch_plan(fine.shape, fine.data_ptr())
    assert bp.plan_for(fine, coarse, tables).vec
    shifted = _offset_by_one_float(fine)
    assert shifted.is_contiguous() and not bp.plan_for(shifted, coarse, tables).vec
    one = bp.plan_for(fine[:1], coarse[:1], tables)
    assert (one.tiles, one.frames_per_group, one.groups) == ((2, 6), 1, 1)


@pytest.mark.parametrize("which", ["fine", "coarse", "tables"])
def test_expand_score2_plan_for_raises_on_a_strided_tensor(which):
    args = dict(fine=_rand((2, 4, 96, 144), 2), coarse=_rand((2, 4, 48, 72), 3),
                tables=torch.zeros((2, 19)))
    t = args[which]
    args[which] = torch.cat([t, t], dim=-1)[..., ::2]      # same shape, stride 2
    assert args[which].shape == t.shape
    with pytest.raises(ValueError, match="contiguous"):
        bp.plan_for(args["fine"], args["coarse"], args["tables"])


# expand_score2 on a strip of rows (a lone image split over a mesh's 'space'
# axis): (rows of a 1080 x 1920 level, tile rows of the launch)
STRIPS = [((0, 1080), 68), ((0, 16), 1), ((16, 1080), 67), ((1072, 1080), 1),
          ((1071, 1080), 2), ((17, 33), 2), ((15, 16), 1), ((3, 5), 1), ((528, 544), 1)]


@pytest.mark.parametrize("rows,down", STRIPS, ids=[f"{a}-{b}" for (a, b), _ in STRIPS])
def test_expand_score2_strip_plan_offsets_its_tiles(rows, down):
    """The launch covers the level's tile rows r0 // 16 .. ceil(r1 / 16) - 1,
    on the level's grid: a strip from a tile row has the tiles of the whole
    level's launch there, one from an odd row shares its first tile row."""
    r0, r1 = rows
    plan = bp.launch_plan((1, 4, 1080, 1920), 0, rows)
    assert plan.tiles == (15, down) and plan.n_tiles == 15 * down
    assert (r0 // bp.TILE_H) * bp.TILE_H <= r0
    assert (r0 // bp.TILE_H + down) * bp.TILE_H >= r1 > (r0 // bp.TILE_H + down - 1) * bp.TILE_H
    _check_groups(plan.n_tiles, plan.frames_per_group, plan.groups, 1)
    assert bp.launch_plan((1, 4, 1080, 1920), 0, None) == bp.launch_plan(
        (1, 4, 1080, 1920), 0, (0, 1080))


@pytest.mark.parametrize("r0", [0, 1, 17, 33])
@pytest.mark.parametrize("ptr,W,vec", [(0, 144, True), (16, 144, True), (4, 144, False),
                                       (0, 131, False), (8, 132, False)])
def test_expand_score2_strip_plan_needs_its_first_element_aligned(ptr, W, r0, vec):
    """The vector arm reads the strip's rows four pixels at a time: its first
    element (ptr + 4 r0 W) and every row after it on a 16-byte boundary."""
    first = ptr + 4 * r0 * W
    assert vec == (W % 4 == 0 and first % 16 == 0)
    assert bp.launch_plan((2, 4, 96, W), ptr, (r0, 96)).vec == vec


@pytest.mark.parametrize("rows", [(-1, 5), (5, 97), (6, 5)])
def test_expand_score2_refuses_rows_outside_the_level(rows):
    with pytest.raises(ValueError, match="rows"):
        bp.launch_plan((1, 4, 96, 144), 0, rows)
    fine, coarse = _rand((1, 4, 96, 144), 2), _rand((1, 4, 48, 72), 3)
    core = fvvdp(device="cpu")._get_core(144, 96)
    with pytest.raises(ValueError, match="rows"):
        bp.expand_score2(fine, coarse, core._score_tables[0], core._meta[0], rows=rows)


def test_an_empty_strip_scores_zero_and_launches_nothing():
    fine, coarse = _rand((2, 4, 96, 144), 2), _rand((2, 4, 48, 72), 3)
    core = fvvdp(device="cpu")._get_core(144, 96)
    tabs, meta = core._score_tables[0], core._meta[0]
    from fovvideovdp_tpu_torch.ops.cuda import _lib
    _lib.reset_launch_counts()
    got = bp.expand_score2(fine, coarse, tabs, meta, rows=(40, 40))
    assert torch.equal(got, torch.zeros((2, 2)))
    parts = bp.expand_score2(fine, coarse, tabs, meta, rows=(96, 96), partials=True)
    assert parts.shape == (2, 0, 2)
    assert torch.equal(bp.sum_tile_partials(parts), torch.zeros((2, 2)))
    assert sum(_lib.launch_counts().values()) == 0


@pytest.mark.parametrize("rows", [(0, 96), (0, 16), (16, 96), (17, 61), (80, 96), (81, 96)])
@pytest.mark.parametrize("hw", [(96, 144), (96, 131)])
def test_expand_score2_plain_rows_against_the_whole_levels_slice(hw, rows):
    """The plain version on a strip scores the rows of the whole level's
    per-pixel D^beta; its tile partials are that map's sums over the
    kernel's tiles, and add up to the strip's sums."""
    H, W = hw
    r0, r1 = rows
    fine, coarse = _rand((2, 4, H, W), 2), _rand((2, 4, H // 2, -(-W // 2)), 3)
    core = fvvdp(device="cpu")._get_core(max(W, 16), H)
    for tabs, meta in zip(core._score_tables[:2], core._meta[:2]):
        contrast, L_bkg = bp._expand_contrast_plain(fine, coarse, (H, W), 1)
        maps = [bs.band_d_beta_plain(contrast[:, 2 * c], contrast[:, 2 * c + 1], L_bkg[:, 0],
                                     tabs[c], meta, (meta.q_s, meta.q_t)[c]) for c in (0, 1)]
        want = torch.stack([m[:, r0:r1].double().sum(dim=(-2, -1)) for m in maps], dim=-1)
        got = bp.expand_score2_plain(fine, coarse, tabs, meta, rows=rows).double()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
        parts = bp.expand_score2_plain(fine, coarse, tabs, meta, rows=rows, partials=True)
        plan = bp.launch_plan(fine.shape, 0, rows)
        assert parts.shape == (2, plan.n_tiles, 2)
        np.testing.assert_allclose(bp.sum_tile_partials(parts).double().numpy(),
                                   want.numpy(), rtol=1e-6)
        # tile (ty, tx) holds the map's rows of tile row r0 // 16 + ty
        ty, tx = (r0 // bp.TILE_H + plan.tiles[1] - 1) - r0 // bp.TILE_H, plan.tiles[0] - 1
        row0 = max(r0, (r0 // bp.TILE_H + ty) * bp.TILE_H)
        last = maps[0][:, row0:r1, tx * bp.TILE_W:].double().sum(dim=(-2, -1))
        np.testing.assert_allclose(parts[:, -1, 0].double().numpy(), last.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# mov_score
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,_,blocks", LEVELS_4K, ids=[f"{h}x{w}" for (h, w), _, _ in LEVELS_4K])
def test_mov_score_plan_at_the_4k_levels(hw, _, blocks):
    n = hw[0] * hw[1]
    plan = ms.launch_plan(F, n, n, [0, 0, 0, 0])
    assert plan.vec
    assert (plan.n_blocks, plan.frames_per_group, plan.groups) == blocks
    assert (plan.n_blocks - 1) * ms.BLOCK_PIXELS < n <= plan.n_blocks * ms.BLOCK_PIXELS
    _check_groups(plan.n_blocks, plan.frames_per_group, plan.groups, F)


@pytest.mark.parametrize("hw", [(67, 131), (17, 30), (9, 13), (1, 1)])
def test_mov_score_plan_takes_the_scalar_arm_off_a_multiple_of_4(hw):
    n = hw[0] * hw[1]
    assert n % 4
    plan = ms.launch_plan(3, n, n, [0, 0, 0, 0])
    assert not plan.vec and plan.n_blocks == -(-n // 1024)


@pytest.mark.parametrize("fs_L,ptrs,vec", [
    (400, [0, 0, 0, 0], True),
    (1200, [0, 1600, 0, 0], True),        # a channel of a (F, 3, h, w) stack
    (402, [0, 0, 0, 0], False),           # a frame stride off a multiple of 4
    (400, [0, 4, 0, 0], False),           # L_bkg off a 16-byte boundary
    (400, [4, 0, 0, 0], False),           # the band
    (400, [0, 0, 8, 0], False),           # the view directions
    (400, [0, 0, 0, 12], False),          # the rho coordinate
])
def test_mov_score_plan_needs_aligned_planes_for_the_vector_arm(fs_L, ptrs, vec):
    assert ms.launch_plan(5, 400, fs_L, ptrs).vec == vec


def _mov_tensors(F=5, h=10, w=40):
    return dict(band=torch.zeros((F, 4, h, w)), L=torch.ones((F, h, w)),
                vd=torch.zeros((2, h, w)), t_r=torch.zeros((h, w)),
                gaze=torch.zeros((F, 2)), V2s=torch.zeros((32, 19 * 4)))


def _mov_plan(t):
    return ms.plan_for(t["band"], t["L"], t["vd"], t["t_r"], t["gaze"], [("V2s", t["V2s"])])


def test_mov_score_plan_for_reads_the_views():
    t = _mov_tensors()
    plan, fs_L = _mov_plan(t)
    assert fs_L == 400 and plan.vec and plan == ms.launch_plan(
        5, 400, 400, [t[k].data_ptr() for k in ("band", "L", "vd", "t_r")])
    # L_bkg as core.py passes it: channel 0 of a (F, 1, h, w) stack
    plan, fs_L = _mov_plan(dict(t, L=torch.ones((5, 1, 10, 40))[:, 0]))
    assert fs_L == 400 and plan.vec
    # a channel of a wider stack keeps its planes aligned, at another stride
    plan, fs_L = _mov_plan(dict(t, L=torch.ones((5, 3, 10, 40))[:, 1]))
    assert fs_L == 1200 and plan.vec
    # four bytes off: contiguous planes, but the scalar arm
    plan, fs_L = _mov_plan(dict(t, L=_offset_by_one_float(t["L"])))
    assert fs_L == 400 and not plan.vec
    plan, _ = _mov_plan(dict(t, band=_offset_by_one_float(t["band"])))
    assert not plan.vec
    # band[:1] of an image: an offset of whole frames stays aligned
    plan, _ = _mov_plan(dict(t, band=t["band"][1:2], L=t["L"][1:2], gaze=t["gaze"][1:2]))
    assert plan.groups == 1 and plan.frames_per_group == 1


@pytest.mark.parametrize("which", ["band", "vd", "t_r", "gaze", "V2s", "L"])
def test_mov_score_plan_for_raises_on_a_strided_tensor(which):
    t = _mov_tensors()
    x = t[which]
    t[which] = torch.cat([x, x], dim=-1)[..., ::2]         # same shape, stride 2
    assert t[which].shape == x.shape
    with pytest.raises(ValueError, match="contiguous"):
        _mov_plan(t)


@pytest.mark.parametrize("lut,two,shared", [
    ((32, 19, 4), True, True), ((32, 19, 3), True, True), ((32, 32, 32), True, False),
    ((32, 32, 32), False, False), ((32, 20, 8), True, True), ((32, 20, 9), True, False),
    ((32, 20, 9), False, True), ((5, 1, 1), True, True)])
def test_mov_score_lut_place_follows_its_bytes(lut, two, shared):
    """Up to 40 KB of tables are staged in shared memory, more are read from
    global memory; decided without the card."""
    n_e, ny, nr = lut
    score = bs.ScoreMeta(y0=-7.0, dy=0.6, Ymin=0.01, Ymax=100.0, p=2.4, q_s=3.2, q_t=3.1,
                         c10=0.3, corr=0.3, beta=0.96)
    meta = ms.MovMeta(score, 0.0, 0.35, 0.0, 100.0, ny, nr, None if two else -0.8)
    assert ms.lut_in_shared(n_e, meta) == shared
    assert shared == (4 * (2 if two else 1) * n_e * ny * nr <= ms.MAX_SHARED_LUT_BYTES)


# ---------------------------------------------------------------------------
# reciprocals in place of divisions
# ---------------------------------------------------------------------------

def _score_with_reciprocals(fine, coarse, tables, m, bkg=1):
    """expand_score2_plain with ``* (1 / L_bkg)`` and ``* (1 / dy)`` where it
    divides; everything else as the plain version."""
    e = gausspyr_expand(coarse, (fine.shape[-2], fine.shape[-1]))
    L = torch.clamp(e[:, bkg:bkg + 1], min=0.1)
    contrast = torch.clamp((fine - e) * (1.0 / L), max=1000.0)
    L = L[:, 0]
    n = tables.shape[1]
    inv_dy = torch.tensor(bs.inv_f32(m.dy), dtype=torch.float32)
    u = torch.clamp((torch.log2(torch.clamp(L, m.Ymin, m.Ymax)) - m.y0) * inv_dy,
                    0.0, float(n - 1))
    i0 = torch.clamp(torch.floor(u), 0, n - 1).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    f = u - i0.to(u.dtype)
    out = []
    for c, q in enumerate((m.q_s, m.q_t)):
        S_log = tables[c][i0] * (1.0 - f) + tables[c][i1] * f
        out.append(bs._d_beta_sum(contrast[:, 2 * c], contrast[:, 2 * c + 1],
                                  torch.exp2(S_log) * m.corr, m, q))
    return torch.stack(out, dim=-1)


@pytest.mark.parametrize("hw", [(96, 144), (67, 131), (160, 384)])
def test_reciprocals_stand_for_divisions_within_1e5(hw):
    """The kernel multiplies by 1 / L_bkg and by 1 / dy where the plain
    version divides.  A rounded reciprocal moves each contrast, and the table
    coordinate, by at most one float32 ulp (6e-8 relative); D^beta follows
    the contrast with an exponent of at most p * beta ~ 2.3, and the errors
    of the >= 1e4 pixels of a frame do not line up.  Bar: 1e-5 relative on the
    per-frame sums, a tenth of the kernel's bar against its plain version.
    Inputs: those of test_expand_score2_kernel_matches_plain."""
    H, W = hw
    assert H * W >= 8000
    core = fvvdp(device="cpu")._get_core(max(W, 16), max(H, 16))
    fine = _rand((2, 4, H, W), 2)
    coarse = _rand((2, 4, -(-H // 2), -(-W // 2)), 3)
    for tables, meta in zip(core._score_tables, core._meta):
        want = bp.expand_score2_plain(fine, coarse, tables, meta).double()
        got = _score_with_reciprocals(fine, coarse, tables, meta).double()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        assert rel < 1e-5, rel


def test_inv_f32_is_the_float32_reciprocal():
    for x in (0.6, 0.35, 1.1111111, 3.0):
        assert bs.inv_f32(x) == float(np.float32(1.0) / np.float32(x))
        assert abs(bs.inv_f32(x) * x - 1.0) < 2e-7


# ---------------------------------------------------------------------------
# band scorers (band_score, band_score2, band_score2_fov)
# ---------------------------------------------------------------------------

# blocks, frames per group and groups of band_score2_fov at the seven 4K
# levels with tables of 19 knots (the shipped LUT at standard_4k): blocks of
# 512 pixels, two of which fit on an SM
TABLE_LEVELS_4K = [(16200, 32, 1), (4050, 32, 1), (1013, 32, 1), (254, 16, 2), (64, 7, 5),
                   (16, 2, 16), (4, 1, 32)]


@pytest.mark.parametrize("level", range(7), ids=[f"{h}x{w}" for (h, w), _, _ in LEVELS_4K])
def test_band_score_plans_at_the_4k_levels(level):
    """The three entry points on the planes core.py gives them: band_score
    on channel views of the (F, 4, h, w) stack (frame stride 4 hw) and
    L_bkg (frame stride hw), band_score2 and band_score2_fov on the stack.
    Every 4K level takes the vector arm."""
    (h, w), _, blocks = LEVELS_4K[level]
    n = h * w
    base = 1 << 20         # an aligned address; channel c starts 4 c n bytes later
    one = bs.launch_plan(F, n, [4 * n, 4 * n, n], [base + 8 * n, base + 12 * n, 0])
    two = bs.launch_plan(F, n, [4 * n] * 4 + [n], [base + 4 * c * n for c in range(4)] + [0])
    fov = bs.launch_plan(F, n, [4 * n] * 4 + [n], [base + 4 * c * n for c in range(4)] + [0], 19)
    for plan, want, P in ((one, blocks, 1024), (two, blocks, 1024),
                          (fov, TABLE_LEVELS_4K[level], 512)):
        assert plan.vec and plan.block_pixels == P
        assert (plan.n_blocks, plan.frames_per_group, plan.groups) == want
        assert (plan.n_blocks - 1) * P < n <= plan.n_blocks * P
        _check_groups(plan.n_blocks, plan.frames_per_group, plan.groups, F)


def test_band_score_plans_take_the_scalar_arm_at_the_vr_level_of_2250_pixels():
    """htc_vive_pro (1440 x 1600) has a 50 x 45 level: 2250 pixels, not a
    multiple of 4, so every entry point takes the scalar arm there."""
    plan = fvvdp(display_name="htc_vive_pro", device="cpu")._get_core(1440, 1600).plan
    assert (50, 45) in plan.level_shapes
    band, L = torch.zeros((8, 4, 50, 45)), torch.ones((8, 1, 50, 45))[:, 0]
    stack = (("band", band), ("L_bkg", L))
    for name, p, n_tab, P in (("band_score", _one_channel(band, L, cc=0), 0, 1024),
                              ("band_score2", stack, 0, 1024),
                              ("band_score2_fov", stack, 19, 512)):
        got, strides = bs.plan_for(name, p, n_tab)
        assert not got.vec and got.block_pixels == P and got.n_blocks == -(-2250 // P)
        assert strides[0] == 4 * 2250 and strides[-1] == 2250
        _check_groups(got.n_blocks, got.frames_per_group, got.groups, 8)


def _one_channel(band, L, cc=1):
    return (("T", band[:, 2 * cc]), ("R", band[:, 2 * cc + 1]), ("L_bkg", L))


@pytest.mark.parametrize("C", [4, 2])
def test_band_score_plan_for_takes_channel_views_of_a_stack(C):
    """band_score reads channel views of the (F, C, h, w) contrast stack as
    they are, no copy: aligned planes at frame stride C hw keep the vector
    arm; a stack whose planes are not a multiple of 4 pixels does not."""
    band, L = torch.zeros((5, C, 10, 40)), torch.ones((5, 1, 10, 40))[:, 0]
    plan, strides = bs.plan_for("band_score", _one_channel(band, L, cc=C // 2 - 1))
    assert plan.vec and strides == [C * 400, C * 400, 400]
    assert plan == bs.launch_plan(5, 400, strides, [band[:, C - 2].data_ptr(),
                                                    band[:, C - 1].data_ptr(), L.data_ptr()])
    odd, L_odd = torch.zeros((5, C, 10, 41)), torch.ones((5, 10, 41))
    assert not bs.plan_for("band_score", _one_channel(odd, L_odd, cc=C // 2 - 1))[0].vec


@pytest.mark.parametrize("which", ["band", "L_bkg"])
def test_band_score_plans_leave_the_vector_arm_4_bytes_off_a_boundary(which):
    """Contiguous planes that start 4 bytes past a 16-byte boundary: the
    scalar arm, for every entry point."""
    band, L = torch.zeros((5, 4, 10, 40)), torch.ones((5, 10, 40))
    assert bs.plan_for("band_score2", (("band", band), ("L_bkg", L)))[0].vec
    if which == "band":
        band = _offset_by_one_float(band)
    else:
        L = _offset_by_one_float(L)
    assert not bs.plan_for("band_score", _one_channel(band, L))[0].vec
    assert not bs.plan_for("band_score2", (("band", band), ("L_bkg", L)))[0].vec
    assert not bs.plan_for("band_score2_fov", (("band", band), ("L_bkg", L)), 19)[0].vec


@pytest.mark.parametrize("fs_L,ptrs,vec", [
    (400, [0, 1600, 0], True),
    (402, [0, 1600, 0], False),           # L_bkg's frame stride off a multiple of 4
    (400, [0, 1604, 0], False),           # R off a 16-byte boundary
    (400, [0, 1600, 8], False),           # L_bkg
])
def test_band_score_plan_needs_aligned_planes_for_the_vector_arm(fs_L, ptrs, vec):
    assert bs.launch_plan(5, 400, [1600, 1600, fs_L], ptrs).vec == vec


def test_band_score_plan_for_raises_on_a_strided_plane():
    band, L = torch.zeros((5, 4, 10, 40)), torch.ones((5, 10, 40))
    with pytest.raises(ValueError, match="contiguous"):
        bs.plan_for("band_score", _one_channel(band[..., ::2], L[..., ::2]))


@pytest.mark.parametrize("n,P", [(1, 1024), (7, 1024), (19, 512), (28, 256), (64, 128)])
def test_band_score2_fov_block_fits_its_tables_twice_on_an_sm(n, P):
    """The per-pixel tables (8 n bytes a pixel) size the block: the most
    pixels of which two blocks fit on an SM's 228 KB, always within the
    227 KB one block may take."""
    assert bs.table_block_pixels(n) == P
    used = bs.pixel_table_bytes(n, P) + bs.BLOCK_SHARED_OVERHEAD
    assert used <= bs.MAX_BLOCK_SHARED_BYTES == 227 * 1024
    assert 2 * used <= bs.SM_SHARED_BYTES
    if P < bs.BLOCK_PIXELS:
        assert 2 * (bs.pixel_table_bytes(n, 2 * P) + bs.BLOCK_SHARED_OVERHEAD) > bs.SM_SHARED_BYTES
    plan = bs.launch_plan(3, 10000, [40000, 10000], [0, 0], n)
    assert plan.block_pixels == P and plan.n_blocks == -(-10000 // P)


@pytest.mark.parametrize("n", [0, 65])
def test_band_score2_fov_refuses_tables_the_kernel_cannot_hold(n):
    with pytest.raises(ValueError, match="knots"):
        bs.launch_plan(3, 10000, [40000, 10000], [0, 0], n) if n else bs.table_block_pixels(n)


def _band(F, h, w, seed=6):
    rng = np.random.default_rng(seed)
    band = torch.from_numpy((rng.standard_normal((F, 4, h, w)) * 0.05).astype(np.float32))
    L = torch.from_numpy((10.0 ** rng.uniform(-1.3, 2.6, (F, h, w))).astype(np.float32))
    return band, L


def _table_coord_with_reciprocal(L, m, n):
    """band_score's table coordinate with ``* (1 / dy)`` where it divides."""
    inv_dy = torch.tensor(bs.inv_f32(m.dy), dtype=torch.float32)
    return torch.clamp((torch.log2(torch.clamp(L, m.Ymin, m.Ymax)) - m.y0) * inv_dy,
                       0.0, float(n - 1))


@pytest.mark.parametrize("hw", [(96, 144), (67, 131)])
def test_reciprocal_of_dy_stands_for_the_division_in_the_band_scorers(monkeypatch, hw):
    """The band kernels multiply by inv_f32(dy) where the plain versions
    divide by dy: the table coordinate moves by at most an ulp or two, and
    the per-frame sums of every entry point by under 1e-5 relative (a tenth
    of the kernels' bar), on the per-channel LUT tables, the shared-grid
    tables and a fixation point's per-pixel tables."""
    H, W = hw
    band, L = _band(2, H, W)
    fv_pc = fvvdp(device="cpu")
    luts = [dict(l) for l in fv_pc._luts]
    luts[1] = dict(luts[1], Y=luts[1]["Y"][:-1], Y_log=luts[1]["Y_log"][:-1],
                   S_log=luts[1]["S_log"][:-1])
    fv_pc.load_state(fv_pc.parameters, luts)
    core_pc = fv_pc._get_core(W, H)
    core = fvvdp(device="cpu")._get_core(W, H)
    core_fov = fvvdp(device="cpu", foveated=True)._get_core(W, H)
    tabs = core_fov.fov_tables((W / 3, H / 2))

    def sums():
        out = []
        for bb, (h, w) in enumerate(core.plan.level_shapes[:3]):
            b = band[..., :h, :w].contiguous()
            l = L[..., :h, :w].contiguous()
            for cc in range(2):
                m = core_pc._channel_meta[bb][cc]
                out.append(bs.band_score_plain(b[:, 2 * cc], b[:, 2 * cc + 1], l,
                                               core_pc._channel_tables[bb][cc], m,
                                               (m.q_s, m.q_t)[cc]))
            out.append(bs.band_score2_plain(b, l, core._score_tables[bb], core._meta[bb]))
            out.append(bs.band_score2_fov_plain(b, l, *tabs[bb], core_fov._fov_meta[bb]))
        return [o.double() for o in out]

    want = sums()
    monkeypatch.setattr(bs, "_table_coord", _table_coord_with_reciprocal)
    got = sums()
    for g, w_ in zip(got, want):
        assert ((g - w_).abs() / w_.abs().clamp_min(1e-30)).max().item() < 1e-5


# ---------------------------------------------------------------------------
# gausspyr_reduce
# ---------------------------------------------------------------------------

# (H, W) of the input of each of the seven reduces of a 4K block's pyramid,
# with warps per block, strip height, column blocks and strips
REDUCE_4K = [
    ((2160, 3840), (4, 32, 8, 34)),
    ((1080, 1920), (4, 32, 4, 17)),
    ((540, 960), (4, 32, 2, 9)),
    ((270, 480), (4, 16, 1, 9)),
    ((135, 240), (2, 8, 1, 9)),
    ((68, 120), (1, 8, 1, 5)),
    ((34, 60), (1, 8, 1, 3)),
]
PLANES_4K = 4 * F    # 32 frames x 4 temporal responses


def _check_reduce_plan(p, N, H, W):
    """The plan covers the planes, the output rows and the width (lanes 1..30
    of a warp write 2 outputs each), with no column block past the width,
    and the vector arm only where 16-byte loads fit."""
    Ho, Wo = -(-H // 2), -(-W // 2)
    warps = p.col_blocks * p.warps_per_block
    assert 1 <= p.warps_per_block <= red.MAX_WARPS
    assert 2 * red.LANES_OUT * warps >= Wo
    assert 2 * red.LANES_OUT * p.warps_per_block * (p.col_blocks - 1) < Wo
    assert (p.strips - 1) * p.strip_rows < Ho <= p.strips * p.strip_rows
    assert p.strip_rows in red.STRIP_ROWS
    assert not p.vec or W % 4 == 0
    assert N * p.strips * p.col_blocks <= red.MAX_GRID_X


@pytest.mark.parametrize("hw,plan", REDUCE_4K, ids=[f"{h}x{w}" for (h, w), _ in REDUCE_4K])
def test_reduce_plan_at_the_4k_levels(hw, plan):
    """Every 4K level takes the vector arm (its width is a multiple of 4, its
    height may be odd: 135), the tallest strip that still fills a wave of
    blocks, and as many warps per block as the width has, up to 4."""
    H, W = hw
    p = red.launch_plan(PLANES_4K, H, W, 0, 0)
    assert p.vec and (p.warps_per_block, p.strip_rows, p.col_blocks, p.strips) == plan
    assert p.threads == 32 * p.warps_per_block
    _check_reduce_plan(p, PLANES_4K, H, W)
    if p.strip_rows > red.STRIP_ROWS[-1]:
        assert PLANES_4K * p.col_blocks * p.strips >= red.FILL_BLOCKS


@pytest.mark.parametrize("hw", [(67, 131), (17, 30), (2, 2), (3, 5), (50, 126), (9, 13),
                                (135, 241), (4, 2)])
def test_reduce_plan_takes_the_scalar_arm_off_a_multiple_of_4(hw):
    H, W = hw
    p = red.launch_plan(8, H, W, 0, 0)
    assert p.vec == (W % 4 == 0)
    _check_reduce_plan(p, 8, H, W)


@pytest.mark.parametrize("x_ptr,y_ptr,vec", [(0, 0, True), (256, 8, True), (4, 0, False),
                                             (8, 0, False), (20, 0, False), (0, 4, False)])
def test_reduce_plan_needs_aligned_planes_for_the_vector_arm(x_ptr, y_ptr, vec):
    assert red.launch_plan(128, 1080, 1920, x_ptr, y_ptr).vec == vec


@pytest.mark.parametrize("H", [2, 3, 17, 135, 1079, 2160])
def test_reduce_plan_strips_cover_odd_and_even_heights(H):
    for N in (1, 128):
        _check_reduce_plan(red.launch_plan(N, H, 240, 0, 0), N, H, 240)


def test_reduce_plan_takes_more_planes_than_grid_z_holds():
    """Planes share grid.x with the strips and column blocks, so 100,000
    planes launch (grid.z stops at 65,535); a grid past grid.x is refused."""
    p = red.launch_plan(100_000, 17, 30, 0, 0)
    assert p.strips * p.col_blocks * 100_000 <= red.MAX_GRID_X
    with pytest.raises(ValueError, match="blocks"):
        red.launch_plan(2**30, 64, 3840, 0, 0)


def test_reduce_plan_for_reads_the_tensors():
    x = _rand((2, 4, 67, 132), 1)
    y = torch.empty((2, 4, 34, 66))
    assert red.plan_for(x, y) == red.launch_plan(8, 67, 132, x.data_ptr(), y.data_ptr())
    assert red.plan_for(x, y).vec
    assert not red.plan_for(_offset_by_one_float(x), y).vec
