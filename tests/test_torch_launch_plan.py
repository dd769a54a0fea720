"""What Python decides for the CUDA kernels ``expand_score2`` and
``mov_score``: the arm (16-byte loads, or 4-byte loads each masked), the grid
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
