"""Scorers of one materialised contrast band: wrappers of
``csrc/band_score.cu`` and their plain versions.

Replace the TPU kernels of ``fovvideovdp_tpu/ops/pallas/band_score.py``:
``_band_score_kernel`` (:func:`band_score`, one channel, per-channel LUTs),
``_band_score2_kernel`` (:func:`band_score2`, both channels, 1-D tables) and
``_band_score2_fov_kernel`` (:func:`band_score2_fov`, both channels,
per-pixel tables of a fixed gaze).  Each returns per-frame sums over pixels
of D^beta.  The plain versions mirror ``_band_score_jnp`` (direct form) and
``_band_score2_fov_jnp`` (telescoped table interpolation).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fovvideovdp_tpu_torch.csf import _np, two_knots
from fovvideovdp_tpu_torch.ops.cuda import _autograd, _lib


class ScoreMeta(NamedTuple):
    """Scalars of the band score, as Python floats."""
    y0: float
    dy: float
    Ymin: float
    Ymax: float
    p: float
    q_s: float
    q_t: float
    c10: float
    corr: float
    beta: float


def score_meta(lut, p, q_sust, q_trans, mask_c, sens_corr, beta) -> ScoreMeta:
    Y_log = _np(lut["Y_log"])
    Y = _np(lut["Y"])
    return ScoreMeta(float(Y_log[0]),
                     float((Y_log[-1] - Y_log[0]) / (Y_log.shape[0] - 1)),
                     float(Y[0]), float(Y[-1]),
                     float(p), float(q_sust), float(q_trans),
                     float(10.0 ** mask_c), float(sens_corr), float(beta))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _d_beta(T, R, Se, m: ScoreMeta, q: float) -> torch.Tensor:
    """Masking and the beta power per pixel, direct form."""
    Tn = T * Se
    Rn = R * Se
    M = m.c10 * torch.minimum(torch.abs(Tn), torch.abs(Rn))
    D = torch.clamp(torch.pow(torch.abs(Tn - Rn), m.p) / (1.0 + torch.pow(M, q)),
                    max=1e4)
    return torch.pow(D, m.beta)


def _d_beta_sum(T, R, Se, m: ScoreMeta, q: float) -> torch.Tensor:
    """Masking and the beta-power sum over pixels, direct form."""
    return torch.sum(_d_beta(T, R, Se, m, q), dim=(-2, -1))


def _table_coord(L, m: ScoreMeta, n: int) -> torch.Tensor:
    return torch.clamp((torch.log2(torch.clamp(L, m.Ymin, m.Ymax)) - m.y0) / m.dy,
                       0.0, float(n - 1))


def band_d_beta_plain(T, R, L, table, m: ScoreMeta, q: float) -> torch.Tensor:
    """D^beta per pixel for one channel (direct form)."""
    n = table.shape[0]
    u = _table_coord(L, m, n)
    i0, i1, f = two_knots(u, n)
    S_log = table[i0] * (1.0 - f) + table[i1] * f
    return _d_beta(T, R, torch.exp2(S_log) * m.corr, m, q)


def band_score_plain(T, R, L, table, m: ScoreMeta, q: float) -> torch.Tensor:
    """Per-frame sum over pixels of D^beta for one channel (direct form)."""
    return torch.sum(band_d_beta_plain(T, R, L, table, m, q), dim=(-2, -1))


def band_score2_plain(band, L_bkg, tables, meta: ScoreMeta) -> torch.Tensor:
    return torch.stack([
        band_score_plain(band[:, 0], band[:, 1], L_bkg, tables[0], meta, meta.q_s),
        band_score_plain(band[:, 2], band[:, 3], L_bkg, tables[1], meta, meta.q_t),
    ], dim=-1)


def band_score2_fov_plain(band, L_bkg, tabs_s, tabs_t, meta: ScoreMeta) -> torch.Tensor:
    n = tabs_s.shape[0]
    u = _table_coord(L_bkg, meta, n)

    def s_of(tabs):
        s = torch.zeros_like(u) + tabs[0]
        for i in range(n - 1):
            s = s + (tabs[i + 1] - tabs[i]) * torch.clamp(u - float(i), 0.0, 1.0)
        return torch.exp2(s) * meta.corr

    return torch.stack([
        _d_beta_sum(band[:, 0], band[:, 1], s_of(tabs_s), meta, meta.q_s),
        _d_beta_sum(band[:, 2], band[:, 3], s_of(tabs_t), meta, meta.q_t),
    ], dim=-1)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name: str, ref: torch.Tensor, tensors) -> None:
    for label, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} is on {t.device}, the band on {ref.device}")


def _check_band(name: str, band, L_bkg) -> None:
    if band.dim() != 4 or band.shape[1] != 4:
        raise ValueError(f"{name}: band must be (F, 4, h, w), got {tuple(band.shape)}")
    if tuple(L_bkg.shape) != (band.shape[0],) + tuple(band.shape[2:]):
        raise ValueError(f"{name}: L_bkg {tuple(L_bkg.shape)} does not match the band "
                         f"{tuple(band.shape)}")


def _frame_stride(name: str, label: str, t: torch.Tensor) -> int:
    """Frame stride of a (F, h, w) tensor whose planes are contiguous (a
    channel of a (F, C, h, w) stack is such a view), or of a contiguous
    (F, C, h, w) stack, whose C planes lie hw apart.  Reads strides only."""
    if t.dim() == 4:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {label}")
        return t.shape[1] * t.shape[2] * t.shape[3]
    F, h, w = t.shape
    sf, sh, sw = t.stride()
    if (w > 1 and sw != 1) or (h > 1 and sh != w) or (F > 1 and sf < h * w):
        raise ValueError(f"{name}: {label} needs contiguous (h, w) planes, got strides "
                         f"{(sf, sh, sw)} for shape {tuple(t.shape)}")
    return sf if F > 1 else h * w


def inv_f32(x: float) -> float:
    """1 / x as the kernels that multiply by it receive it: the float32
    reciprocal of the float32 value."""
    return float(np.float32(1.0) / np.float32(x))


def _scalars(m: ScoreMeta, *q):
    return (m.y0, m.dy, m.Ymin, m.Ymax, m.p, *q, math.log2(m.c10), math.log2(m.corr), m.beta)


def _kernel_scalars(m: ScoreMeta, *q):
    """The scalars as the C entry points take them: 1 / dy in place of dy."""
    return _scalars(m._replace(dy=inv_f32(m.dy)), *q)


# blocks below which a level's frames are split over grid.y (two blocks per
# SM of the 132)
FILL_BLOCKS = 264


def frame_groups(n_blocks: int, F: int) -> Tuple[int, int]:
    """(frames per group, groups) of a kernel whose blocks walk their frames:
    one group unless the level's ``n_blocks`` cannot fill the card, then as
    many as fill it, at most one per frame."""
    g = 1 if n_blocks >= FILL_BLOCKS else min(F, -(-FILL_BLOCKS // n_blocks))
    frames_per_group = -(-F // g)
    return frames_per_group, -(-F // frames_per_group)


# csrc/band_score.cu: pixels of a block of the 1-D-table instances (256
# threads x 4), the blocks the per-pixel instance may take, the most knots
BLOCK_PIXELS = 1024
TABLE_BLOCK_PIXELS = (1024, 512, 256, 128)
MAX_GRID = 64
SM_SHARED_BYTES = 233472         # shared memory of one H100 SM, 228 KB
MAX_BLOCK_SHARED_BYTES = 232448  # the most one block may take, 227 KB
# a block's shared memory besides the per-pixel tables: the frame sums
# (2 KB), the 1-D tables (512 B) and what the card reserves per block (1 KB)
BLOCK_SHARED_OVERHEAD = 2048 + 512 + 1024


def pixel_table_bytes(n: int, block_pixels: int) -> int:
    """Shared memory of a block's per-pixel tables: two channels, n knots."""
    return 8 * n * block_pixels


def table_block_pixels(n: int) -> int:
    """Pixels of a block of band_score2_fov for tables of n knots: the most
    of which two blocks fit on an SM, so that one block's table copy overlaps
    the other's frames (n = 19: 512 pixels, 76 KB of tables)."""
    if not 1 <= n <= MAX_GRID:
        raise ValueError(f"band_score2_fov: tables of {n} knots, the kernel takes 1..{MAX_GRID}")
    return next(P for P in TABLE_BLOCK_PIXELS
                if 2 * (pixel_table_bytes(n, P) + BLOCK_SHARED_OVERHEAD) <= SM_SHARED_BYTES)


class LaunchPlan(NamedTuple):
    """How a band scorer is launched on one band: the arm (16-byte loads, or
    4-byte loads each masked), the pixels of a block, the blocks of the plane
    (the middle dimension of the partial sums) and the split of the frames
    over grid.y."""
    vec: bool
    block_pixels: int
    n_blocks: int
    frames_per_group: int
    groups: int


def launch_plan(F: int, hw: int, frame_strides, data_ptrs, n_pixel_tables: int = 0
                ) -> LaunchPlan:
    """The plan for F frames of hw pixels.  The vector arm needs every plane
    it reads four pixels at a time on a 16-byte boundary: hw and each
    plane's frame stride (``frame_strides``, in floats) multiples of 4, and
    aligned first elements (``data_ptrs``).  ``n_pixel_tables``: the knots of
    band_score2_fov's per-pixel tables, which size its block (0 for the
    1-D-table instances).  One group of frames unless the level's blocks
    cannot fill the card."""
    vec = hw % 4 == 0 and all(s % 4 == 0 for s in frame_strides) \
        and all(p % 16 == 0 for p in data_ptrs)
    P = table_block_pixels(n_pixel_tables) if n_pixel_tables else BLOCK_PIXELS
    n_blocks = -(-hw // P)
    return LaunchPlan(vec, P, n_blocks, *frame_groups(n_blocks, F))


def plan_for(name: str, planes, n_pixel_tables: int = 0) -> Tuple[LaunchPlan, list]:
    """The launch plan for what a scorer reads (``planes``: [(label,
    tensor)], each a (F, h, w) tensor with contiguous (h, w) planes, as a
    channel of a (F, C, h, w) stack is, or a contiguous (F, C, h, w) stack
    whose C planes are all read) and their frame strides; raises on what the
    kernel cannot take.  Reads shapes, strides and addresses only, on any
    device."""
    strides = [_frame_stride(name, label, t) for label, t in planes]
    first = planes[0][1]
    return launch_plan(first.shape[0], first.shape[-2] * first.shape[-1], strides,
                       [t.data_ptr() for _, t in planes], n_pixel_tables), strides


def _out(plan: LaunchPlan, F: int, device):
    """Partials (F, blocks, 2) and output (F, 2) of one launch."""
    return (torch.empty((F, plan.n_blocks, 2), dtype=torch.float32, device=device),
            torch.empty((F, 2), dtype=torch.float32, device=device))


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {t.device}")
    return False


# bytes the plain version's autograd graph keeps per frame, as a multiple of
# one frame of its inputs (_autograd.KernelOp): measured at 256 x 512 with
# saved-tensor hooks (28, 32, and 62.4 for 19 knots: the telescoped sum keeps
# two planes a knot), and room for the backward's own
GRAPH_BYTES = {"band_score": 36.0, "band_score2": 40.0, "band_score2_fov": 72.0}


@_autograd.differentiable(band_score_plain, diff=(0, 1, 2), framed=(0, 1, 2),
                          graph_bytes=GRAPH_BYTES["band_score"])
def band_score(T: torch.Tensor, R: torch.Tensor, L_bkg: torch.Tensor,
               table: torch.Tensor, meta: ScoreMeta, q: float) -> torch.Tensor:
    """One temporal channel of one band: T, R contrast and L_bkg, each
    (F, h, w) (channel views of a (F, C, h, w) stack are taken as they
    are); table (n,) log2-sensitivity on the Y grid of ``meta``; ``q`` the
    channel's masking exponent.  Returns (F,).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if T.dim() != 3 or R.shape != T.shape or L_bkg.shape != T.shape:
        raise ValueError(f"band_score: T, R, L_bkg must be equal (F, h, w), got "
                         f"{tuple(T.shape)}, {tuple(R.shape)}, {tuple(L_bkg.shape)}")
    if table.dim() != 1:
        raise ValueError(f"band_score: table must be (n,), got {tuple(table.shape)}")
    _check("band_score", T, (("T", T), ("R", R), ("L_bkg", L_bkg), ("table", table)))
    if _on_cpu("band_score", T):
        return band_score_plain(T, R, L_bkg, table, meta, q)
    if not table.is_contiguous():
        raise ValueError("band_score needs a contiguous table")
    plan, strides = plan_for("band_score", (("T", T), ("R", R), ("L_bkg", L_bkg)))
    F, h, w = T.shape
    partials, out = _out(plan, F, T.device)
    fn = _lib.kernel_fn("band_score")
    with torch.cuda.device(T.device):
        rc = fn(T.data_ptr(), R.data_ptr(), L_bkg.data_ptr(), table.data_ptr(),
                partials.data_ptr(), out.data_ptr(), F, h * w, *strides,
                table.shape[0], int(plan.vec), *plan[1:], *_kernel_scalars(meta, float(q)),
                _lib.stream_ptr(T))
    _lib.check(rc, "band_score")
    _lib.count_launch("band_score")
    return out[:, 0]


@_autograd.differentiable(band_score2_plain, diff=(0, 1), framed=(0, 1),
                          graph_bytes=GRAPH_BYTES["band_score2"])
def band_score2(band: torch.Tensor, L_bkg: torch.Tensor, tables: torch.Tensor,
                meta: ScoreMeta) -> torch.Tensor:
    """Both temporal channels of one band: band (F, 4, h, w) contrast stack
    [T-sust, R-sust, T-trans, R-trans], L_bkg (F, h, w), tables (2, n) on a
    shared Y grid.  Returns (F, 2).  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""
    _check_band("band_score2", band, L_bkg)
    if tables.dim() != 2 or tables.shape[0] != 2:
        raise ValueError(f"band_score2: tables must be (2, n), got {tuple(tables.shape)}")
    _check("band_score2", band, (("band", band), ("L_bkg", L_bkg), ("tables", tables)))
    if _on_cpu("band_score2", band):
        return band_score2_plain(band, L_bkg, tables, meta)
    if not (band.is_contiguous() and tables.is_contiguous()):
        raise ValueError("band_score2 needs a contiguous band and tables")
    plan, strides = plan_for("band_score2", (("band", band), ("L_bkg", L_bkg)))
    F, _, h, w = band.shape
    partials, out = _out(plan, F, band.device)
    fn = _lib.kernel_fn("band_score2")
    with torch.cuda.device(band.device):
        rc = fn(band.data_ptr(), L_bkg.data_ptr(), tables.data_ptr(),
                partials.data_ptr(), out.data_ptr(), F, h * w, strides[-1], tables.shape[1],
                int(plan.vec), *plan[1:], *_kernel_scalars(meta, meta.q_s, meta.q_t),
                _lib.stream_ptr(band))
    _lib.check(rc, "band_score2")
    _lib.count_launch("band_score2")
    return out


@_autograd.differentiable(band_score2_fov_plain, diff=(0, 1), framed=(0, 1),
                          graph_bytes=GRAPH_BYTES["band_score2_fov"])
def band_score2_fov(band: torch.Tensor, L_bkg: torch.Tensor, tabs_s: torch.Tensor,
                    tabs_t: torch.Tensor, meta: ScoreMeta) -> torch.Tensor:
    """Both temporal channels with per-pixel CSF tables (fixed-gaze
    foveation): band (F, 4, h, w), L_bkg (F, h, w), tabs_s / tabs_t
    (n, h, w) plane-major log2-sensitivity tables on the Y grid of ``meta``.
    Returns (F, 2).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    _check_band("band_score2_fov", band, L_bkg)
    for label, t in (("tabs_s", tabs_s), ("tabs_t", tabs_t)):
        if t.dim() != 3 or tuple(t.shape[1:]) != tuple(band.shape[2:]) \
                or t.shape[0] != tabs_s.shape[0]:
            raise ValueError(f"band_score2_fov: {label} must be (n, h, w) for the band "
                             f"{tuple(band.shape)}, got {tuple(t.shape)}")
    _check("band_score2_fov", band, (("band", band), ("L_bkg", L_bkg),
                                     ("tabs_s", tabs_s), ("tabs_t", tabs_t)))
    if _on_cpu("band_score2_fov", band):
        return band_score2_fov_plain(band, L_bkg, tabs_s, tabs_t, meta)
    if not (band.is_contiguous() and tabs_s.is_contiguous() and tabs_t.is_contiguous()):
        raise ValueError("band_score2_fov needs a contiguous band and tables")
    plan, strides = plan_for("band_score2_fov", (("band", band), ("L_bkg", L_bkg)),
                            tabs_s.shape[0])
    F, _, h, w = band.shape
    partials, out = _out(plan, F, band.device)
    fn = _lib.kernel_fn("band_score2_fov")
    with torch.cuda.device(band.device):
        rc = fn(band.data_ptr(), L_bkg.data_ptr(), tabs_s.data_ptr(), tabs_t.data_ptr(),
                partials.data_ptr(), out.data_ptr(), F, h * w, strides[-1], tabs_s.shape[0],
                int(plan.vec), *plan[1:], *_kernel_scalars(meta, meta.q_s, meta.q_t),
                _lib.stream_ptr(band))
    _lib.check(rc, "band_score2_fov")
    _lib.count_launch("band_score2_fov")
    return out
