"""Fused contrast-pyramid-level scorer: wrapper of ``csrc/band_pipeline.cu``
and its plain version.

Replaces the TPU kernel ``fovvideovdp_tpu/ops/pallas/band_pipeline.py``
``_expand_score_kernel``.  The plain version mirrors the JAX fallback
``_expand_score2_jnp``: the materialised expand + Weber contrast
(``ops/pyramid.py``) followed by the direct-form two-channel band score
(``ops/cuda/band_score.py``, the JAX package's ``_band_score2_jnp``).

A row range scores a strip of the fine level, and ``partials=True`` returns
the per-tile partial sums instead of the per-frame sums: the cards of a
lone image split over a mesh's 'space' axis each score their strip, and
:func:`sum_tile_partials` adds the gathered partials as one launch of the
whole level adds its own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as nnf

from fovvideovdp_tpu_torch.ops.cuda import _autograd, _lib
from fovvideovdp_tpu_torch.ops.cuda.band_score import (ScoreMeta, _kernel_scalars,
                                                        band_d_beta_plain, band_score_plain,
                                                        frame_groups)
from fovvideovdp_tpu_torch.ops.pyramid import _expand_contrast_plain, ceildiv

# the kernel's tile of one frame (csrc/expand.cuh: kPatchTileH, kPatchTileW);
# a thread owns 2 x 4 pixels of it
TILE_H, TILE_W = 16, 128


def row_range(rows: Optional[Tuple[int, int]], H: int) -> Tuple[int, int]:
    """``rows`` as (r0, r1) with 0 <= r0 <= r1 <= H; None is the whole level."""
    r0, r1 = (0, H) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 <= r1 <= H:
        raise ValueError(f"expand_score2: rows {rows} outside the level's {H} rows")
    return r0, r1


def tile_sums(d: torch.Tensor, r0: int) -> torch.Tensor:
    """(F, h, w) per-pixel values of rows r0 .. r0+h of a level -> (F, n_tiles)
    sums over the kernel's tiles that hold them, in the kernel's order (tile
    rows on the level's 16-row grid, then columns)."""
    n, h, w = d.shape
    top = r0 % TILE_H
    ty, tx = ceildiv(top + h, TILE_H), ceildiv(w, TILE_W)
    d = nnf.pad(d, (0, tx * TILE_W - w, top, ty * TILE_H - h - top))
    return d.reshape(n, ty, TILE_H, tx, TILE_W).sum(dim=(2, 4)).reshape(n, ty * tx)


def expand_score2_plain(g_fine, g_coarse, tables, meta: ScoreMeta,
                        bkg_channel: int = 1, rows=None, partials: bool = False
                        ) -> torch.Tensor:
    n, _, H, W = g_fine.shape
    r0, r1 = row_range(rows, H)
    if r0 == r1:
        return g_fine.new_zeros((n, 0, 2) if partials else (n, 2))
    contrast, L_bkg = _expand_contrast_plain(g_fine, g_coarse, (H, W), bkg_channel)
    if (r0, r1) != (0, H):
        contrast, L_bkg = contrast[:, :, r0:r1], L_bkg[:, :, r0:r1]
    L = L_bkg[:, 0]
    if partials:
        return torch.stack([
            tile_sums(band_d_beta_plain(contrast[:, 0], contrast[:, 1], L, tables[0], meta,
                                        meta.q_s), r0),
            tile_sums(band_d_beta_plain(contrast[:, 2], contrast[:, 3], L, tables[1], meta,
                                        meta.q_t), r0),
        ], dim=-1)
    return torch.stack([
        band_score_plain(contrast[:, 0], contrast[:, 1], L, tables[0], meta, meta.q_s),
        band_score_plain(contrast[:, 2], contrast[:, 3], L, tables[1], meta, meta.q_t),
    ], dim=-1)


class LaunchPlan(NamedTuple):
    """How the kernel is launched on one level: the arm (16-byte loads of the
    fine level, or 4-byte loads each masked), the tiles of a frame (across,
    down; their product is the middle dimension of the partial sums) and the
    split of the frames over grid.y."""
    vec: bool
    tiles: Tuple[int, int]
    frames_per_group: int
    groups: int

    @property
    def n_tiles(self) -> int:
        return self.tiles[0] * self.tiles[1]


def launch_plan(shape, data_ptr: int, rows: Optional[Tuple[int, int]] = None) -> LaunchPlan:
    """The plan for a contiguous fine level of ``shape`` (F, 4, H, W) at
    address ``data_ptr``, scoring its rows ``rows`` = (r0, r1) (None: all;
    not empty).  The tiles lie on the level's grid of 16-row tile rows: those
    from r0 // 16 up to ceil(r1 / 16).  The vector arm needs every row of
    every plane on a 16-byte boundary: W a multiple of 4 and the strip's
    first element aligned.  A block walks the frames of its tile: one group
    of frames unless the strip's tiles cannot fill the card."""
    F, _, H, W = shape
    r0, r1 = row_range(rows, H)
    tiles = (ceildiv(W, TILE_W), ceildiv(r1, TILE_H) - r0 // TILE_H)
    return LaunchPlan(W % 4 == 0 and (data_ptr + 4 * r0 * W) % 16 == 0, tiles,
                      *frame_groups(tiles[0] * tiles[1], F))


def plan_for(g_fine: torch.Tensor, g_coarse: torch.Tensor, tables: torch.Tensor,
             rows: Optional[Tuple[int, int]] = None) -> LaunchPlan:
    """The launch plan for these tensors and rows; raises on what the kernel
    cannot take.  Reads shapes, strides and addresses only, on any device."""
    if not (g_fine.is_contiguous() and g_coarse.is_contiguous() and tables.is_contiguous()):
        raise ValueError("expand_score2 needs contiguous tensors")
    return launch_plan(g_fine.shape, g_fine.data_ptr(), rows)


# bytes the plain version's autograd graph keeps per frame, as a multiple of
# one frame of its inputs (_autograd.KernelOp): 40 measured at 256 x 512
# with saved-tensor hooks (the expanded level, the contrast and some twenty
# planes per channel), and room for the backward's own
GRAPH_BYTES = 48.0


@_autograd.differentiable(expand_score2_plain, diff=(0, 1), framed=(0, 1),
                          graph_bytes=GRAPH_BYTES)
def expand_score2(g_fine: torch.Tensor, g_coarse: torch.Tensor,
                  tables: torch.Tensor, meta: ScoreMeta,
                  bkg_channel: int = 1, rows: Optional[Tuple[int, int]] = None,
                  partials: bool = False) -> torch.Tensor:
    """Fused expand + Weber contrast + CSF + masking + beta-pooling for one
    level, both temporal channels.

    g_fine (F, 4, H, W) / g_coarse (F, 4, ceil(H/2), ceil(W/2)): Gaussian
    levels of [T-sust, R-sust, T-trans, R-trans]; tables (2, n) float32
    log2-sensitivity tables (sustained, transient) on the LUT's shared Y
    grid; ``meta.corr`` includes the per-band gain.  ``rows`` = (r0, r1)
    scores those rows of the fine level only (None: all of them); the
    expansion still reads the coarse rows they need.  Returns (F, 2)
    per-frame sums of D^beta, or with ``partials`` the (F, n_tiles, 2) sums
    of each tile (:func:`launch_plan`), to be added by
    :func:`sum_tile_partials`.  An empty range returns zeros and launches
    nothing.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel."""
    if g_fine.dim() != 4 or g_fine.shape[1] != 4:
        raise ValueError(f"expand_score2: g_fine must be (F, 4, H, W), got {tuple(g_fine.shape)}")
    F, _, H, W = g_fine.shape
    if tuple(g_coarse.shape) != (F, 4, ceildiv(H, 2), ceildiv(W, 2)):
        raise ValueError(f"expand_score2: g_coarse {tuple(g_coarse.shape)} does "
                         f"not match g_fine {tuple(g_fine.shape)}")
    if tables.dim() != 2 or tables.shape[0] != 2:
        raise ValueError(f"expand_score2: tables must be (2, n), got {tuple(tables.shape)}")
    for name, t in (("g_fine", g_fine), ("g_coarse", g_coarse), ("tables", tables)):
        if t.dtype != torch.float32:
            raise TypeError(f"expand_score2: {name} must be float32, got {t.dtype}")
        if t.device != g_fine.device:
            raise ValueError(f"expand_score2: {name} is on {t.device}, g_fine on {g_fine.device}")
    r0, r1 = row_range(rows, H)
    if g_fine.device.type == "cpu":
        return expand_score2_plain(g_fine, g_coarse, tables, meta, bkg_channel, rows, partials)
    if g_fine.device.type != "cuda":
        raise RuntimeError(f"expand_score2: unsupported device {g_fine.device}")
    if r0 == r1:
        # a grid of no blocks is a launch error
        return g_fine.new_zeros((F, 0, 2) if partials else (F, 2))
    plan = plan_for(g_fine, g_coarse, tables, (r0, r1))
    tile_partials = torch.empty((F, plan.n_tiles, 2), dtype=torch.float32,
                                device=g_fine.device)
    out = None if partials else torch.empty((F, 2), dtype=torch.float32, device=g_fine.device)
    fn = _lib.kernel_fn("expand_score2")
    with torch.cuda.device(g_fine.device):
        rc = fn(g_fine.data_ptr(), g_coarse.data_ptr(), tables.data_ptr(),
                tile_partials.data_ptr(), None if out is None else out.data_ptr(), F, H, W,
                g_coarse.shape[2], g_coarse.shape[3], tables.shape[1], r0, r1,
                int(bkg_channel), int(plan.vec), *plan.tiles, plan.frames_per_group,
                plan.groups,
                *_kernel_scalars(meta, meta.q_s, meta.q_t), _lib.stream_ptr(g_fine))
    _lib.check(rc, "expand_score2")
    _lib.count_launch("expand_score2")
    return tile_partials if partials else out


def sum_tile_partials(partials: torch.Tensor) -> torch.Tensor:
    """(F, n, 2) tile partials of :func:`expand_score2` (``partials=True``),
    the strips of one level laid end to end in row order -> (F, 2) per-frame
    sums, added as expand_score2 adds one launch's: on a CUDA tensor by its
    second pass (``csrc/partials.cuh`` through ``fvvdp_sum_partials``: in
    double, in a fixed order; not counted as a launch of its own), on a CPU
    tensor in double by ``torch.sum``."""
    if partials.dim() != 3 or partials.shape[2] != 2 or partials.dtype != torch.float32:
        raise ValueError(f"sum_tile_partials: partials must be float32 (F, n, 2), got "
                         f"{partials.dtype} {tuple(partials.shape)}")
    F, n, _ = partials.shape
    if partials.device.type == "cpu" or n == 0:
        return partials.double().sum(dim=1).float()
    partials = partials.contiguous()
    out = torch.empty((F, 2), dtype=torch.float32, device=partials.device)
    fn = _lib.kernel_fn("sum_partials")
    with torch.cuda.device(partials.device):
        rc = fn(partials.data_ptr(), out.data_ptr(), F, n, _lib.stream_ptr(partials))
    _lib.check(rc, "sum_partials")
    return out
