"""Metric core: scoring of frame blocks.

Counterpart of ``fovvideovdp_tpu/core.py:47-257,287-668,673-721,848-901``.
Per block: temporal channels (CUDA kernel), Gaussian pyramid (reduce
kernel), then one of four routes per level, following the JAX package's
gating (``fovvideovdp_tpu/core.py:418-449``):

* fused (no foveation, no heatmap, both LUTs on one uniform Y grid, the
  default options): the fused expand + score kernel; contrast never
  reaches memory;
* banded: the expand_contrast kernel, then a band scorer: band_score2_fov
  with the per-pixel CSF tables of a fixed fixation point; mov_score, which
  finds each pixel's eccentricity from the frame's gaze and interpolates
  the band's LUT window itself (no tables); or band_score once per temporal
  channel when the channels' Y grids differ (per-channel LUTs);
* composed: the per-pixel composition in tensor operations.  Heatmaps take
  it, and so does every configuration the kernels cannot score, as in the
  JAX package: the ``local_adapt`` variants "simple", "global", "gpyr0" and
  "gpyr2", log contrast, the masking ablations, ``pu_dilate``,
  ``ignore_boundary_pixels``, ``band_callback``, a content mapping
  (foveated), a LUT whose Y grid is not uniform, foveation on per-channel
  LUTs, and a gaze per frame on LUTs whose rho or eccentricity axis is not
  uniform.  Under "gpyr" with Weber contrast its levels come from the
  expand_contrast kernel; the other adaptations and log contrast decompose
  the Gaussian pyramid (reduce kernel) into Laplacian bands in tensor
  operations (``_adapted_levels``).

The route is fixed when the core is built, never chosen on a failure.

Layout: (F, C, H, W) with C = [T-sust, R-sust, T-trans, R-trans]; an image
has C = 2.  Under log contrast the responses are of log10 luminance.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fovvideovdp_tpu_torch import csf as csf_mod
from fovvideovdp_tpu_torch import memory, utils
from fovvideovdp_tpu_torch.io import resize
from fovvideovdp_tpu_torch.ops import masking as mask_ops
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops
from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
from fovvideovdp_tpu_torch.ops.cuda import expand_contrast as ec
from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
from fovvideovdp_tpu_torch.ops.pyramid import PyramidPlan, gausspyr_expand
from fovvideovdp_tpu_torch.tracing import span
from fovvideovdp_tpu_torch.visualize import visualize_diff_map_frames


LOCAL_ADAPT = ("gpyr", "gpyr0", "gpyr2", "simple", "global")
MASKING_MODELS = ("min_mutual_masking_perc_norm2", "contrast_difference",
                  "contrast_difference_perc_norm")


# Device bytes a block of B frames at H x W keeps live, per pixel-frame, by
# the route the core takes (MetricCore.route, and bytes_per_px_frame).
# "fused": the (B, 4, H, W) float32 temporal responses (16 B), their
# Gaussian pyramid (~5.3 B), the luminance pair and the decode temporaries.
# "banded" adds one level's materialised contrast and L_bkg (20 B at level
# 0); "composed" (heatmaps) adds the temporaries of the per-pixel
# composition, every level's difference map, the reconstruction and the
# rendered frames; "unfused" (the composition without a heatmap: the
# options, a non-uniform Y grid) adds one level's band, L_bkg and the
# composition's temporaries, and under "simple" the blurred plane beside
# them.  "moving" (a gaze per frame through mov_score) holds what "banded"
# holds, without resident tables; a gaze per frame on the composed route
# adds one level's eccentricity maps and frame-sized temporaries to
# "composed", which its figure covers (measured 116.4 B).
# chip_smoke.py measures the peaks on the card at 4K (PERF.md, where the
# time goes): 38.1, 64.8 and 118.9 B, for "moving" 59.8 B above what was on
# the card before the call, and for "unfused" 115.0-118.9 B (phase 8d's 4K
# configurations) with at most 122.6 B per pixel-frame of a block
# ("simple", the peak's slope between blocks of 8 and 4 frames at 960x540);
# the figures here are those rounded up.  A gaze per frame on the composed
# route adds the trilinear CSF's passes, which csf._TRILINEAR_CHUNK caps at
# ~0.7 GB whatever the block.
_BLOCK_BYTES_PER_PX_FRAME = {"fused": 40, "banded": 68, "composed": 128, "moving": 68,
                             "unfused": 128}
# Bytes per pixel-frame a chunk of images holds on top of its route's: the
# (n, 2, H, W) stack of the pair stays live beside the copy that adds the
# zero transient planes (core.score_frames; foveated, each level's contrast
# beside its zero-padded copy).
_IMAGE_STACK_BYTES = 8


def card(device) -> torch.device:
    """``device`` with its index: the unindexed "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class StripLevel(NamedTuple):
    """One scored level of a strip of a lone image
    (:meth:`MetricCore.score_image_strip`): its rows and its share of the
    level's score.  ``partials``: expand_score2's (1, n_tiles, 2) tile
    partials (the default route); ``sums``: the (1, 1) sum of the sustained
    channel's |D|^beta over the rows (the other routes); ``heat``: the rows
    of the level's difference map (1, 1, r1 - r0, w); ``bands``: per channel,
    the rows of (T, R, N_nCSF) on the CPU, for ``band_callback``."""
    rows: Tuple[int, int]
    partials: Optional[torch.Tensor] = None
    sums: Optional[torch.Tensor] = None
    heat: Optional[torch.Tensor] = None
    bands: Optional[list] = None


class MetricCore:
    """Static per-resolution state (pyramid plan, per-band CSF tables,
    foveation maps) and the block scorers.  ``heatmap`` and
    ``heatmap_dtype`` come checked from ``fvvdp``; the options
    (``content_mapping``, ``ignore_boundary_pixels``, ``band_callback``,
    and ``local_adapt``, ``contrast``, ``masking_model``, ``pu_dilate`` of
    ``params``) as the JAX package's core takes them."""

    def __init__(self, plan: PyramidPlan, params: Dict, luts: Sequence[Dict],
                 device, peak_luminance=None, geometry=None, foveated: bool = False,
                 heatmap: Optional[str] = None, heatmap_dtype: str = "float16",
                 content_mapping=None, ignore_boundary_pixels: bool = False,
                 band_callback: Optional[Callable] = None):
        self.plan = plan
        self.params = params
        self.luts = tuple(luts)
        self.device = torch.device(device)
        self._replicas: Dict = {}          # card -> this core built there (replica)
        self.peak_luminance = peak_luminance
        self.geometry = geometry
        self.foveated = bool(foveated)
        self.heatmap = heatmap
        self.do_heatmap = heatmap is not None and heatmap != "none"
        self.heatmap_dtype = heatmap_dtype
        # a mapping matters only when foveated: it replaces the display's
        # eccentricity, and a fixation point becomes a gaze per frame
        self.content_mapping = content_mapping if self.foveated else None
        self.ignore_boundary_pixels = bool(ignore_boundary_pixels)
        self.band_callback = band_callback
        self.local_adapt = params.get("local_adapt", "gpyr")
        self.log_contrast = params.get("contrast", "weber") == "log"
        self.masking_model = params.get("masking_model", "min_mutual_masking_perc_norm2")
        self.pu_dilate = float(params.get("pu_dilate", 0.0))
        if self.local_adapt not in LOCAL_ADAPT:
            raise RuntimeError(f"Unknown type of local adaptation: {self.local_adapt}")
        if self.masking_model not in MASKING_MODELS:
            raise RuntimeError(f"Unknown masking model: {self.masking_model}")
        if len(self.luts) < 2:
            raise ValueError("the metric needs one LUT per temporal channel (2)")
        self._luts_share_Y = all(
            np.array_equal(csf_mod._np(self.luts[0][k]), csf_mod._np(self.luts[1][k]))
            for k in ("Y_log", "Y"))

        # Which scorer score_frames takes (see the module's docstring).  The
        # kernels score "gpyr" with Weber contrast and the calibrated masking
        # on a Y grid uniform in log2 (their LUT coordinate is index
        # arithmetic): JAX's fused_base (fovvideovdp_tpu/core.py:418-442).
        kernels_score = (self.local_adapt == "gpyr" and not self.log_contrast
                         and self.masking_model == MASKING_MODELS[0]
                         and self.pu_dilate == 0.0
                         and all(csf_mod._axis_uniform(l, "Y_log") for l in self.luts)
                         and not self.ignore_boundary_pixels
                         and self.band_callback is None
                         and self.content_mapping is None)
        if self.do_heatmap or not kernels_score or (self.foveated and not self._luts_share_Y):
            self.route = "composed"
        elif self.foveated or not self._luts_share_Y:
            self.route = "banded"
        else:
            self.route = "fused"
        # ... and the one it takes for a per-frame gaze: mov_score indexes
        # the rho and eccentricity axes by arithmetic, so both must be
        # uniform; other LUTs take the composition's cell search
        self.moving_route = "banded" if self.route == "banded" and all(
            csf_mod._axis_uniform(l, ax) for l in self.luts
            for ax in ("rho_log", "ecc_sqrt")) else "composed"

        rho_band = plan.get_freqs()

        # Not foveated: per (band, channel) the LUT collapses to a 1-D table
        # in luminance.  Foveated: static per-band maps of spatial frequency
        # (rho x resolution magnification) and view direction; eccentricity
        # depends on the gaze and is computed per fixation point.
        self._band_tables: List = []
        self._band_rho: List = []
        self._band_view_dir: List = []
        for bb in range(plan.height):
            h, w = plan.level_shapes[bb]
            if not self.foveated:
                self._band_tables.append(tuple(
                    csf_mod.reduce_lut_to_1d(self.luts[cc], float(rho_band[bb]), 0.0)
                    for cc in range(2)))
                continue
            xv = torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=self.device)
            yv = torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=self.device)
            yy, xx = torch.meshgrid(yv, xv, indexing="ij")
            view_dir = geometry.pix2view_direction((w, h), xx, yy)
            res_mag = geometry.get_resolution_magnification(view_dir)
            self._band_rho.append((float(rho_band[bb]) * res_mag).to(torch.float32))
            self._band_view_dir.append(view_dir.to(torch.float32))

        # Default route: both channels' tables on the shared grid, trimmed to
        # the knots reachable for L_bkg in [0.1, peak].
        self._score_tables: List = []
        self._score_lut = None
        self._meta: List = []
        # Per-channel LUTs: each channel's own table and Y grid.
        self._channel_tables: List = []
        self._channel_meta: List = []
        if self.route == "fused":
            lut2 = self.luts[0]
            for bb in range(plan.height):
                t2, lut2 = csf_mod.trim_lut_range(np.stack(self._band_tables[bb]),
                                                  self.luts[0], lbkg_max=peak_luminance)
                self._score_tables.append(self._to_device(t2))
            self._score_lut = lut2
            self._meta = [self._score_meta(lut2, bb) for bb in range(plan.height)]
        elif self.route == "banded" and not self.foveated:
            for bb in range(plan.height):
                self._channel_tables.append(tuple(
                    self._to_device(t) for t in self._band_tables[bb]))
                self._channel_meta.append(tuple(
                    self._score_meta(self.luts[cc], bb) for cc in range(2)))

        # Fixed gaze: the per-pixel tables get the same Y-knot trim (32 -> 19
        # planes on a 200 cd/m^2 display), which cuts both the kernel's table
        # reads and the memory the cached sets hold.  Only where L_bkg stays
        # in [0.1, peak]: under "gpyr" with Weber contrast, as in the JAX
        # package; the other adaptations and log contrast keep the full grid.
        self._fov_trim = None
        self._fov_lut = None
        self._fov_meta: List = []
        self._fov_table_cache: Dict = {}   # insertion-ordered: least recent first
        self._mov_cache: Dict = {}         # band -> static data of mov_score
        if self.foveated and self._luts_share_Y and self.local_adapt == "gpyr" \
                and not self.log_contrast:
            lo, hi, lut2 = csf_mod.trim_lut_bounds(self.luts[0], lbkg_max=peak_luminance)
            if lut2 is not self.luts[0]:
                self._fov_trim = (lo, hi)
                self._fov_lut = lut2
        if self.foveated and self.route == "banded":
            self._fov_meta = [self._score_meta(self._fov_lut or self.luts[0], bb)
                              for bb in range(plan.height)]

    def bytes_per_px_frame(self, moving: bool, images: bool = False) -> int:
        """Device bytes per pixel-frame a block (``images``: a chunk of
        independent images or frames) keeps live when scored with a gaze
        per frame (``moving``) or without (see ``_BLOCK_BYTES_PER_PX_FRAME``)."""
        route = self.moving_route if moving else self.route
        if moving and route == "banded":
            route = "moving"
        elif route == "composed" and not self.do_heatmap:
            route = "unfused"
        return _BLOCK_BYTES_PER_PX_FRAME[route] + (_IMAGE_STACK_BYTES if images else 0)

    def _score_meta(self, lut, bb: int) -> bs.ScoreMeta:
        """Scalars of band ``bb``'s score on the Y grid of ``lut``.  The
        per-band gain folds into the sensitivity correction: everything
        between the contrast and |T - R|, min(|T|, |R|) is linear in it."""
        p = self.params
        sens_corr = 10.0 ** (p["sensitivity_correction"] / 20.0)
        return bs.score_meta(lut, p["mask_p"], p["mask_q_sust"], p["mask_q_trans"],
                             p["mask_c"],
                             sens_corr * self.plan.band_gain(bb, self.plan.get_band_count()),
                             p["beta"])

    def _to_device(self, table) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(table, dtype=np.float32),
                               device=self.device)

    # ------------------------------------------------------------------
    # fixed-gaze per-pixel CSF tables
    # ------------------------------------------------------------------
    def fov_table_bytes(self) -> int:
        """Device bytes of one fixed-gaze table set (``fov_tables``): kept
        knots x h x w float32 planes per band per temporal channel."""
        if not self.foveated or self.content_mapping is not None:
            return 0
        if self._fov_trim is not None:
            n = self._fov_trim[1] - self._fov_trim[0] + 1
        else:
            n = int(self.luts[0]["Y_log"].shape[0])
        return n * 2 * sum(int(r.numel()) for r in self._band_rho) * 4

    def fov_tables(self, gaze_xy):
        """Per band, per channel (n, h, w) S_log(Y_log) tables for a fixed
        fixation point (x, y) in pixels: the LUT's (rho, ecc) axes are
        collapsed once here, so the per-frame foveated CSF costs the same
        as the non-foveated 1-D one.  Cached for the most recent fixation
        points only (see ``memory.FOV_CACHE_SHARE``)."""
        key = (float(gaze_xy[0]), float(gaze_xy[1]))
        cache = self._fov_table_cache
        if key in cache:                          # refresh its place
            cache[key] = cache.pop(key)
            return cache[key]
        while len(cache) >= memory.fov_cache_entries(self.device, self.fov_table_bytes()):
            cache.pop(next(iter(cache)))
        gaze = torch.tensor([[key[0] + 0.5], [key[1] + 0.5]], dtype=torch.float32,
                            device=self.device)
        gaze_dir = self.geometry.pix2view_direction(
            (self.plan.W, self.plan.H), gaze[0], gaze[1]).reshape(2, 1, 1)
        tabs = []
        for bb in range(self.plan.height):
            vd = self._band_view_dir[bb]          # (2, h, w)
            ecc = torch.sqrt(torch.sum((vd - gaze_dir) ** 2, dim=0))
            per_cc = []
            for cc in range(2):
                t = csf_mod.reduce_lut_to_pixel_tables(self.luts[cc], self._band_rho[bb], ecc)
                if self._fov_trim is not None:
                    lo, hi = self._fov_trim
                    # a copy: the slice is contiguous, and as a view it
                    # would keep every knot's planes alive
                    t = t[lo:hi + 1].clone()
                per_cc.append(t)
            tabs.append(tuple(per_cc))
        cache[key] = tabs
        return tabs

    def drop_fov_tables(self) -> None:
        """Free every cached fixed-gaze table set, this core's and its
        replicas'."""
        self._fov_table_cache.clear()
        for core in self._replicas.values():
            core.drop_fov_tables()

    def replica(self, device) -> "MetricCore":
        """This core on ``device``: itself when ``device`` is its card, else
        a core built there from the same arguments with the LUTs copied to
        that card, made once and kept.  The slots of a mesh score with the
        replica of their card; slots on one card share it, and with it the
        card's fixed-gaze tables."""
        dev = card(device)
        if dev == card(self.device):
            return self
        if dev not in self._replicas:
            luts = tuple({k: v.to(dev) if torch.is_tensor(v) else v for k, v in lut.items()}
                         for lut in self.luts)
            self._replicas[dev] = MetricCore(
                self.plan, self.params, luts, dev, peak_luminance=self.peak_luminance,
                geometry=self.geometry, foveated=self.foveated, heatmap=self.heatmap,
                heatmap_dtype=self.heatmap_dtype, content_mapping=self.content_mapping,
                ignore_boundary_pixels=self.ignore_boundary_pixels,
                band_callback=self.band_callback)
        return self._replicas[dev]

    # ------------------------------------------------------------------
    # moving gaze
    # ------------------------------------------------------------------
    def _gaze_directions(self, gaze: torch.Tensor) -> torch.Tensor:
        """gaze (F, 2) pixel coordinates -> view directions (F, 2) in
        degrees, on the core's device."""
        gaze = torch.as_tensor(gaze, dtype=torch.float32, device=self.device)
        return self.geometry.pix2view_direction(
            (self.plan.W, self.plan.H), gaze[:, 0] + 0.5, gaze[:, 1] + 0.5).T.contiguous()

    def prepare_moving(self) -> None:
        """Build the static band data that a gaze per frame reads, where the
        moving-gaze route is the kernel's (slots that share this core read
        it from their own threads)."""
        if self.foveated and self.moving_route == "banded":
            for bb in range(self.plan.height):
                self._moving_band_data(bb)

    def _moving_band_data(self, bb: int, windowed: bool = True) -> Dict:
        """Static data of band ``bb`` for mov_score, as tensors on the
        core's device: the LUTs cut to the rho knots the band's pixels reach
        (``r_lo``..``r_hi``) and to the display's Y knots, laid out
        (n_e, ny * nr) (``V2``, ``V2_5``); the pixels' rho coordinate in that
        window (``t_r``); the kernel's scalars (``meta``).  Where the
        omega = 5 LUT is the omega = 0 one plus a constant over the window,
        ``V2_5`` is None and ``meta.off5`` holds the constant.
        ``windowed=False`` keeps every knot of both axes, which is the size a
        LUT without a usable window has."""
        key = (bb, windowed)
        if key in self._mov_cache:
            return self._mov_cache[key]
        lut = self.luts[0]
        S0_all, S5_all = lut["S_log"], self.luts[1]["S_log"]     # [Y, rho, ecc]
        n_y, n_rho, _ = S0_all.shape
        # rho coordinate on the whole grid; its range is the band's window
        q = torch.log2(torch.clamp(self._band_rho[bb], lut["rho"][0], lut["rho"][-1]))
        u = csf_mod.grid_index_coord(q, lut["rho_log"], True)
        if windowed:
            r_lo = int(torch.floor(u).min().item())
            r_hi = min(int(torch.floor(u).max().item()) + 1, n_rho - 1)
            y_lo, y_hi = self._fov_trim if self._fov_trim is not None else (0, n_y - 1)
            y_lut = self._fov_lut or lut
        else:
            r_lo, r_hi, y_lo, y_hi, y_lut = 0, n_rho - 1, 0, n_y - 1, lut
        S0 = S0_all[y_lo:y_hi + 1, r_lo:r_hi + 1]
        S5 = S5_all[y_lo:y_hi + 1, r_lo:r_hi + 1]
        ny, nr, ne = S0.shape
        diff = S5 - S0
        # the mean, not one element: at the tolerance's edge it centres the
        # residual (1e-5 log2 units at worst)
        off5 = float(diff.mean().item()) \
            if float((diff.max() - diff.min()).item()) <= 2e-5 else None

        def lay_out(S):
            return S.reshape(ny * nr, ne).T.contiguous()

        data = {
            "V2": lay_out(S0),
            "V2_5": None if off5 is not None else lay_out(S5),
            "t_r": torch.clamp(u - float(r_lo), 0.0, float(nr - 1)).contiguous(),
            "r_lo": r_lo, "r_hi": r_hi,
            "meta": ms.mov_meta(self._score_meta(y_lut, bb), lut, ny, nr, off5),
        }
        self._mov_cache[key] = data
        return data

    # ------------------------------------------------------------------
    # scoring of a block of temporal-response frames
    # ------------------------------------------------------------------
    def score_frames(self, R: torch.Tensor, temp_ch: int, fov_tables=None, gaze=None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Score a block of temporal responses R (F, 2*temp_ch, H, W).  A
        foveated core takes either ``fov_tables``, the fixation point's
        tables from :meth:`fov_tables`, or ``gaze``, (F, 2) pixel
        coordinates of the gaze in each frame (always the latter with a
        content mapping).  Returns (Q_per_ch (n_bands, 2, F), heatmap
        (F, c, H, W) or None)."""
        if self.foveated and (fov_tables is None) == (gaze is None):
            raise ValueError("a foveated core scores with either the fixation "
                             "point's fov_tables or a per-frame gaze")
        R = R.contiguous()
        gaze_dir = None
        if self.foveated and gaze is not None:
            if tuple(gaze.shape) != (R.shape[0], 2):
                raise ValueError(f"gaze must be ({R.shape[0]}, 2), one row per frame "
                                 f"of the block, got {tuple(gaze.shape)}")
            gaze = torch.as_tensor(gaze, dtype=torch.float32, device=self.device)
            gaze_dir = gaze if self.content_mapping is not None else \
                self._gaze_directions(gaze)
        route = self.route if gaze_dir is None else self.moving_route
        if route == "composed":
            return self._score_frames_composed(R, temp_ch, fov_tables, gaze_dir)
        if route == "banded":
            return self._score_frames_banded(R, temp_ch, fov_tables, gaze_dir), None
        if temp_ch == 1:
            # image path: zero transient channels score exactly 0 through
            # the pipeline (D(0,0) = 0)
            R = torch.cat([R, torch.zeros_like(R)], dim=1)
        return self._score_frames_fused(R, temp_ch), None

    def _q_from_sums(self, ssum: torch.Tensor, bb: int) -> torch.Tensor:
        """(F, k) sums of D^beta over the band's pixels -> (k, F) norms."""
        beta = self.params["beta"]
        h, w = self.plan.level_shapes[bb]
        return torch.pow(ssum, 1.0 / beta).T / (float(h * w) ** (1.0 / beta))

    def _q_pair(self, ssum2: torch.Tensor, bb: int, temp_ch: int) -> torch.Tensor:
        """(F, 2) sums of both channels -> (2, F) norms.  An image's transient
        row is the constant 0 its zero contrast sums to, never the root of
        that sum: the infinite slope of x^(1/beta) at 0 would turn the
        gradient through L_bkg into NaN (the JAX package's unfused path
        appends constant zeros the same way)."""
        if temp_ch == 2:
            return self._q_from_sums(ssum2, bb)
        Q = self._q_from_sums(ssum2[:, :1], bb)
        return torch.cat([Q, torch.zeros_like(Q)], dim=0)

    def _fused_levels(self, R: torch.Tensor,
                      strips: Optional[Sequence[Tuple[int, int]]] = None):
        """expand_score2 over each level of R's Gaussian pyramid, finest
        first: (bb, its (F, 2) sums), or with ``strips`` (as in
        :meth:`_composed_levels`) the (F, n_tiles, 2) tile partials of the
        rows strips[bb], at the levels where it has rows."""
        plan = self.plan
        gpyr = plan.gaussian_pyramid(R)
        for bb in range(plan.height):
            rows = None if strips is None else tuple(strips[bb])
            if rows is None or rows[1] > rows[0]:
                yield bb, bp.expand_score2(gpyr[bb], gpyr[bb + 1], self._score_tables[bb],
                                           self._meta[bb], rows=rows,
                                           partials=rows is not None)

    def _score_frames_fused(self, R: torch.Tensor, temp_ch: int) -> torch.Tensor:
        return torch.stack([self._q_pair(ssum2, bb, temp_ch)
                            for bb, ssum2 in self._fused_levels(R)], dim=0)  # (n_bands, 2, F)

    def _score_frames_banded(self, R: torch.Tensor, temp_ch: int, fov_tables,
                             gaze_dir=None) -> torch.Tensor:
        """Materialised contrast, one level at a time, scored by the band
        kernels: per-pixel tables (fixed gaze), the LUT window with the
        frame's gaze (moving gaze) or one launch per channel (per-channel
        LUTs)."""
        Q_rows = []
        for bb, (band, L_bkg) in enumerate(self.plan.contrast_levels(R)):
            L = L_bkg[:, 0]
            if self.foveated:
                if temp_ch == 1:
                    # image path: zero transient contrast scores exactly 0
                    band = torch.cat([band, torch.zeros_like(band)], dim=1)
                if gaze_dir is not None:
                    d = self._moving_band_data(bb)
                    ssum = ms.band_score2_mov(band, L, self._band_view_dir[bb], d["t_r"],
                                              gaze_dir, d["V2"], d["V2_5"], d["meta"])
                else:
                    ssum = bs.band_score2_fov(band, L, fov_tables[bb][0], fov_tables[bb][1],
                                              self._fov_meta[bb])     # (F, 2)
                Q_rows.append(self._q_pair(ssum, bb, temp_ch))
                continue
            Q_rows.append(self._q_channels(self._channel_sums(band, L, bb, temp_ch), bb))
        return torch.stack(Q_rows, dim=0)

    def _channel_sums(self, band: torch.Tensor, L: torch.Tensor, bb: int,
                      temp_ch: int) -> torch.Tensor:
        """(F, temp_ch) sums of |D|^beta of level bb's contrast ``band`` (F,
        C, h, w) against L (F, h, w), one band_score launch per channel with
        its own LUT (per-channel LUTs)."""
        sums = []
        for cc in range(temp_ch):
            meta = self._channel_meta[bb][cc]
            sums.append(bs.band_score(band[:, 2 * cc], band[:, 2 * cc + 1], L,
                                      self._channel_tables[bb][cc], meta,
                                      (meta.q_s, meta.q_t)[cc]))   # (F,)
        return torch.stack(sums, dim=-1)

    def _sensitivity(self, bb: int, cc: int, L: torch.Tensor, fov_tables,
                     ecc=None) -> torch.Tensor:
        if ecc is not None:
            # moving gaze: rho does not depend on the frame, ecc (F, h, w) does
            return csf_mod.sensitivity_trilinear_block(self.luts[cc], self._band_rho[bb],
                                                       L, ecc)
        if self.foveated:
            lut = self._fov_lut if self._fov_trim is not None else self.luts[cc]
            return csf_mod.sensitivity_pixel_tables(lut, fov_tables[bb][cc], L)
        return csf_mod.sensitivity_1d(self.luts[cc], self._band_tables[bb][cc], L)

    def _adapted_levels(self, R: torch.Tensor, levels: Optional[Sequence[int]] = None):
        """Per scored level of ``levels`` (default: all), finest first:
        (bb, band (F, C, h, w), L_bkg (F, h, w), is_contrast), after
        ``fovvideovdp_tpu/core.py:315-380`` (the MATLAB core's adaptation
        modes, matlab/fvvdp_core.m:214-300).  Under "gpyr" with Weber
        contrast the bands are Weber contrast and L_bkg is clamped to >= 0.1
        (the expand_contrast kernel, launched for the levels asked for only);
        otherwise each band is the Laplacian level of the Gaussian pyramid
        (reduce kernel) and L_bkg the adapting luminance of the reference's
        sustained channel, in cd/m^2 also under log contrast."""
        plan = self.plan
        la = self.local_adapt
        levels = range(plan.height) if levels is None else levels
        if la == "gpyr" and not self.log_contrast:
            gpyr = plan.gaussian_pyramid(R)
            for bb in levels:
                band, L_bkg = ec.expand_contrast(gpyr[bb], gpyr[bb + 1], 1)
                yield bb, band, L_bkg[:, 0], True
            return

        def linear(g):            # the reference-sustained plane in cd/m^2
            return torch.pow(10.0, g) if self.log_contrast else g

        gpyr = plan.gaussian_pyramid(R)
        if la == "simple":
            # 0.5 deg Gaussian blur of the reference sustained channel
            L_adapt = utils.ImGaussFilt(0.5 * plan.ppd).run(linear(R[:, 1])[:, None])[:, 0]
        elif la == "global":
            # geometric mean of the reference sustained channel, per frame
            L_adapt = torch.exp(torch.mean(torch.log(utils.clip(linear(R[:, 1]), 1e-8)),
                                           dim=(-2, -1)))
        for bb in levels:
            size = plan.level_shapes[bb]
            band = gpyr[bb] - gausspyr_expand(gpyr[bb + 1], size)
            if la == "gpyr":      # log contrast
                L_bkg = gausspyr_expand(linear(gpyr[bb + 1][:, 1]), size)
            elif la == "gpyr0":
                L_bkg = linear(gpyr[bb][:, 1])
            elif la == "gpyr2":
                use_band = min(bb + 2, plan.height)
                L_bkg = linear(gpyr[use_band][:, 1])
                for br in range(use_band - 1, bb - 1, -1):
                    L_bkg = gausspyr_expand(L_bkg, plan.level_shapes[br])
            elif la == "simple":
                L_bkg = utils.clip(resize(L_adapt, size, "cubic"), 1e-4)
            else:                 # global
                L_bkg = L_adapt[:, None, None].expand((L_adapt.shape[0],) + size)
            yield bb, band, L_bkg, False

    def _apply_masking(self, T, Rf, N_nCSF, cc: int) -> torch.Tensor:
        p = self.params
        if self.masking_model == "contrast_difference":
            D = torch.abs(T - Rf) / 0.05
        elif self.masking_model == "contrast_difference_perc_norm":
            D = torch.abs(T - Rf) / N_nCSF
        else:
            q = (p["mask_q_sust"], p["mask_q_trans"])[cc]
            return mask_ops.apply_masking_model(T, Rf, N_nCSF, p["mask_p"], q, p["mask_c"],
                                                pu_dilate=self.pu_dilate)
        return utils.clip(D, None, 1e4)

    def _eccentricity(self, bb: int, gaze_dir: torch.Tensor) -> torch.Tensor:
        """(F, h, w) eccentricity of band ``bb``'s pixels: from the display's
        view directions and the gaze's (F, 2), or, with a content mapping,
        from the mapping and the gaze in pixels (F, 2)."""
        if self.content_mapping is None:
            vd = self._band_view_dir[bb]
            return torch.sqrt((vd[0] - gaze_dir[:, 0, None, None]) ** 2
                              + (vd[1] - gaze_dir[:, 1, None, None]) ** 2)
        h, w = self.plan.level_shapes[bb]
        xv = torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=self.device)
        yv = torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=self.device)
        yy, xx = torch.meshgrid(yv, xv, indexing="ij")
        return self.content_mapping.eccentricity(
            (w, h), xx, yy, gaze_dir[:, 0, None, None] + 0.5, gaze_dir[:, 1, None, None] + 0.5)

    def _composed_levels(self, R: torch.Tensor, temp_ch: int, fov_tables, gaze_dir=None,
                         strips: Optional[Sequence[Tuple[int, int]]] = None,
                         callback: Optional[Callable] = None):
        """The per-pixel composition (``fovvideovdp_tpu/core.py:451-668``),
        one scored level at a time, finest first: (bb, (F, temp_ch) sums of
        |D|^beta over the level's pixels, the difference map D of the
        level weighted over the channels and divided by the band's gain
        (F, h, w), or None without a heatmap).  ``gaze_dir``: the (F, 2)
        gaze as view directions, or in pixels with a content mapping.
        ``strips[bb]`` = (r0, r1) scores only those rows of level bb (a slot
        of a lone image split over 'space'; an empty range skips the level):
        the level is adapted whole, then cut, so the boundary mask and the
        "simple" and "global" adaptations see the whole image; the cut keeps
        the rows that the ``pu_dilate`` blur of the masking signal reaches on
        either side, and D is trimmed to the strip after the masking.
        ``callback(bb, cc, T, R, N_nCSF)`` receives each band's arrays."""
        p = self.params
        plan = self.plan
        sens_corr = 10.0 ** (p["sensitivity_correction"] / 20.0)
        w_temp_ch = (1.0, p["w_transient"])
        n_bands = plan.get_band_count()
        levels = None if strips is None else [bb for bb, (r0, r1) in enumerate(strips)
                                              if r1 > r0]
        halo = utils.ImGaussFilt(self.pu_dilate).half if self.pu_dilate != 0.0 else 0
        for bb, band, L_bkg, is_contrast in self._adapted_levels(R, levels):
            h, w = band.shape[-2:]
            rows = keep = slice(None)
            if strips is not None:
                r0, r1 = strips[bb]
                c0, c1 = max(r0 - halo, 0), min(r1 + halo, h)
                band, L_bkg = band[..., c0:c1, :], L_bkg[..., c0:c1, :]
                rows, keep = slice(r0, r1), slice(r0 - c0, r1 - c0)
            gain = plan.band_gain(bb, n_bands)
            band = band * gain
            ecc = None if gaze_dir is None else self._eccentricity(bb, gaze_dir)
            if not is_contrast and not self.log_contrast:
                # the reference's compute_local_contrast clamps L_bkg >= 0.1
                # before the division; the CSF still sees the unclamped L_bkg
                L_div = utils.clip(L_bkg, 0.1)
            sums = []
            D_acc = None
            for cc in range(temp_ch):
                T_f, R_f = band[:, 2 * cc], band[:, 2 * cc + 1]
                if not is_contrast and not self.log_contrast:
                    T_f = utils.clip(T_f / L_div, None, 1000.0)
                    R_f = utils.clip(R_f / L_div, None, 1000.0)
                S = self._sensitivity(bb, cc, L_bkg, fov_tables, ecc) * sens_corr
                if self.log_contrast:
                    # the log-contrast threshold (pyfvvdp/fvvdp.py:450,539-548)
                    N_nCSF = torch.log10(1.0 + utils.clip(1.0 / S, None, 0.9999999))
                else:
                    N_nCSF = 1.0 / S
                if callback is not None:
                    callback(bb, cc, T_f[..., keep, :], R_f[..., keep, :],
                             N_nCSF[..., keep, :])
                D = self._apply_masking(T_f, R_f, N_nCSF, cc)[..., keep, :]
                if self.ignore_boundary_pixels:
                    # edge pixels see the padding (matlab/fvvdp_core.m:369-379)
                    cy, cx = min(3, h), min(3, w)
                    mask = torch.zeros((h, w), dtype=D.dtype, device=D.device)
                    mask[cy:h - cy, cx:w - cx] = 1.0
                    D = D * mask[rows]
                if self.content_mapping is not None and ecc is not None:
                    # nothing behind the viewer's head is visible
                    # (matlab/fvvdp_core.m:387-391)
                    D = torch.where(ecc > 105.0, torch.zeros_like(D), D)
                sums.append(torch.sum(torch.pow(torch.abs(D), p["beta"]), dim=(-2, -1)))
                if self.do_heatmap:
                    D_acc = D if cc == 0 else D_acc + w_temp_ch[cc] * D
            yield bb, torch.stack(sums, dim=-1), None if D_acc is None else D_acc / gain

    def _q_channels(self, ssum: torch.Tensor, bb: int) -> torch.Tensor:
        """(F, temp_ch) sums -> (2, F) norms, a missing transient channel 0."""
        Q = self._q_from_sums(ssum, bb)
        if Q.shape[0] < 2:
            Q = torch.cat([Q, torch.zeros_like(Q)], dim=0)
        return Q

    def _score_frames_composed(self, R: torch.Tensor, temp_ch: int, fov_tables,
                               gaze_dir=None
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The per-pixel composition in tensor operations, keeping the
        difference map D of every level for the heatmap
        (:meth:`_composed_levels`)."""
        plan = self.plan
        callback = None
        if self.band_callback is not None:
            def callback(bb, cc, T_f, R_f, N_nCSF):
                # a debugging hook: this band's arrays go to the host
                self.band_callback(bb, plan.height, cc, T_f.detach().cpu(),
                                   R_f.detach().cpu(), N_nCSF.detach().cpu())
        Q_rows = []
        heat_bands: List[torch.Tensor] = []
        for bb, ssum, D in self._composed_levels(R, temp_ch, fov_tables, gaze_dir,
                                                 callback=callback):
            Q_rows.append(self._q_channels(ssum, bb))
            if self.do_heatmap:
                heat_bands.append(D[:, None])                     # (F, 1, h, w)
        Q_per_ch = torch.stack(Q_rows, dim=0)
        if not self.do_heatmap:
            return Q_per_ch, None
        return Q_per_ch, self._heatmap(heat_bands, R[:, 0:1])

    def _heatmap(self, heat_bands: List[torch.Tensor], context: torch.Tensor) -> torch.Tensor:
        """The heatmap from each level's difference map (F, 1, h, w), finest
        first; ``context`` (F, 1, H, W) is the test-sustained channel."""
        plan = self.plan
        p = self.params
        F = context.shape[0]
        base = torch.zeros((F, 1) + plan.level_shapes[plan.height], dtype=context.dtype,
                           device=context.device)
        dmap = plan.reconstruct(heat_bands + [base])
        beta_jod = 10.0 ** p["log_jod_exp"]
        dmap = torch.pow(torch.clamp(dmap, min=0.0), beta_jod) * abs(p["jod_a"])
        if self.heatmap == "raw":
            heat = dmap
        else:
            heat = visualize_diff_map_frames(dmap, context, self.heatmap)
        if self.heatmap_dtype == "uint8":
            # display-referred RGB in [0, 1], quantised on the device
            # (torch.round rounds half to even, as jnp.round does)
            return torch.round(torch.clamp(heat, 0.0, 1.0) * 255.0).to(torch.uint8)
        return heat.to(torch.float16)

    def score_image(self, T: torch.Tensor, Rf: torch.Tensor, fov_tables=None, gaze=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(H, W) luminance pair -> (Q_per_ch (n_bands, 2, 1), heatmap).
        ``gaze``: (1, 2), in place of ``fov_tables``."""
        return self.score_frames(torch.stack([T, Rf], dim=0)[None], temp_ch=1,
                                 fov_tables=fov_tables, gaze=gaze)

    def score_image_strip(self, T: torch.Tensor, Rf: torch.Tensor,
                          strips: Sequence[Tuple[int, int]]) -> List[Optional[StripLevel]]:
        """A strip of the lone (H, W) luminance pair T, Rf split by rows
        (``parallel.sharding.image_strip``), ``strips[bb]`` = (r0, r1) its
        rows of scored level bb: per level, the strip's share of the score,
        or None where it has no rows, and nothing is launched for that
        level.  The Gaussian pyramid is built whole
        (reduce kernel), so each strip expands and adapts as the whole image
        does, and only the strip's rows are scored: by expand_score2 with
        their row range (default route), band_score on views of their rows
        (per-channel LUTs) or the composition cut to them.
        :meth:`combine_image_strips` puts the strips together.  (The JAX
        package leaves this split to XLA's partitioner: it has no row range.)"""
        if self.foveated:
            raise ValueError("a foveated lone image is not split over a mesh's 'space' axis")
        plan = self.plan
        out: List[Optional[StripLevel]] = [None] * plan.height
        R = torch.stack([T, Rf], dim=0)[None]
        if self.route == "fused":
            # zero transient channels score exactly 0 (D(0,0) = 0)
            for bb, part in self._fused_levels(torch.cat([R, torch.zeros_like(R)], dim=1),
                                               strips):
                out[bb] = StripLevel(tuple(strips[bb]), partials=part)
        elif self.route == "banded":
            # per-channel LUTs: the sustained channel's scorer on views of the rows
            gpyr = plan.gaussian_pyramid(R)
            for bb, (r0, r1) in enumerate(strips):
                if r1 > r0:
                    band, L_bkg = ec.expand_contrast(gpyr[bb], gpyr[bb + 1], 1)
                    out[bb] = StripLevel((r0, r1), sums=self._channel_sums(
                        band[..., r0:r1, :], L_bkg[:, 0, r0:r1], bb, 1))
        else:
            bands: Dict[int, list] = {}
            callback = None
            if self.band_callback is not None:
                def callback(bb, cc, T_f, R_f, N_nCSF):
                    # called with the whole bands in the caller's thread later
                    bands.setdefault(bb, []).append(
                        tuple(x.detach().cpu() for x in (T_f, R_f, N_nCSF)))
            for bb, ssum, D in self._composed_levels(R, 1, None, strips=strips,
                                                     callback=callback):
                out[bb] = StripLevel(strips[bb], sums=ssum,
                                     heat=None if D is None else D[:, None],
                                     bands=bands.get(bb))
        return out

    def combine_image_strips(self, parts: Sequence[Optional[List[Optional[StripLevel]]]],
                             T: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(Q_per_ch (n_bands, 2, 1), heatmap or None) of a lone image from
        the :meth:`score_image_strip` of its strips, in row order (None: a
        strip with no rows), on this core's device.  Per level the default
        route's tile partials are laid end to end and added by
        expand_score2's second pass, which gives the sums of one launch over
        the whole level bit for bit; the other routes' sums are added in
        double.  Then the beta root over the whole level's pixels
        (:meth:`_q_from_sums`); the transient row stays the constant 0.  The
        heatmap and ``band_callback`` (called here, in the caller's thread,
        in band and channel order) get each level's rows gathered in order.
        ``T``: the (H, W) test luminance, the heatmap's context."""
        dev = self.device
        Q_rows = []
        heat_bands: List[torch.Tensor] = []
        for bb in range(self.plan.height):
            got = [p[bb] for p in parts if p is not None and p[bb] is not None]
            if self.route == "fused":
                ssum = bp.sum_tile_partials(torch.cat([g.partials.to(dev) for g in got], dim=1))
                Q_rows.append(self._q_pair(ssum, bb, 1))
            else:
                ssum = torch.stack([g.sums.to(dev, torch.float64) for g in got]).sum(dim=0)
                Q_rows.append(self._q_channels(ssum.float(), bb))
            if self.band_callback is not None:
                for cc in range(len(got[0].bands)):
                    self.band_callback(bb, self.plan.height, cc, *(
                        torch.cat([g.bands[cc][i] for g in got], dim=-2) for i in range(3)))
            if self.do_heatmap:
                heat_bands.append(torch.cat([g.heat.to(dev) for g in got], dim=-2))
        Q_per_ch = torch.stack(Q_rows, dim=0)
        if not self.do_heatmap:
            return Q_per_ch, None
        return Q_per_ch, self._heatmap(heat_bands, T.to(dev)[None, None])

    def score_frame_pairs(self, frames: Callable, n: int, chunk: int, fov_tables=None,
                          gaze=None, keep: Optional[Callable] = None) -> torch.Tensor:
        """Q_per_ch (n_bands, 2, n) of n independent frame pairs, each scored
        as an image (zero transient channels), ``chunk`` pairs at a time:
        the frames of a clip without temporal channels, or the pairs of an
        image batch.  ``frames(start, count)`` gives the (count, H, W) test
        and reference luminance of pairs start..start+count-1 on the core's
        device; ``gaze``: (n, 2) rows, in place of ``fov_tables``;
        ``keep(heat)`` takes each chunk's heatmap (None without one)."""
        Q = torch.empty((self.plan.height, 2, n), dtype=torch.float32, device=self.device)
        for pos in range(0, n, chunk):
            with span("fvvdp.chunk"):
                b = min(chunk, n - pos)
                Q[:, :, pos:pos + b], heat = self.score_frames(
                    torch.stack(frames(pos, b), dim=1), 1, fov_tables,
                    None if gaze is None else gaze[pos:pos + b])
                if keep is not None:
                    keep(heat)
        return Q

    def score_video(self, block: Callable, indexed: Callable, n_frames: int,
                    taps: torch.Tensor, pad_idx: np.ndarray, B: int, fov_tables=None,
                    gaze=None, keep: Optional[Callable] = None, start: int = 0,
                    carry=None, Q: Optional[torch.Tensor] = None,
                    after_block: Optional[Callable] = None) -> torch.Tensor:
        """Q_per_ch (n_bands, 2, n_frames) of a clip streamed B frames at a
        time, each block filtered with the fl-1 frames before it
        (:meth:`video_step`).  ``block(start, count)`` and
        ``indexed(indices)`` give (count, H, W) test and reference luminance
        on the core's device; ``pad_idx``: the padded clip's frame indices
        (``ops.temporal.padding_indices``); ``gaze``: (n_frames, 2) rows, in
        place of ``fov_tables``; ``keep(heat)`` takes each block's heatmap.

        A resumed run starts at frame ``start`` with ``carry`` (the fl-1
        frames before it, as the loop carries them) and ``Q``, whose frames
        before ``start`` are already scored; ``after_block(pos, Q, carry)``
        is called after each block, ``pos`` the frames scored and
        ``carry()`` giving the fl-1 carried frames (carry_t, carry_r)."""
        fl = taps.shape[1]
        stream_idx = pad_idx[fl - 1:]  # frame feeding each output frame
        if Q is None:
            Q = torch.empty((self.plan.height, 2, n_frames), dtype=torch.float32,
                            device=self.device)
        carry_t, carry_r = indexed(pad_idx[:fl - 1]) if carry is None else carry
        for pos in range(start, n_frames, B):
            with span("fvvdp.chunk"):
                b = min(B, n_frames - pos)
                blk = stream_idx[pos:pos + b]
                if np.array_equal(blk, np.arange(pos, pos + b)):
                    new_t, new_r = block(pos, b)
                else:  # circular/pingpong padding reorders the first frames
                    new_t, new_r = indexed(blk)
                Q_blk, heat, carry_t, carry_r = self.video_step(
                    carry_t, carry_r, new_t, new_r, taps, fov_tables,
                    None if gaze is None else gaze[pos:pos + b])
                Q[:, :, pos:pos + b] = Q_blk
                if keep is not None:
                    keep(heat)
                if after_block is not None:
                    after_block(pos + b, Q, lambda: (carry_t, carry_r))
        return Q

    def video_step(self, carry_t, carry_r, new_t, new_r, taps: torch.Tensor,
                   fov_tables=None, gaze=None):
        """One streaming step: temporal channels over the fl-1 carried frames
        plus the new block (B, H, W), then scoring (``gaze``: the block's
        (B, 2) rows).  Returns (Q_per_ch (n_bands, 2, B), heatmap or None,
        next carry_t, next carry_r)."""
        fl = taps.shape[1]
        B = new_t.shape[0]
        R = temporal_ops.temporal_channels_pair(carry_t, new_t, carry_r, new_r, taps)
        Q, heat = self.score_frames(R, temp_ch=2, fov_tables=fov_tables, gaze=gaze)
        if fl - 1 <= B:
            c_t, c_r = new_t[B - (fl - 1):], new_r[B - (fl - 1):]
        else:
            c_t = torch.cat([carry_t, new_t], dim=0)[-(fl - 1):]
            c_r = torch.cat([carry_r, new_r], dim=0)[-(fl - 1):]
        return Q, heat, c_t.contiguous(), c_r.contiguous()
