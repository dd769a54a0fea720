"""Metric core: scoring of frame blocks.

Counterpart of ``fovvideovdp_tpu/core.py:47-257,287-332,382-449,451-668,
673-721,848-901`` for ``local_adapt`` "gpyr", Weber contrast and
'min_mutual_masking_perc_norm2' masking, on LUTs with a uniform Y grid.
Per block: temporal channels (CUDA kernel), Gaussian pyramid (reduce
kernel), then one of five routes per level:

* default (no foveation, no heatmap, both LUTs on one Y grid): the fused
  expand + score kernel; contrast never reaches memory;
* fixed-gaze foveation: expand_contrast kernel, then band_score2_fov with
  the per-pixel CSF tables of the fixation point;
* moving-gaze foveation (a gaze per frame): expand_contrast, then mov_score,
  which finds each pixel's eccentricity from the frame's gaze and
  interpolates the band's LUT window itself; no tables are built;
* per-channel LUTs (Y grids differ): expand_contrast, then band_score once
  per temporal channel;
* heatmaps (and foveation on per-channel LUTs, and a moving gaze on LUTs
  whose rho or eccentricity axis is not uniform): expand_contrast, then the
  per-pixel composition in tensor operations, which keeps the difference
  map D of every level for the reconstruction.

The route is fixed when the core is built, never chosen on a failure.

Layout: (F, C, H, W) with C = [T-sust, R-sust, T-trans, R-trans]; an image
has C = 2.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fovvideovdp_tpu_torch import csf as csf_mod
from fovvideovdp_tpu_torch.ops import masking as mask_ops
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops
from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
from fovvideovdp_tpu_torch.ops.pyramid import PyramidPlan
from fovvideovdp_tpu_torch.visualize import visualize_diff_map_frames


class MetricCore:
    """Static per-resolution state (pyramid plan, per-band CSF tables,
    foveation maps) and the block scorers.  ``heatmap`` and
    ``heatmap_dtype`` come checked from ``fvvdp``."""

    # Fixed-gaze table sets kept per core: as many as fit a quarter of the
    # card's memory, between 1 and 8 (one 4K set is 1.68 GB, so an 80 GB
    # card keeps 8; block sizing reads the free memory after they are
    # built).  On the CPU, 2.
    _FOV_CACHE_SHARE = 0.25
    _FOV_CACHE_MAX = 8
    _FOV_CACHE_CPU = 2

    def __init__(self, plan: PyramidPlan, params: Dict, luts: Sequence[Dict],
                 device, peak_luminance=None, geometry=None, foveated: bool = False,
                 heatmap: Optional[str] = None, heatmap_dtype: str = "float16"):
        self.plan = plan
        self.params = params
        self.luts = tuple(luts)
        self.device = torch.device(device)
        self.peak_luminance = peak_luminance
        self.geometry = geometry
        self.foveated = bool(foveated)
        self.heatmap = heatmap
        self.do_heatmap = heatmap is not None and heatmap != "none"
        self.heatmap_dtype = heatmap_dtype
        if len(self.luts) < 2:
            raise ValueError("the metric needs one LUT per temporal channel (2)")
        if not all(csf_mod._axis_uniform(l, "Y_log") for l in self.luts):
            raise NotImplementedError(
                "LUTs with a non-uniform Y grid take the unfused scorer, "
                "ROADMAP queue 1 item 3")
        self._luts_share_Y = all(
            np.array_equal(csf_mod._np(self.luts[0][k]), csf_mod._np(self.luts[1][k]))
            for k in ("Y_log", "Y"))

        # which scorer score_frames takes (see the module's docstring)
        if self.do_heatmap or (self.foveated and not self._luts_share_Y):
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
        if not self.foveated and self._luts_share_Y:
            lut2 = self.luts[0]
            for bb in range(plan.height):
                t2, lut2 = csf_mod.trim_lut_range(np.stack(self._band_tables[bb]),
                                                  self.luts[0], lbkg_max=peak_luminance)
                self._score_tables.append(self._to_device(t2))
            self._score_lut = lut2
            self._meta = [self._score_meta(lut2, bb) for bb in range(plan.height)]
        elif not self.foveated:
            for bb in range(plan.height):
                self._channel_tables.append(tuple(
                    self._to_device(t) for t in self._band_tables[bb]))
                self._channel_meta.append(tuple(
                    self._score_meta(self.luts[cc], bb) for cc in range(2)))

        # Fixed gaze: the per-pixel tables get the same Y-knot trim (32 -> 19
        # planes on a 200 cd/m^2 display), which cuts both the kernel's table
        # reads and the memory the cached sets hold.
        self._fov_trim = None
        self._fov_lut = None
        self._fov_meta: List = []
        self._fov_table_cache: Dict = {}   # insertion-ordered: least recent first
        self._mov_cache: Dict = {}         # band -> static data of mov_score
        if self.foveated and self._luts_share_Y:
            lo, hi, lut2 = csf_mod.trim_lut_bounds(self.luts[0], lbkg_max=peak_luminance)
            if lut2 is not self.luts[0]:
                self._fov_trim = (lo, hi)
                self._fov_lut = lut2
            self._fov_meta = [self._score_meta(self._fov_lut or self.luts[0], bb)
                              for bb in range(plan.height)]

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
        if not self.foveated:
            return 0
        if self._fov_trim is not None:
            n = self._fov_trim[1] - self._fov_trim[0] + 1
        else:
            n = int(self.luts[0]["Y_log"].shape[0])
        return n * 2 * sum(int(r.numel()) for r in self._band_rho) * 4

    def _fov_cache_entries(self) -> int:
        if self.device.type != "cuda":
            return self._FOV_CACHE_CPU
        total = torch.cuda.get_device_properties(self.device).total_memory
        fit = int(self._FOV_CACHE_SHARE * total // max(self.fov_table_bytes(), 1))
        return max(1, min(self._FOV_CACHE_MAX, fit))

    def fov_tables(self, gaze_xy):
        """Per band, per channel (n, h, w) S_log(Y_log) tables for a fixed
        fixation point (x, y) in pixels: the LUT's (rho, ecc) axes are
        collapsed once here, so the per-frame foveated CSF costs the same
        as the non-foveated 1-D one.  Cached for the most recent fixation
        points only (see ``_FOV_CACHE_SHARE``)."""
        key = (float(gaze_xy[0]), float(gaze_xy[1]))
        cache = self._fov_table_cache
        if key in cache:                          # refresh its place
            cache[key] = cache.pop(key)
            return cache[key]
        while len(cache) >= self._fov_cache_entries():
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
                    t = t[lo:hi + 1].contiguous()
                per_cc.append(t)
            tabs.append(tuple(per_cc))
        cache[key] = tabs
        return tabs

    def drop_fov_tables(self) -> None:
        """Free every cached fixed-gaze table set."""
        self._fov_table_cache.clear()

    # ------------------------------------------------------------------
    # moving gaze
    # ------------------------------------------------------------------
    def _gaze_directions(self, gaze: torch.Tensor) -> torch.Tensor:
        """gaze (F, 2) pixel coordinates -> view directions (F, 2) in
        degrees, on the core's device."""
        gaze = torch.as_tensor(gaze, dtype=torch.float32, device=self.device)
        return self.geometry.pix2view_direction(
            (self.plan.W, self.plan.H), gaze[:, 0] + 0.5, gaze[:, 1] + 0.5).T.contiguous()

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
        coordinates of the gaze in each frame.  Returns (Q_per_ch
        (n_bands, 2, F), heatmap (F, c, H, W) or None)."""
        if self.foveated and (fov_tables is None) == (gaze is None):
            raise ValueError("a foveated core scores with either the fixation "
                             "point's fov_tables or a per-frame gaze")
        R = R.contiguous()
        gaze_dir = None
        if self.foveated and gaze is not None:
            if tuple(gaze.shape) != (R.shape[0], 2):
                raise ValueError(f"gaze must be ({R.shape[0]}, 2), one row per frame "
                                 f"of the block, got {tuple(gaze.shape)}")
            gaze_dir = self._gaze_directions(gaze)
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

    def _score_frames_fused(self, R: torch.Tensor, temp_ch: int) -> torch.Tensor:
        plan = self.plan
        gpyr = plan.gaussian_pyramid(R)
        Q_rows = []
        for bb in range(plan.height):
            ssum2 = bp.expand_score2(gpyr[bb], gpyr[bb + 1], self._score_tables[bb],
                                     self._meta[bb])               # (F, 2)
            Q_rows.append(self._q_pair(ssum2, bb, temp_ch))
        return torch.stack(Q_rows, dim=0)                         # (n_bands, 2, F)

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
            Q_cc = []
            for cc in range(temp_ch):
                meta = self._channel_meta[bb][cc]
                ssum = bs.band_score(band[:, 2 * cc], band[:, 2 * cc + 1], L,
                                     self._channel_tables[bb][cc], meta,
                                     (meta.q_s, meta.q_t)[cc])    # (F,)
                Q_cc.append(self._q_from_sums(ssum[:, None], bb)[0])
            while len(Q_cc) < 2:
                Q_cc.append(torch.zeros_like(Q_cc[0]))
            Q_rows.append(torch.stack(Q_cc, dim=0))
        return torch.stack(Q_rows, dim=0)

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

    def _score_frames_composed(self, R: torch.Tensor, temp_ch: int, fov_tables,
                               gaze_dir=None
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Materialised contrast scored in tensor operations, keeping the
        per-pixel difference D of every level for the heatmap."""
        p = self.params
        plan = self.plan
        F = R.shape[0]
        sens_corr = 10.0 ** (p["sensitivity_correction"] / 20.0)
        w_temp_ch = (1.0, p["w_transient"])
        n_bands = plan.get_band_count()
        Q_rows = []
        heat_bands: List[torch.Tensor] = []
        for bb, (band, L_bkg) in enumerate(plan.contrast_levels(R)):
            gain = plan.band_gain(bb, n_bands)
            band = band * gain
            L = L_bkg[:, 0]
            ecc = None
            if gaze_dir is not None:
                vd = self._band_view_dir[bb]
                ecc = torch.sqrt((vd[0] - gaze_dir[:, 0, None, None]) ** 2
                                 + (vd[1] - gaze_dir[:, 1, None, None]) ** 2)
            Q_cc = []
            D_acc = None
            for cc in range(temp_ch):
                S = self._sensitivity(bb, cc, L, fov_tables, ecc) * sens_corr
                q = (p["mask_q_sust"], p["mask_q_trans"])[cc]
                D = mask_ops.apply_masking_model(band[:, 2 * cc], band[:, 2 * cc + 1],
                                                 1.0 / S, p["mask_p"], q, p["mask_c"])
                ssum = torch.sum(torch.pow(torch.abs(D), p["beta"]), dim=(-2, -1))
                Q_cc.append(self._q_from_sums(ssum[:, None], bb)[0])
                if self.do_heatmap:
                    D_acc = D if cc == 0 else D_acc + w_temp_ch[cc] * D
            while len(Q_cc) < 2:
                Q_cc.append(torch.zeros((F,), dtype=R.dtype, device=R.device))
            Q_rows.append(torch.stack(Q_cc, dim=0))
            if self.do_heatmap:
                heat_bands.append((D_acc / gain)[:, None])        # (F, 1, h, w)
        Q_per_ch = torch.stack(Q_rows, dim=0)
        if not self.do_heatmap:
            return Q_per_ch, None

        base = torch.zeros((F, 1) + plan.level_shapes[plan.height], dtype=R.dtype,
                           device=R.device)
        dmap = plan.reconstruct(heat_bands + [base])
        beta_jod = 10.0 ** p["log_jod_exp"]
        dmap = torch.pow(torch.clamp(dmap, min=0.0), beta_jod) * abs(p["jod_a"])
        if self.heatmap == "raw":
            heat = dmap
        else:
            # the context is the test-sustained channel
            heat = visualize_diff_map_frames(dmap, R[:, 0:1], self.heatmap)
        if self.heatmap_dtype == "uint8":
            # display-referred RGB in [0, 1], quantised on the device
            # (torch.round rounds half to even, as jnp.round does)
            heat = torch.round(torch.clamp(heat, 0.0, 1.0) * 255.0).to(torch.uint8)
        else:
            heat = heat.to(torch.float16)
        return Q_per_ch, heat

    def score_image(self, T: torch.Tensor, Rf: torch.Tensor, fov_tables=None, gaze=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(H, W) luminance pair -> (Q_per_ch (n_bands, 2, 1), heatmap).
        ``gaze``: (1, 2), in place of ``fov_tables``."""
        return self.score_frames(torch.stack([T, Rf], dim=0)[None], temp_ch=1,
                                 fov_tables=fov_tables, gaze=gaze)

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
            b = min(chunk, n - pos)
            Q[:, :, pos:pos + b], heat = self.score_frames(
                torch.stack(frames(pos, b), dim=1), 1, fov_tables,
                None if gaze is None else gaze[pos:pos + b])
            if keep is not None:
                keep(heat)
        return Q

    def score_video(self, block: Callable, indexed: Callable, n_frames: int,
                    taps: torch.Tensor, pad_idx: np.ndarray, B: int, fov_tables=None,
                    gaze=None, keep: Optional[Callable] = None) -> torch.Tensor:
        """Q_per_ch (n_bands, 2, n_frames) of a clip streamed B frames at a
        time, each block filtered with the fl-1 frames before it
        (:meth:`video_step`).  ``block(start, count)`` and
        ``indexed(indices)`` give (count, H, W) test and reference luminance
        on the core's device; ``pad_idx``: the padded clip's frame indices
        (``ops.temporal.padding_indices``); ``gaze``: (n_frames, 2) rows, in
        place of ``fov_tables``; ``keep(heat)`` takes each block's heatmap."""
        fl = taps.shape[1]
        stream_idx = pad_idx[fl - 1:]  # frame feeding each output frame
        Q = torch.empty((self.plan.height, 2, n_frames), dtype=torch.float32,
                        device=self.device)
        carry_t, carry_r = indexed(pad_idx[:fl - 1])
        for pos in range(0, n_frames, B):
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
