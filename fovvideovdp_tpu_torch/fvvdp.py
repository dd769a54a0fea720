"""FovVideoVDP metric: public API.

Counterpart of ``fovvideovdp_tpu/fvvdp.py:68-213`` (constructor, config,
display, cores), ``predict``, ``predict_video_source`` (image branch, the
streaming loop, foveation with a fixed or a per-frame gaze, heatmaps on the
host or the device) and ``do_pooling_and_jods``.  The default device is the
CUDA card; ``device="cpu"`` runs every kernel's plain version instead.

Frames are scored in blocks: each block's temporal window is the fl-1
carried frames plus the new block, and ``Q_per_ch`` stays on the device
until pooling, which copies one scalar and the (n_bands, 2, F) table back.
Heatmap frames leave the device block by block unless ``device_heatmap``
keeps them there.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from fovvideovdp_tpu_torch import utils
from fovvideovdp_tpu_torch.core import MetricCore
from fovvideovdp_tpu_torch.csf import CSFCache
from fovvideovdp_tpu_torch.display_model import (fvvdp_display_geometry,
                                                 fvvdp_display_photometry)
from fovvideovdp_tpu_torch.ops import masking as mask_ops
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops
from fovvideovdp_tpu_torch.ops.pyramid import PyramidPlan
from fovvideovdp_tpu_torch.video_source import fvvdp_video_source_array

# Device bytes a block of B frames at H x W keeps live, per pixel-frame, by
# the route the core takes (core.MetricCore.route).  "fused": the
# (B, 4, H, W) float32 temporal responses (16 B), their Gaussian pyramid
# (~5.3 B), the luminance pair and the decode temporaries.  "banded" adds
# one level's materialised contrast and L_bkg (20 B at level 0); "composed"
# (heatmaps) adds the temporaries of the per-pixel composition, every
# level's difference map, the reconstruction and the rendered frames.
# "moving" (a gaze per frame through mov_score) holds what "banded" holds,
# without resident tables; a gaze per frame on the composed route adds one
# level's eccentricity maps and frame-sized temporaries to "composed", which
# its figure covers (measured 116.4 B).
# chip_smoke.py measures the peaks on the card at 4K (PERF.md, where the
# time goes): 38.1, 64.8 and 118.9 B, and for "moving" 59.8 B above what was
# on the card before the call; the figures here are those rounded up.
_BLOCK_BYTES_PER_PX_FRAME = {"fused": 40, "banded": 68, "composed": 128, "moving": 68}
# share of the free device memory a block may take
_BLOCK_MEM_SHARE = 0.5
# Past this, a longer block only holds more memory: the fl-1 carried frames
# each block re-reads are already under a fifth of the temporal kernel's
# input at 30 fps (7 of 39 frames), and the per-block launches are ~25.
_MAX_BLOCK_FRAMES = 32

HEATMAP_TYPES = ("raw", "threshold", "supra-threshold", "monochromatic")

_DEFAULTS = dict(local_adapt="gpyr", contrast="weber",
                 masking_model="min_mutual_masking_perc_norm2", pu_dilate=0.0)


def _unsupported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to fovvideovdp_tpu_torch "
                               f"yet ({item} of ROADMAP.md)")


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fovvideovdp_tpu_torch runs on a CUDA card by default and none "
                "is available; pass device=\"cpu\" to run the plain PyTorch "
                "versions of the kernels on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


class fvvdp:
    """Full-reference video/image quality metric (JOD units): foveated with
    a fixed fixation point or a gaze per frame, or not foveated; with or
    without a heatmap."""

    def __init__(self, display_name="standard_4k", display_photometry=None,
                 display_geometry=None, color_space="sRGB", foveated=False,
                 heatmap=None, quiet=False, device=None, temp_padding="replicate",
                 use_checkpoints=False, block_frames=None,
                 do_temporal_channels=True, ignore_boundary_pixels=False,
                 band_callback=None, content_mapping=None,
                 parameter_overrides=None, device_heatmap=False,
                 heatmap_dtype="float16"):
        if heatmap not in (None, "none") + HEATMAP_TYPES:
            raise ValueError(f"Unsupported heatmap type {heatmap!r}")
        if temp_padding not in ("replicate", "circular", "pingpong"):
            raise ValueError(f"Unsupported temporal padding method {temp_padding!r}")
        if heatmap_dtype not in ("float16", "uint8"):
            raise ValueError(f"heatmap_dtype must be 'float16' or 'uint8', "
                             f"got {heatmap_dtype!r}")
        if heatmap_dtype == "uint8" and heatmap == "raw":
            # raw maps are unbounded JOD-scale magnitudes; 8 bits only make
            # sense for the display-referred colour-mapped outputs
            raise ValueError("heatmap_dtype='uint8' requires a colormapped "
                             "heatmap type, not 'raw'")
        if not do_temporal_channels:
            raise _unsupported("do_temporal_channels=False", "queue 1 item 10")
        if ignore_boundary_pixels:
            raise _unsupported("ignore_boundary_pixels", "queue 1 item 10")
        if band_callback is not None:
            raise _unsupported("band_callback", "queue 1 item 10")
        if content_mapping is not None:
            raise _unsupported("content_mapping", "queue 1 item 10")
        if use_checkpoints:
            raise _unsupported("use_checkpoints", "queue 1 item 13")

        self.device = _resolve_device(device)
        self.quiet = quiet
        self.foveated = bool(foveated)
        self.heatmap = heatmap
        self.do_heatmap = heatmap is not None and heatmap != "none"
        # keep stats["heatmap"] as a tensor on the device instead of copying
        # every block's frames to the host
        self.device_heatmap = device_heatmap
        # "uint8" quantises colour-mapped heatmaps on the device ([0, 1] RGB
        # -> 0..255), half the bytes of the reference's float16
        self.heatmap_dtype = heatmap_dtype
        self.color_space = color_space
        self.temp_padding = temp_padding
        self.block_frames = block_frames

        self.set_display_model(display_name, display_photometry=display_photometry,
                               display_geometry=display_geometry)
        self.load_config(parameter_overrides)
        self.csf_cache = CSFCache(self.device)
        self.omega = (0.0, 5.0)
        self._luts = tuple(self.csf_cache.get(o, self.csf_sigma, self.k_cm)
                           for o in self.omega)
        self._cores: Dict = {}

    # ------------------------------------------------------------------
    def load_config(self, parameter_overrides=None):
        self.parameters_file = utils.config_files.find("fvvdp_parameters.json")
        logging.debug(f"Loading FovVideoVDP parameters from '{self.parameters_file}'")
        parameters = utils.json2dict(self.parameters_file)
        if parameter_overrides:
            unknown = set(parameter_overrides) - set(parameters)
            if unknown:
                raise RuntimeError(f"Unknown metric parameter(s): {sorted(unknown)}")
            parameters = dict(parameters, **parameter_overrides)
        self._set_parameters(parameters)

    def _set_parameters(self, parameters: Dict):
        for key, default in _DEFAULTS.items():
            if parameters.get(key, default) != default:
                raise _unsupported(f"{key}={parameters[key]!r}", "queue 1 item 10")
        self.parameters = parameters
        for key in ("mask_p", "mask_c", "pu_dilate", "w_transient", "beta", "beta_t",
                    "beta_tch", "beta_sch", "sustained_sigma", "sustained_beta",
                    "csf_sigma", "sensitivity_correction", "masking_model",
                    "local_adapt", "contrast", "jod_a", "log_jod_exp",
                    "mask_q_sust", "mask_q_trans", "k_cm", "filter_len", "version"):
            setattr(self, key, parameters[key])

    def load_state(self, parameters: Dict, luts) -> None:
        """Install calibration state (see ``state.state_from_numpy``) and
        drop the cores built from the previous state, with the fixed-gaze
        tables they cache."""
        self._set_parameters(parameters)
        self._luts = tuple(luts)
        for core in self._cores.values():
            core.drop_fov_tables()
        self._cores = {}

    def set_display_model(self, display_name="standard_4k", display_photometry=None,
                          display_geometry=None):
        if display_photometry is None:
            self.display_photometry = fvvdp_display_photometry.load(display_name)
            self.display_name = display_name
        else:
            self.display_photometry = display_photometry
            self.display_name = "unspecified"
        if display_geometry is None:
            self.display_geometry = fvvdp_display_geometry.load(display_name)
        else:
            self.display_geometry = display_geometry
        self.pix_per_deg = self.display_geometry.get_ppd()

    # ------------------------------------------------------------------
    def predict(self, test_cont, reference_cont, dim_order="BCFHW",
                frames_per_second=0, fixation_point=None, mesh=None):
        """Predict quality for arrays.  Returns (Q_JOD, stats)."""
        if mesh is not None:
            raise _unsupported("mesh", "queue 1 item 14")
        test_vs = fvvdp_video_source_array(
            test_cont, reference_cont, frames_per_second, dim_order=dim_order,
            display_photometry=self.display_photometry,
            color_space_name=self.color_space, device=self.device)
        return self.predict_video_source(test_vs, fixation_point=fixation_point)

    def _get_core(self, width: int, height: int) -> MetricCore:
        key = (width, height)
        if key not in self._cores:
            plan = PyramidPlan(width, height, self.pix_per_deg)
            try:
                peak = float(self.display_photometry.get_peak_luminance())
            except Exception:
                peak = None   # custom photometry without a peak: trim bottom only
            self._cores[key] = MetricCore(
                plan, self.parameters, self._luts, self.device, peak_luminance=peak,
                geometry=self.display_geometry, foveated=self.foveated,
                heatmap=self.heatmap, heatmap_dtype=self.heatmap_dtype)
        return self._cores[key]

    def _pick_block_size(self, height: int, width: int, n_frames: int,
                         route: str = "fused") -> int:
        """Frames per block: what half of the free device memory holds at
        the route's bytes per pixel-frame.  Call it after the fixed-gaze
        tables are built, so that the free memory excludes them."""
        if self.block_frames is not None:
            return max(1, min(int(self.block_frames), n_frames))
        if self.device.type != "cuda":
            return min(_MAX_BLOCK_FRAMES, n_frames)
        free, _ = torch.cuda.mem_get_info(self.device)
        # memory the caching allocator holds but no tensor uses is free too
        free += torch.cuda.memory_reserved(self.device) \
            - torch.cuda.memory_allocated(self.device)
        by_mem = int(_BLOCK_MEM_SHARE * free
                     // (_BLOCK_BYTES_PER_PX_FRAME[route] * height * width))
        return max(1, min(by_mem, _MAX_BLOCK_FRAMES, n_frames))

    def _device_heatmap_budget(self):
        """Bytes a whole video's heatmap may hold on the device: half of the
        card's free memory (no limit on the CPU)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.mem_get_info(self.device)[0] // 2

    def _check_device_heatmap_budget(self, n_frames, height, width):
        """Whole-video device heatmaps accumulate in device memory: refuse a
        job that would exhaust it mid-video, before any scoring."""
        budget = self._device_heatmap_budget()
        channels = 1 if self.heatmap == "raw" else 3
        elsize = 1 if self.heatmap_dtype == "uint8" else 2
        est = n_frames * channels * height * width * elsize
        if budget is not None and est > budget:
            raise RuntimeError(
                f"device_heatmap=True would accumulate ~{est / 2**30:.1f} GiB "
                f"of heatmap in device memory ({n_frames} frames x {channels} "
                f"x {height}x{width} {self.heatmap_dtype}), over half of the "
                f"card's free memory ({budget / 2**30:.1f} GiB). Use "
                f"device_heatmap=False to copy heatmap frames to the host "
                f"block by block instead")

    @torch.no_grad()
    def predict_video_source(self, vid_source, fixation_point=None, mesh=None,
                             checkpoint_path=None):
        """Score a video source.  ``fixation_point``: one (x, y) point in
        pixels (the centre of the frame by default), or an (N, 2) array with
        one row per frame for a moving gaze; it matters only when the metric
        is foveated."""
        if mesh is not None:
            raise _unsupported("mesh", "queue 1 item 14")
        if checkpoint_path is not None:
            raise _unsupported("checkpoint_path", "queue 1 item 12")
        height, width, N_frames = vid_source.get_video_size()

        fov_tables = None
        gaze = None                  # (N_frames, 2) tensor: the moving route
        core = self._get_core(width, height)
        route = core.route
        if self.foveated:
            if fixation_point is None:
                fixation_point = np.array([width // 2, height // 2])
            fixation_point = np.asarray(fixation_point, dtype=np.float32)
            if fixation_point.ndim == 2 and fixation_point.shape[1] == 2:
                if fixation_point.shape[0] < N_frames:
                    raise RuntimeError(
                        f"fixation_point has {fixation_point.shape[0]} per-frame "
                        f"rows but the video has {N_frames} frames; pass one (x, y) "
                        f"point or at least one row per frame")
                # this route reads no fixed-gaze tables; an earlier call may
                # have left GB of them on the card
                core.drop_fov_tables()
                gaze = torch.as_tensor(fixation_point[:N_frames], device=self.device)
                route = "moving" if core.moving_route == "banded" else "composed"
            elif fixation_point.shape == (2,):
                fov_tables = core.fov_tables((float(fixation_point[0]),
                                              float(fixation_point[1])))
            else:
                raise ValueError(
                    f"fixation_point must be one (x, y) point or an (N, 2) array of "
                    f"per-frame points, got shape {fixation_point.shape}")
        plan = core.plan
        if self.do_heatmap and self.device_heatmap:
            self._check_device_heatmap_budget(N_frames, height, width)
        heat_blocks = []   # (b, c, H, W) per block: tensors, or arrays on the host

        def keep(heat):
            if heat is not None:
                heat_blocks.append(heat if self.device_heatmap else heat.cpu().numpy())

        if N_frames == 1:
            t, r = vid_source.get_luminance_block(0, 1)
            Q_per_ch, heat = core.score_image(t[0], r[0], fov_tables, gaze)
            keep(heat)
        else:
            fps = vid_source.get_frames_per_second()
            fl = temporal_ops.filter_len_for_fps(fps)
            filt = temporal_ops.temporal_filters(
                fps, fl, self.sustained_sigma, self.sustained_beta)
            taps = torch.as_tensor(filt, device=self.device)
            pad_idx = temporal_ops.padding_indices(N_frames, fl, self.temp_padding)
            stream_idx = pad_idx[fl - 1:]  # frame feeding each output frame

            B = self._pick_block_size(height, width, N_frames, route)
            Q_per_ch = torch.empty((plan.height, 2, N_frames), dtype=torch.float32,
                                   device=self.device)
            carry_t, carry_r = vid_source.get_indexed_luminance_block(pad_idx[:fl - 1])
            pos = 0
            while pos < N_frames:
                b = min(B, N_frames - pos)
                blk = stream_idx[pos:pos + b]
                if np.array_equal(blk, np.arange(pos, pos + b)):
                    new_t, new_r = vid_source.get_luminance_block(pos, b)
                else:  # circular/pingpong padding reorders the first frames
                    new_t, new_r = vid_source.get_indexed_luminance_block(blk)
                Q_blk, heat, carry_t, carry_r = core.video_step(
                    carry_t, carry_r, new_t, new_r, taps, fov_tables,
                    None if gaze is None else gaze[pos:pos + b])
                Q_per_ch[:, :, pos:pos + b] = Q_blk
                keep(heat)
                pos += b

        Q_jod = self.do_pooling_and_jods(Q_per_ch)
        stats = {
            "Q_per_ch": Q_per_ch.cpu().numpy(),
            "rho_band": plan.get_freqs(),
            "frames_per_second": vid_source.get_frames_per_second(),
            "width": width,
            "height": height,
            "N_frames": N_frames,
        }
        if self.do_heatmap:
            # (1, c, F, H, W): float16 (the reference's layout and type) or
            # uint8; a tensor on the device with device_heatmap, else numpy
            if self.device_heatmap:
                stats["heatmap"] = torch.cat(heat_blocks, dim=0).permute(1, 0, 2, 3)[None]
            else:
                stats["heatmap"] = np.concatenate(heat_blocks, axis=0).transpose(
                    1, 0, 2, 3)[None]
        return float(Q_jod), stats

    # ------------------------------------------------------------------
    def do_pooling_and_jods(self, Q_per_ch: torch.Tensor) -> torch.Tensor:
        """Band/channel/frame pooling + JOD regression; a 0-d tensor on
        Q_per_ch's device."""
        return mask_ops.pool_to_jod(
            Q_per_ch, float(self.w_transient), float(self.beta_sch),
            float(self.beta_tch), float(self.beta_t), float(self.jod_a),
            float(self.log_jod_exp))

    def get_temporal_filters(self, frames_per_s):
        """(F, omega): the temporal filters and their channel frequencies."""
        fl = self.filter_len if self.filter_len > 0 \
            else temporal_ops.filter_len_for_fps(frames_per_s)
        F = temporal_ops.temporal_filters(frames_per_s, fl, self.sustained_sigma,
                                          self.sustained_beta)
        return (torch.as_tensor(F, device=self.device),
                torch.as_tensor([0, 5], device=self.device))

    # ------------------------------------------------------------------
    def short_name(self):
        return "FovVideoVDP"

    def quality_unit(self):
        return "JOD"

    def get_info_string(self):
        standard_str = f", ({self.display_name})" \
            if self.display_name.startswith("standard_") else ""
        return '"FovVideoVDP v{}, {:.4g} [pix/deg], Lpeak={:.5g}, Lblack={:.4g} [cd/m^2], {}{}"'.format(
            self.version, self.pix_per_deg,
            self.display_photometry.get_peak_luminance(),
            self.display_photometry.get_black_level(),
            "foveated" if self.foveated else "non-foveated", standard_str)
