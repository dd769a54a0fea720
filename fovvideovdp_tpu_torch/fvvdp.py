"""FovVideoVDP metric: public API.

Counterpart of ``fovvideovdp_tpu/fvvdp.py:68-213`` (constructor, config,
display, cores), ``predict``, ``predict_video_source`` (image branch, the
streaming loop, the ``do_temporal_channels=False`` ablation, foveation with
a fixed or a per-frame gaze, heatmaps on the host or the device),
``predict_batch`` on one card (``:953-1163``), the differentiable
``predict_traced`` and ``loss`` (``:1165-1242``), ``do_pooling_and_jods`` and
``write_features_to_json`` (``:1283-1295``).  The default device is the
CUDA card; ``device="cpu"`` runs every kernel's plain version instead.

Frames are scored in blocks: each block's temporal window is the fl-1
carried frames plus the new block, and ``Q_per_ch`` stays on the device
until pooling, which copies one scalar and the (n_bands, 2, F) table back.
Heatmap frames leave the device block by block unless ``device_heatmap``
keeps them there.  ``predict_traced`` scores a whole clip in one autograd
graph instead: every kernel's wrapper goes through its
``torch.autograd.Function`` there (``ops/cuda/_autograd.py``).
"""
from __future__ import annotations

import functools
import json
import logging
from typing import Dict

import numpy as np
import torch
import torch.utils.checkpoint

from fovvideovdp_tpu_torch import utils
from fovvideovdp_tpu_torch.core import MetricCore
from fovvideovdp_tpu_torch.csf import CSFCache
from fovvideovdp_tpu_torch.display_model import (fvvdp_display_geometry,
                                                 fvvdp_display_photometry)
from fovvideovdp_tpu_torch.ops import masking as mask_ops
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops
from fovvideovdp_tpu_torch.ops.pyramid import PyramidPlan
from fovvideovdp_tpu_torch.parallel.sharding import (make_batch_scorer,
                                                     make_batch_video_scorer)
from fovvideovdp_tpu_torch.video_source import (PairBatch, channels_to_luminance,
                                                fvvdp_video_source_array, reshuffle_dims,
                                                resolve_device, rgb_to_y)

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
# Independent frames (the images of a batch, the frames of the ablation,
# whole clips of a batch) carry nothing between chunks, so a chunk is capped
# by memory and by the launch plans alone: expand_contrast puts the frames
# on grid.z, which takes at most 65535.
_MAX_CHUNK_FRAMES = 65535
# Bytes per pixel-frame a chunk of images holds on top of its route's: the
# (n, 2, H, W) stack of the pair stays live beside the copy that adds the
# zero transient planes (core.score_frames; foveated, each level's contrast
# beside its zero-padded copy).
_IMAGE_STACK_BYTES = 8

HEATMAP_TYPES = ("raw", "threshold", "supra-threshold", "monochromatic")

_DEFAULTS = dict(local_adapt="gpyr", contrast="weber",
                 masking_model="min_mutual_masking_perc_norm2", pu_dilate=0.0)


def _unsupported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to fovvideovdp_tpu_torch "
                               f"yet ({item} of ROADMAP.md)")


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
        if ignore_boundary_pixels:
            raise _unsupported("ignore_boundary_pixels", "queue 1 item 3")
        if band_callback is not None:
            raise _unsupported("band_callback", "queue 1 item 3")
        if content_mapping is not None:
            raise _unsupported("content_mapping", "queue 1 item 3")

        self.device = resolve_device(device)
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
        # False: every frame of a video is scored as an independent image
        # (the MATLAB core's ablation); predict_batch does not read it, as
        # in the JAX package
        self.do_temporal_channels = bool(do_temporal_channels)
        self.content_mapping = content_mapping      # None: refused above
        # predict_traced recomputes the spatial scoring in the backward
        # instead of keeping its graph (torch.utils.checkpoint)
        self.use_checkpoints = bool(use_checkpoints)

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
                raise _unsupported(f"{key}={parameters[key]!r}", "queue 1 item 3")
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
            raise _unsupported("mesh", "queue 1 item 7")
        test_vs = fvvdp_video_source_array(
            test_cont, reference_cont, frames_per_second, dim_order=dim_order,
            display_photometry=self.display_photometry,
            color_space_name=self.color_space, device=self.device)
        return self.predict_video_source(test_vs, fixation_point=fixation_point)

    def _get_core(self, width: int, height: int, with_heatmap: bool = True) -> MetricCore:
        """The core of this resolution; ``with_heatmap=False``: the core of
        the same metric without a heatmap, which scores on the kernels'
        routes (predict_batch returns no heatmap)."""
        heatmap = self.heatmap if with_heatmap else None
        key = (width, height, heatmap)
        if key not in self._cores:
            plan = PyramidPlan(width, height, self.pix_per_deg)
            try:
                peak = float(self.display_photometry.get_peak_luminance())
            except Exception:
                peak = None   # custom photometry without a peak: trim bottom only
            self._cores[key] = MetricCore(
                plan, self.parameters, self._luts, self.device, peak_luminance=peak,
                geometry=self.display_geometry, foveated=self.foveated,
                heatmap=heatmap, heatmap_dtype=self.heatmap_dtype)
        return self._cores[key]

    def _free_device_bytes(self):
        """The card's free memory, with what the caching allocator holds but
        no tensor uses; None on the CPU."""
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        return free + torch.cuda.memory_reserved(self.device) \
            - torch.cuda.memory_allocated(self.device)

    def _frames_by_memory(self, height: int, width: int, bytes_per_px_frame: int):
        """Frames that half of the free device memory holds; None on the CPU."""
        free = self._free_device_bytes()
        if free is None:
            return None
        return int(_BLOCK_MEM_SHARE * free // (bytes_per_px_frame * height * width))

    def _pick_block_size(self, height: int, width: int, n_frames: int,
                         route: str = "fused") -> int:
        """Frames per block: what half of the free device memory holds at
        the route's bytes per pixel-frame.  Call it after the fixed-gaze
        tables are built, so that the free memory excludes them."""
        if self.block_frames is not None:
            return max(1, min(int(self.block_frames), n_frames))
        by_mem = self._frames_by_memory(height, width, _BLOCK_BYTES_PER_PX_FRAME[route])
        if by_mem is None:
            return min(_MAX_BLOCK_FRAMES, n_frames)
        return max(1, min(by_mem, _MAX_BLOCK_FRAMES, n_frames))

    def _pick_chunk(self, height: int, width: int, n_items: int, item_frames: int,
                    route: str, extra_bytes: int = 0) -> int:
        """Independent items per chunk: images, or whole clips whose padded
        windows hold ``item_frames`` frames.  As many as ``block_frames``
        frames hold, or half of the free device memory at the route's bytes
        per pixel-frame plus ``extra_bytes``, up to ``_MAX_CHUNK_FRAMES``
        frames.  0 when one clip's window does not fit: each clip then
        streams.  Raises when not even one frame fits.  Call it after the
        fixed-gaze tables are built."""
        if self.block_frames is not None:
            frames = max(1, int(self.block_frames))
        else:
            per_px = _BLOCK_BYTES_PER_PX_FRAME[route] + extra_bytes
            frames = self._frames_by_memory(height, width, per_px)
            if frames is None:
                frames = _MAX_CHUNK_FRAMES
            elif frames < 1:
                free = self._free_device_bytes()
                raise RuntimeError(
                    f"one {width}x{height} frame pair needs "
                    f"{per_px * height * width / 2**30:.2f} GiB on the {route!r} route "
                    f"({per_px} B per pixel-frame), over half of the card's free memory "
                    f"({free / 2**30:.2f} GiB)")
        return min(n_items, min(frames, _MAX_CHUNK_FRAMES) // item_frames)

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
        is foveated, but an (N, 2) array shorter than the video is refused
        either way, as the JAX package refuses it."""
        if mesh is not None:
            raise _unsupported("mesh", "queue 1 item 7")
        if checkpoint_path is not None:
            raise _unsupported("checkpoint_path", "queue 1 item 5")
        height, width, N_frames = vid_source.get_video_size()

        if fixation_point is None:
            fixation_point = np.array([width // 2, height // 2])
        fixation_point = np.asarray(fixation_point, dtype=np.float32)
        if fixation_point.ndim == 2 and fixation_point.shape[0] < N_frames:
            raise RuntimeError(
                f"fixation_point has {fixation_point.shape[0]} per-frame "
                f"rows but the video has {N_frames} frames; pass one (x, y) "
                f"point or at least one row per frame")
        fov_tables = None
        gaze = None                  # (N_frames, 2) tensor: the moving route
        core = self._get_core(width, height)
        route = core.route
        if self.foveated:
            if fixation_point.ndim == 2 and fixation_point.shape[1] == 2:
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

        def on_device(pair):
            # a per-frame source may give its frames on another device
            return tuple(x.to(self.device, torch.float32) for x in pair)

        def block(start, count):
            return on_device(vid_source.get_luminance_block(start, count))

        if N_frames == 1:
            t, r = block(0, 1)
            Q_per_ch, heat = core.score_image(t[0], r[0], fov_tables, gaze)
            keep(heat)
        elif not self.do_temporal_channels:
            # the ablation (fovvideovdp_tpu/fvvdp.py:389-430): every frame
            # scored as an independent image, so no temporal kernel runs and
            # the transient rows are exactly 0
            staged = vid_source.host_block_bytes(1)
            chunk = self._pick_chunk(height, width, N_frames, 1, route,
                                     _IMAGE_STACK_BYTES + -(-staged // (height * width)))
            if staged:
                # frames streamed from the host: the prefetched next chunk is
                # on the card (counted above) and each chunk passes through a
                # pinned buffer, so chunks stay a streamed block's size
                chunk = min(chunk, _MAX_BLOCK_FRAMES)
            Q_per_ch = core.score_frame_pairs(block, N_frames, chunk, fov_tables, gaze, keep)
        else:
            fps = vid_source.get_frames_per_second()
            fl = temporal_ops.filter_len_for_fps(fps)
            taps = torch.as_tensor(temporal_ops.temporal_filters(
                fps, fl, self.sustained_sigma, self.sustained_beta), device=self.device)
            Q_per_ch = core.score_video(
                block, lambda idx: on_device(vid_source.get_indexed_luminance_block(idx)),
                N_frames, taps, temporal_ops.padding_indices(N_frames, fl, self.temp_padding),
                self._pick_block_size(height, width, N_frames, route), fov_tables, gaze, keep)

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
    # batches of independent pairs
    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict_batch(self, test_conts, reference_conts, dim_order="BCFHW",
                      frames_per_second=0, mesh=None, fixation_point=None):
        """Score a batch of N test/reference pairs on the card, a chunk of
        pairs at a time (``fovvideovdp_tpu/fvvdp.py:953-1163``, which
        replaces the reference's job farming, ``benchmark_cluster.sh``).

        Inputs follow ``predict``'s conventions with a batch axis: any
        ``dim_order`` that holds "B".  A batch on the host goes up whole
        when it fits the array source's residency limit, else a chunk at a
        time.  Images are scored as independent frames; clips are filtered
        whole (padded by ``temp_padding``) and scored a chunk of clips at a
        time, or streamed one by one when a clip does not fit the card.
        Chunks are sized from the card's free memory.  Foveated gaze: one
        (x, y) ``fixation_point`` shared by all pairs (the default: the
        centre; its per-pixel tables are built once), (N, 2) per pair, or
        (N, F, 2) per frame (both on the moving-gaze route).  As in the JAX
        package, ``do_temporal_channels`` is not read, and no heatmap is
        made.  ``mesh`` (several cards) is not ported yet.

        Returns (Q_JOD (N,) np.ndarray, stats): "width", "height",
        "N_frames", "N_pairs", "frames_per_second", and for clips
        "Q_per_ch" (n_bands, 2, N, F)."""
        if mesh is not None:
            raise _unsupported("mesh", "queue 1 item 7")
        gaze_mode = None  # None | "tables" (one shared point) | "per_pair"
        if self.foveated:
            if self.content_mapping is not None:
                raise RuntimeError("predict_batch does not support foveated content mapping")
            fp = np.asarray([0, 0] if fixation_point is None else fixation_point,
                            dtype=np.float32)
            if fp.ndim == 1 and fp.shape[0] == 2:
                gaze_mode = "tables"
            elif fp.ndim in (2, 3) and fp.shape[-1] == 2:
                gaze_mode = "per_pair"
            else:
                raise RuntimeError("fixation_point must be (x, y) shared by all pairs, "
                                   "(N, 2) per pair, or (N, F, 2) per frame")
        if "B" not in dim_order.upper():
            raise RuntimeError("predict_batch needs a batch axis; include 'B' in dim_order")
        pairs = PairBatch(test_conts, reference_conts, dim_order, frames_per_second,
                          self.display_photometry, rgb_to_y(self.color_space), self.device)
        N, _, F, H, W = pairs.shape

        core = self._get_core(W, H, with_heatmap=False)
        route = core.route
        fov_tables = gaze = None
        if gaze_mode == "tables":
            if fixation_point is None:
                fp = np.asarray([W // 2, H // 2], dtype=np.float32)
            fov_tables = core.fov_tables((float(fp[0]), float(fp[1])))
        elif gaze_mode == "per_pair":
            if fp.shape[0] != N:
                raise RuntimeError(f"fixation_point has {fp.shape[0]} rows for {N} pairs")
            # a row per output frame of each pair
            gaze_b = np.broadcast_to(fp[:, None, :] if fp.ndim == 2 else fp, (N, F, 2))
            core.drop_fov_tables()
            gaze = torch.as_tensor(np.array(gaze_b, dtype=np.float32), device=self.device)
            route = "moving" if core.moving_route == "banded" else "composed"
        stats = {"width": W, "height": H, "N_frames": F, "N_pairs": N,
                 "frames_per_second": frames_per_second}
        if F == 1:
            chunk = self._pick_chunk(H, W, N, 1, route, _IMAGE_STACK_BYTES)
            jods = make_batch_scorer(core, pairs, chunk, self.parameters, fov_tables,
                                     None if gaze is None else gaze[:, 0])
        else:
            fl = temporal_ops.filter_len_for_fps(frames_per_second)
            filt = temporal_ops.temporal_filters(frames_per_second, fl,
                                                 self.sustained_sigma, self.sustained_beta)
            chunk = self._pick_chunk(H, W, N, F + fl - 1, route)
            block = 0 if chunk else self._pick_block_size(H, W, F, route)
            jods, Q_per_ch = make_batch_video_scorer(core, pairs, filt, self.parameters, chunk,
                                                     block, self.temp_padding, fov_tables, gaze)
            stats["Q_per_ch"] = Q_per_ch.cpu().numpy()
        return jods.cpu().numpy(), stats

    # ------------------------------------------------------------------
    # differentiable path (the metric as a training loss)
    # ------------------------------------------------------------------
    def _traced_input(self, x, dim_order: str) -> torch.Tensor:
        """A tensor keeps its graph and must be on the metric's device; an
        array goes there.  Either becomes float32 in BCFHW."""
        if torch.is_tensor(x):
            dev = self.device
            if dev.type == "cuda" and dev.index is None:    # "cuda": the current card
                dev = torch.device("cuda", torch.cuda.current_device())
            if x.device != dev:
                raise RuntimeError(f"predict_traced: the input is on {x.device}, the "
                                   f"metric on {self.device}")
            x = x.to(torch.float32)
        else:
            x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)
        return reshuffle_dims(x, dim_order, "BCFHW")

    def predict_traced(self, test_cont, reference_cont, dim_order="BCFHW",
                       frames_per_second=0, fixation_point=None) -> torch.Tensor:
        """JOD of a whole clip in one autograd graph: differentiable with
        respect to both inputs.  Returns a 0-d tensor on the metric's device.

        Unlike ``predict``, which streams blocks under ``torch.no_grad``,
        the clip is filtered and scored at once.  Inputs are
        display-encoded floats (luminance when the photometry is absolute);
        a tensor must lie on the metric's device.  ``use_checkpoints``
        recomputes the spatial scoring in the backward
        (``torch.utils.checkpoint``) instead of keeping its graph, as the
        JAX package wraps it in ``jax.checkpoint``.  When foveated, the
        fixation point (the centre by default; one (x, y) point, or one row
        per frame) is a gaze per frame, scored on the moving-gaze route."""
        x_t = self._traced_input(test_cont, dim_order)
        x_r = self._traced_input(reference_cont, dim_order)
        B, C, F, H, W = x_t.shape
        if B != 1:
            raise RuntimeError("predict_traced supports batch size 1; "
                               "use predict_batch for batches of pairs")
        if F > 1 and frames_per_second <= 0:
            raise RuntimeError(
                "When passing video sequences, you must set 'frames_per_second' parameter")
        rgb2y = rgb_to_y(self.color_space)

        def to_lum(x):                                       # (F, H, W)
            if C == 3:
                return channels_to_luminance(lambda c: x[0, c], self.display_photometry,
                                             rgb2y)
            return self.display_photometry.forward(x[0, 0])

        lum_t, lum_r = to_lum(x_t), to_lum(x_r)
        core = self._get_core(W, H)
        gaze = None
        if self.foveated:
            if fixation_point is None:
                fixation_point = np.array([W // 2, H // 2])
            fp = np.asarray(fixation_point, np.float32)
            gaze = torch.tensor(np.broadcast_to(
                fp.reshape(-1, 2)[-1:] if fp.ndim == 1 else fp, (F, 2)), device=self.device)

        score = core.score_frames
        if self.use_checkpoints:
            score = functools.partial(torch.utils.checkpoint.checkpoint, core.score_frames,
                                      use_reentrant=False)
        if F == 1:
            Q_per_ch, _ = score(torch.stack([lum_t[0], lum_r[0]], dim=0)[None], 1,
                                None, gaze)
        else:
            fl = temporal_ops.filter_len_for_fps(frames_per_second)
            taps = torch.as_tensor(temporal_ops.temporal_filters(
                frames_per_second, fl, self.sustained_sigma, self.sustained_beta),
                device=self.device)
            idx = torch.as_tensor(temporal_ops.padding_indices(F, fl, self.temp_padding),
                                  dtype=torch.int64, device=self.device)
            # the whole padded clip is the window: the kernel's carry is empty
            empty = lum_t.new_empty((0, H, W))
            R = temporal_ops.temporal_channels_pair(empty, lum_t[idx], empty, lum_r[idx],
                                                    taps)
            Q_per_ch, _ = score(R, 2, None, gaze)
        return self.do_pooling_and_jods(Q_per_ch)

    def loss(self, test_cont, reference_cont, **kwargs) -> torch.Tensor:
        """Differentiable training loss: 10 - Q_JOD (0 when imperceptible)."""
        return 10.0 - self.predict_traced(test_cont, reference_cont, **kwargs)

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

    def write_features_to_json(self, stats: dict, dest_fname: str):
        """Per-band, per-channel, per-frame features for retraining the
        metric (``fovvideovdp_tpu/fvvdp.py:1283-1295``)."""
        Q_per_ch = stats["Q_per_ch"]  # [bb, cc, ff]
        fmap = {}
        for key, value in stats.items():
            if key not in ("Q_per_ch", "heatmap"):
                fmap[key] = value.tolist() if isinstance(value, np.ndarray) else value
        for cc in range(Q_per_ch.shape[1]):
            for bb in range(Q_per_ch.shape[0]):
                fmap[f"t{cc}_b{bb}"] = Q_per_ch[bb, cc, :].tolist()
        with open(dest_fname, "w", encoding="utf-8") as f:
            json.dump(fmap, f, ensure_ascii=False, indent=4)

    def get_info_string(self):
        standard_str = f", ({self.display_name})" \
            if self.display_name.startswith("standard_") else ""
        return '"FovVideoVDP v{}, {:.4g} [pix/deg], Lpeak={:.5g}, Lblack={:.4g} [cd/m^2], {}{}"'.format(
            self.version, self.pix_per_deg,
            self.display_photometry.get_peak_luminance(),
            self.display_photometry.get_black_level(),
            "foveated" if self.foveated else "non-foveated", standard_str)
