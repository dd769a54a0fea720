"""FovVideoVDP metric: public API.

Counterpart of ``fovvideovdp_tpu/fvvdp.py:68-213`` (constructor, config,
display, cores), ``predict``, ``predict_video_source`` (image branch, the
streaming loop, the ``do_temporal_channels=False`` ablation, foveation with
a fixed or a per-frame gaze, heatmaps on the host or the device),
``predict_batch`` (``:953-1163``), scoring over a mesh of devices and
processes (``mesh=``, ``:282-286,441-443,497-505,1014-1160``), the differentiable
``predict_traced`` and ``loss`` (``:1165-1242``), ``do_pooling_and_jods`` and
``write_features_to_json`` (``:1283-1295``), checkpoint and resume of the
streaming loop (``:452-562,606-634``) and ``update_device``, with the
MATLAB core's ablations and options (``local_adapt``, ``contrast="log"``,
the masking ablations, ``pu_dilate``, ``ignore_boundary_pixels``,
``band_callback``, ``content_mapping``) wherever the JAX package takes
them.  The default
device is the CUDA card; ``device="cpu"`` runs every kernel's plain version
instead.

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
import os
import zlib
from typing import Dict

import numpy as np
import torch
import torch.utils.checkpoint

from fovvideovdp_tpu_torch import memory, utils
from fovvideovdp_tpu_torch.core import MetricCore, card
from fovvideovdp_tpu_torch.csf import CSFCache
from fovvideovdp_tpu_torch.display_model import (fvvdp_display_geometry,
                                                 fvvdp_display_photometry)
from fovvideovdp_tpu_torch.ops import masking as mask_ops
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops
from fovvideovdp_tpu_torch.ops.pyramid import PyramidPlan
from fovvideovdp_tpu_torch.parallel import multihost
from fovvideovdp_tpu_torch.parallel.sharding import (make_batch_scorer, make_batch_video_scorer,
                                                     make_mesh, replicas, score_video_mesh,
                                                     shard_image_fn, split_rows,
                                                     tables_on_cards)
from fovvideovdp_tpu_torch.ops.cuda.luminance import channels_to_luminance
from fovvideovdp_tpu_torch.tracing import span
from fovvideovdp_tpu_torch.video_source import (PairBatch, fvvdp_video_source_array,
                                                reshuffle_dims, resolve_device, rgb_to_y)

HEATMAP_TYPES = ("raw", "threshold", "supra-threshold", "monochromatic")


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
        # research and ablation options of the MATLAB core
        # (matlab/fvvdp_core.m:60-77): each sends the core to the composed
        # route, as in the JAX package
        self.ignore_boundary_pixels = bool(ignore_boundary_pixels)
        # called as band_callback(band, n_bands, channel, T, R, N_nCSF) with
        # CPU tensors, once per band and temporal channel of each block
        self.band_callback = band_callback
        # e.g. content_mapping.fvvdp_content_mapping_equirect; read only when
        # foveated, where a fixation point then becomes a gaze per frame
        self.content_mapping = content_mapping
        # predict_traced recomputes the spatial scoring in the backward
        # instead of keeping its graph (torch.utils.checkpoint)
        self.use_checkpoints = bool(use_checkpoints)

        self.set_display_model(display_name, display_photometry=display_photometry,
                               display_geometry=display_geometry)
        self.load_config(parameter_overrides)
        self.csf_cache = CSFCache(self.device)   # .npz, then .mat caches, then generated
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
        self._drop_cores()

    def _drop_cores(self) -> None:
        for core in self._cores.values():
            core.drop_fov_tables()
        self._cores = {}

    def update_device(self, device) -> None:
        """Run on ``device`` from now on: resolved as the constructor resolves
        it (``"cuda"`` without a card raises).  The LUTs move there, the CSF
        cache starts anew there, and every core is dropped with its tables
        (the JAX package only stores the device, ``fovvideovdp_tpu/fvvdp.py:177``)."""
        self.device = resolve_device(device)
        self.csf_cache = CSFCache(self.device, self.csf_cache.extra_dirs)
        self._luts = tuple({k: v.to(self.device) if torch.is_tensor(v) else v
                            for k, v in lut.items()} for lut in self._luts)
        self._drop_cores()

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
        """Predict quality for arrays.  Returns (Q_JOD, stats).  ``mesh``
        (``parallel.make_mesh``): stream one video over several devices,
        each block's frames split over the mesh's slots (see
        ``predict_video_source``)."""
        test_vs = fvvdp_video_source_array(
            test_cont, reference_cont, frames_per_second, dim_order=dim_order,
            display_photometry=self.display_photometry,
            color_space_name=self.color_space, device=self.device)
        return self.predict_video_source(test_vs, fixation_point=fixation_point, mesh=mesh)

    def _get_core(self, width: int, height: int, with_heatmap: bool = True) -> MetricCore:
        """The core of this resolution and of the attributes a core is built
        from, keyed as the JAX package keys them
        (``fovvideovdp_tpu/fvvdp.py:198-199``); ``with_heatmap=False``: the
        core of the same metric without a heatmap, which scores on the
        kernels' routes (predict_batch returns no heatmap).  Building one
        frees the fixed-gaze tables of the other cores of the resolution,
        so that at most one table set per resolution stays on the card."""
        heatmap = self.heatmap if with_heatmap else None
        key = (width, height, self.foveated, heatmap, self.heatmap_dtype,
               self.ignore_boundary_pixels)
        if key not in self._cores:
            for other, core in self._cores.items():
                if other[:2] == (width, height):
                    core.drop_fov_tables()
            plan = PyramidPlan(width, height, self.pix_per_deg)
            try:
                peak = float(self.display_photometry.get_peak_luminance())
            except Exception:
                peak = None   # custom photometry without a peak: trim bottom only
            self._cores[key] = MetricCore(
                plan, self.parameters, self._luts, self.device, peak_luminance=peak,
                geometry=self.display_geometry, foveated=self.foveated,
                heatmap=heatmap, heatmap_dtype=self.heatmap_dtype,
                content_mapping=self.content_mapping,
                ignore_boundary_pixels=self.ignore_boundary_pixels,
                band_callback=self.band_callback)
        return self._cores[key]

    @torch.no_grad()
    def predict_video_source(self, vid_source, fixation_point=None, mesh=None,
                             checkpoint_path=None, checkpoint_every=8):
        """Score a video source.  ``fixation_point``: one (x, y) point in
        pixels (the centre of the frame by default), or an (N, 2) array with
        one row per frame for a moving gaze; it matters only when the metric
        is foveated, but an (N, 2) array shorter than the video is refused
        either way, as the JAX package refuses it.

        ``checkpoint_path``: every ``checkpoint_every`` blocks of a streamed
        video, the scored ``Q_per_ch``, the position and the fl-1 carried
        frames are written there (atomically), so that a run killed
        mid-video resumes where it stopped.  A file whose fingerprint (the
        video's size and first frame, the configuration, the gaze) does not
        match is ignored; the file is removed on completion.  Refused with a
        heatmap and for a source without random access; an image and the
        ``do_temporal_channels=False`` ablation score without one.

        ``mesh`` (``parallel.make_mesh``): each streamed block's frames are
        split over the mesh's slots, each slot filtering and scoring its
        frames with the fl-1 frames before them on its card (fixed-gaze
        tables are built on every card; a gaze per frame is split with its
        frames); ``Q_per_ch`` and the heatmap are gathered in frame order on
        the metric's device (a ``device_heatmap`` too).  An array source's
        slots each convert their own frames and halo on their own card;
        another source's blocks are read on the metric's device and each
        slot's frames copied from there.  A checkpoint works as without a
        mesh.  A mesh of one device is no mesh.  A lone image is scored on
        the mesh's first slot when its 'space' axis is 1, and split by rows
        over the slots of its first 'data' row when 'space' > 1, each slot
        scoring its strip of every level (``parallel.shard_image_fn``); a
        foveated lone image and the ``do_temporal_channels=False`` ablation
        are refused under a mesh, as the JAX package refuses them."""
        with span("fvvdp.predict_video_source"):
            height, width, N_frames = vid_source.get_video_size()
            if mesh is not None and mesh.size == 1:
                mesh = None    # one device: the one-device path (fovvideovdp_tpu/fvvdp.py:283-286)
            if mesh is not None and N_frames == 1 and self.foveated:
                # refusing beats a silent fall back to one of the devices
                raise RuntimeError(
                    "predict(mesh=...) does not shard single foveated "
                    "images; score it without a mesh, or shard many "
                    "foveated images with predict_batch(mesh=...)")
            if mesh is not None and N_frames > 1 and not self.do_temporal_channels:
                raise RuntimeError(
                    "predict(mesh=...) does not shard the "
                    "do_temporal_channels=False ablation path; run it "
                    "without a mesh (a silent single-device fallback would "
                    "waste the requested hardware)")

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
            point = None                 # a fixed fixation point: tables
            core = self._get_core(width, height)
            if self.foveated and fixation_point.shape == (2,) \
                    and self.content_mapping is not None:
                # the mapping's eccentricity depends on the gaze: no tables are
                # built, the point is a gaze per frame (fovvideovdp_tpu/fvvdp.py:298-303)
                fixation_point = np.broadcast_to(fixation_point, (N_frames, 2))
            if self.foveated:
                if fixation_point.ndim == 2 and fixation_point.shape[1] == 2:
                    # this route reads no fixed-gaze tables; an earlier call may
                    # have left GB of them on the card
                    core.drop_fov_tables()
                    gaze = torch.as_tensor(np.array(fixation_point[:N_frames]), device=self.device)
                elif fixation_point.shape == (2,):
                    point = (float(fixation_point[0]), float(fixation_point[1]))
                    # under a mesh, built on each card below
                    fov_tables = core.fov_tables(point) if mesh is None else None
                else:
                    raise ValueError(
                        f"fixation_point must be one (x, y) point or an (N, 2) array of "
                        f"per-frame points, got shape {fixation_point.shape}")
            per_px = core.bytes_per_px_frame(gaze is not None)
            plan = core.plan
            if self.do_heatmap and self.device_heatmap:
                memory.check_heatmap_budget(self.device, N_frames,
                                            1 if self.heatmap == "raw" else 3, height, width,
                                            self.heatmap_dtype)
            heat_blocks = []   # (b, c, H, W) per block: tensors, or arrays on the host

            def keep(heat):
                if heat is not None:
                    heat_blocks.append(heat if self.device_heatmap else heat.cpu().numpy())

            def on_device(pair):
                # a per-frame source may give its frames on another device; log
                # contrast scores log10 luminance
                return tuple(self._encode(x.to(self.device, torch.float32)) for x in pair)

            def block(start, count):
                with span("fvvdp.luminance"):
                    return on_device(vid_source.get_luminance_block(start, count))

            if checkpoint_path and (N_frames == 1 or not self.do_temporal_channels):
                logging.warning("checkpoint_path applies to the streaming video "
                                "path only; ignored for this input")
            if N_frames == 1:
                t, r = block(0, 1)
                if mesh is not None:
                    Q_per_ch, heat = shard_image_fn(core, mesh)(t[0], r[0])
                else:
                    Q_per_ch, heat = core.score_image(t[0], r[0], fov_tables, gaze)
                keep(heat)
            elif not self.do_temporal_channels:
                # the ablation (fovvideovdp_tpu/fvvdp.py:389-430): every frame
                # scored as an independent image, so no temporal kernel runs and
                # the transient rows are exactly 0
                staged = vid_source.host_block_bytes(1)
                chunk = memory.chunk_items(
                    height, width, N_frames, 1,
                    core.bytes_per_px_frame(gaze is not None, images=True)
                    + -(-staged // (height * width)), self.device, block_frames=self.block_frames)
                if staged:
                    # frames streamed from the host: the prefetched next chunk is
                    # on the card (counted above) and each chunk passes through a
                    # pinned buffer, so chunks stay a streamed block's size
                    chunk = min(chunk, memory.MAX_BLOCK_FRAMES)
                Q_per_ch = core.score_frame_pairs(block, N_frames, chunk, fov_tables, gaze, keep)
            else:
                fps = vid_source.get_frames_per_second()
                fl = temporal_ops.filter_len_for_fps(fps)
                taps = torch.as_tensor(temporal_ops.temporal_filters(
                    fps, fl, self.sustained_sigma, self.sustained_beta), device=self.device)
                # the raw frames of the next block, which a host-resident source
                # prefetches onto the card while this one is scored
                staged = -(-vid_source.host_block_bytes(1) // (height * width))
                resume = {}
                if checkpoint_path:
                    resume = self._checkpointing(vid_source, checkpoint_path, checkpoint_every,
                                                 core, fl, fps, fixation_point)
                def indexed(idx):
                    with span("fvvdp.luminance"):
                        return on_device(vid_source.get_indexed_luminance_block(idx))

                pad_idx = temporal_ops.padding_indices(N_frames, fl, self.temp_padding)
                if mesh is None:
                    B = memory.block_size(height, width, N_frames, per_px + staged, self.device,
                                          block_frames=self.block_frames)
                    Q_per_ch = core.score_video(block, indexed, N_frames, taps, pad_idx, B,
                                                fov_tables, gaze, keep, **resume)
                else:
                    tables = None if point is None else tables_on_cards(core, mesh, point)
                    frames_at = None
                    if vid_source.luminance_at is not None:
                        def frames_at(idx, dev):
                            with span("fvvdp.luminance"):
                                return tuple(self._encode(x.to(dev, torch.float32))
                                             for x in vid_source.luminance_at(idx, dev))
                    B = memory.mesh_block_size(height, width, N_frames, per_px + staged, mesh,
                                               self.block_frames)
                    Q_per_ch = score_video_mesh(mesh, core, block, indexed, N_frames, taps, pad_idx,
                                                B, tables, gaze, keep, frames_at=frames_at,
                                                **resume)
                if checkpoint_path and os.path.isfile(checkpoint_path):
                    os.remove(checkpoint_path)

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
    # checkpoint and resume of the streaming loop
    # ------------------------------------------------------------------
    def _checkpointing(self, vid_source, path: str, every: int, core: MetricCore, fl: int,
                       fps: float, fixation_point: np.ndarray) -> Dict:
        """The arguments of ``MetricCore.score_video`` that resume from the
        checkpoint at ``path`` (when it matches this video and
        configuration) and save one every ``every`` blocks."""
        if self.do_heatmap:
            raise RuntimeError("checkpoint_path is not supported together "
                               "with heatmaps")
        if not vid_source.supports_random_access():
            raise RuntimeError(
                "checkpoint/resume needs a random-access video source "
                "(resuming must skip already-scored frames): use "
                "preload=True, a .yuv file, or array input")
        height, width, N_frames = vid_source.get_video_size()
        pad_code = {"replicate": 0, "circular": 1, "pingpong": 2}[self.temp_padding]
        # the first frame's luminance folds in the pixels, the photometry and
        # the colour space; the block size is left out, since it follows the
        # card's free memory, which another process may hold
        p_t, p_r = vid_source.get_luminance_block(0, 1)
        probe = np.float64(float(p_t.double().sum()) + 2.0 * float(p_r.double().sum()))
        cfg_crc = zlib.crc32(json.dumps(self.parameters, sort_keys=True).encode())
        gaze_crc = zlib.crc32(np.ascontiguousarray(fixation_point, np.float32).tobytes())
        fingerprint = np.asarray(
            [height, width, N_frames, fl, pad_code, int(round(fps * 1000)),
             int(round(self.pix_per_deg * 1e3)), int(self.foveated),
             int(self.contrast == "log"), cfg_crc, gaze_crc,
             int(self.content_mapping is not None), probe.view(np.int64)], np.int64)
        resume = {}
        state = self._load_checkpoint(path, fingerprint, (core.plan.height, 2),
                                      (fl - 1, height, width), N_frames)
        if state is not None:
            pos, Q_done, carry_t, carry_r = state
            Q = torch.empty((core.plan.height, 2, N_frames), dtype=torch.float32,
                            device=self.device)
            Q[:, :, :pos] = torch.as_tensor(Q_done, device=self.device)
            resume = dict(start=pos, Q=Q, carry=tuple(
                torch.as_tensor(c, device=self.device).contiguous() for c in (carry_t, carry_r)))
        blocks = [0]

        def after_block(pos, Q, carry):
            blocks[0] += 1
            if pos < N_frames and blocks[0] % max(1, every) == 0:
                self._save_checkpoint(path, fingerprint, pos, Q, *carry())
        return dict(resume, after_block=after_block)

    @staticmethod
    def _load_checkpoint(path: str, fingerprint: np.ndarray, q_shape, carry_shape,
                         n_frames: int):
        """(pos, Q_per_ch of frames 0..pos-1, carry_t, carry_r) as host
        arrays, saved by :meth:`_save_checkpoint`; None to start afresh: no
        file, a file of another video or configuration, or one that cannot
        be read."""
        if not os.path.isfile(path):
            return None
        try:
            with np.load(path) as d:
                if not np.array_equal(d["fingerprint"], fingerprint):
                    logging.warning(f"checkpoint '{path}' belongs to a different "
                                    f"video/configuration; starting fresh")
                    return None
                pos = int(d["pos"])
                Q_done, carry_t, carry_r = (np.asarray(d[k], dtype=np.float32)
                                            for k in ("Q_per_ch", "carry_t", "carry_r"))
            if not 0 < pos < n_frames or Q_done.shape != tuple(q_shape) + (pos,) \
                    or carry_t.shape != carry_shape or carry_r.shape != carry_shape:
                raise ValueError(f"position {pos}, Q_per_ch {Q_done.shape}, carries "
                                 f"{carry_t.shape} and {carry_r.shape}")
        except Exception as e:   # a truncated or corrupt file: score from scratch
            logging.warning(f"could not read checkpoint '{path}' ({e}); starting fresh")
            return None
        logging.info(f"resuming from checkpoint '{path}' at frame {pos}")
        return pos, Q_done, carry_t, carry_r

    @staticmethod
    def _save_checkpoint(path: str, fingerprint: np.ndarray, pos: int, Q: torch.Tensor,
                         carry_t: torch.Tensor, carry_r: torch.Tensor) -> None:
        """Q_per_ch of frames 0..pos-1 and the carried frames (log10-encoded
        under log contrast, as the loop carries them) to ``path``, through a
        temporary file and a rename."""
        tmp = path + ".tmp.npz"      # np.savez appends .npz to any other name
        np.savez(tmp, fingerprint=fingerprint, pos=np.int64(pos),
                 Q_per_ch=Q[:, :, :pos].cpu().numpy(), carry_t=carry_t.cpu().numpy(),
                 carry_r=carry_r.cpu().numpy())
        os.replace(tmp, path)

    def _encode(self, lum: torch.Tensor) -> torch.Tensor:
        """Luminance as the core scores it: log10 of it, clipped at 1e-6,
        under log contrast (``fovvideovdp_tpu/fvvdp.py:338-342``); else as
        it is."""
        return torch.log10(utils.clip(lum, 1e-6)) if self.contrast == "log" else lum

    # ------------------------------------------------------------------
    # batches of independent pairs
    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict_batch(self, test_conts, reference_conts, dim_order="BCFHW",
                      frames_per_second=0, mesh=None, fixation_point=None):
        """Score a batch of N test/reference pairs, a chunk of pairs at a
        time (``fovvideovdp_tpu/fvvdp.py:953-1163``, which replaces the
        reference's job farming, ``benchmark_cluster.sh``).

        Inputs follow ``predict``'s conventions with a batch axis: any
        ``dim_order`` that holds "B".  A batch on the host goes up whole
        when it fits the array source's residency limit, else a chunk at a
        time.  Images are scored as independent frames; clips are filtered
        whole (padded by ``temp_padding``) and scored a chunk of clips at a
        time, or streamed one by one when a clip does not fit the card.
        Chunks are sized from the card's free memory.  Foveated gaze: one
        (x, y) ``fixation_point`` shared by all pairs (the default: the
        centre; its per-pixel tables are built once per card), (N, 2) per
        pair, or (N, F, 2) per frame (both on the moving-gaze route).  As in
        the JAX package, ``do_temporal_channels`` is not read, and no
        heatmap is made.

        ``mesh`` (``parallel.make_mesh``): the pairs are split in contiguous
        row blocks over the mesh's slots; each slot's rows go from the
        caller straight to its card and are scored there, and the results
        are gathered in pair order.  ``mesh=None`` follows the JAX package
        ("all devices by default") where the metric's device is the
        unindexed "cuda": every visible card (this process's cards after
        ``parallel.init_multihost``); a metric built for "cuda:N" or "cpu"
        keeps its one device.  In a run of several processes
        (``parallel.init_multihost``) every process passes its own pairs,
        the same count on each, and gets back its own rows, the results
        gathered over the process group first; ``stats["n_processes"]``
        counts them.

        Returns (Q_JOD (N,) np.ndarray, stats): "width", "height",
        "N_frames", "N_pairs", "frames_per_second", and for clips
        "Q_per_ch" (n_bands, 2, N, F)."""
        with span("fvvdp.predict_batch"):
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
            N, _, F, H, W = PairBatch.batch_shape(test_conts, reference_conts, dim_order,
                                                  frames_per_second)
            n_proc = multihost.process_count()
            if n_proc > 1:
                # unequal counts would misplace the gathered rows: checked first,
                # in the JAX package's words (fovvideovdp_tpu/fvvdp.py:1047-1057)
                multihost.local_batch_to_global(N)
            if mesh is None and self.device.type == "cuda" and self.device.index is None:
                mesh = make_mesh()
            if mesh is not None and mesh.size == 1 and card(mesh.slots[0]) == card(self.device):
                mesh = None
            pairs = None
            if mesh is None:
                pairs = PairBatch(test_conts, reference_conts, dim_order, frames_per_second,
                                  self.display_photometry, rgb_to_y(self.color_space),
                                  self.device, encode=self._encode)

            core = self._get_core(W, H, with_heatmap=False)
            fov_tables = gaze = None
            if gaze_mode == "tables":
                if fixation_point is None:
                    fp = np.asarray([W // 2, H // 2], dtype=np.float32)
                point = (float(fp[0]), float(fp[1]))
                fov_tables = core.fov_tables(point) if mesh is None \
                    else tables_on_cards(core, mesh, point)
            elif gaze_mode == "per_pair":
                if fp.shape[0] != N:
                    raise RuntimeError(f"fixation_point has {fp.shape[0]} rows for {N} pairs")
                # a row per output frame of each pair
                gaze_b = np.broadcast_to(fp[:, None, :] if fp.ndim == 2 else fp, (N, F, 2))
                core.drop_fov_tables()
                gaze = torch.as_tensor(np.array(gaze_b, dtype=np.float32), device=self.device)
            stats = {"width": W, "height": H, "N_frames": F, "N_pairs": N,
                     "frames_per_second": frames_per_second}
            if mesh is None:
                jods, Q_per_ch = self._score_pairs(core, pairs, fov_tables, gaze)
            else:
                jods, Q_per_ch = self._score_pairs_on_mesh(
                    mesh, core, test_conts, reference_conts, dim_order, frames_per_second, N,
                    fov_tables, gaze)
            jods = jods.cpu()
            if n_proc > 1:
                # every process's rows gathered over the group, then this one's
                rows = torch.as_tensor(multihost.local_row_positions(N * n_proc))
                jods = multihost.replicate_to_hosts(jods)[rows]
                if Q_per_ch is not None:
                    Q_per_ch = multihost.replicate_to_hosts(Q_per_ch, axis=2)[:, :, rows]
                stats["n_processes"] = n_proc
            if Q_per_ch is not None:
                stats["Q_per_ch"] = Q_per_ch.cpu().numpy()
            return jods.numpy(), stats

    def _score_pairs(self, core: MetricCore, pairs, fov_tables, gaze, device=None,
                     slots: int = 1):
        """(JODs (N,), Q_per_ch (n_bands, 2, N, F) of clips or None) of the
        pairs of ``pairs`` on ``device`` (the metric's by default), chunks
        sized from that card's memory shared by ``slots`` slots."""
        N, _, F, H, W = pairs.shape
        per_px = core.bytes_per_px_frame(gaze is not None, images=F == 1)
        mem = dict(device=self.device if device is None else device, slots=slots,
                   block_frames=self.block_frames)
        if F == 1:
            chunk = memory.chunk_items(H, W, N, 1, per_px, **mem)
            return make_batch_scorer(core, pairs, chunk, self.parameters, fov_tables,
                                     None if gaze is None else gaze[:, 0]), None
        fps = pairs.fps
        fl = temporal_ops.filter_len_for_fps(fps)
        filt = temporal_ops.temporal_filters(fps, fl, self.sustained_sigma, self.sustained_beta)
        chunk = memory.chunk_items(H, W, N, F + fl - 1, per_px, **mem)
        block = 0 if chunk else memory.block_size(H, W, F, per_px, **mem)
        return make_batch_video_scorer(core, pairs, filt, self.parameters, chunk, block,
                                       self.temp_padding, fov_tables, gaze)

    def _score_pairs_on_mesh(self, mesh, core: MetricCore, test, reference, dim_order: str,
                             fps, N: int, tables, gaze):
        """``_score_pairs`` over a mesh: slot k takes rows
        ``split_rows(N, mesh.size)[k]``, builds its own ``PairBatch`` of them
        on its card (so neither the raw batch nor its luminance is ever
        whole on one card) and scores them with its card's replica of
        ``core``; the results are gathered on the metric's device in pair
        order.  ``tables``: per card (``tables_on_cards``)."""
        parts = split_rows(N, mesh.size)
        cores = replicas(core, mesh, gaze is not None)
        rgb2y = rgb_to_y(self.color_space)

        def slot_fn(k):
            a, b = parts[k]
            dev = mesh.slots[k]

            def fn():
                pairs = PairBatch(PairBatch.rows(test, dim_order, a, b),
                                  PairBatch.rows(reference, dim_order, a, b), dim_order, fps,
                                  self.display_photometry, rgb2y, dev, encode=self._encode)
                return self._score_pairs(cores[dev], pairs,
                                         None if tables is None else tables[dev],
                                         None if gaze is None else gaze[a:b].to(dev),
                                         dev, mesh.slots_on(dev))
            return fn if b > a else None

        done = [o for o in mesh.run([slot_fn(k) for k in range(mesh.size)]) if o is not None]
        jods = torch.cat([j.to(self.device) for j, _ in done])
        if done[0][1] is None:
            return jods, None
        return jods, torch.cat([q.to(self.device) for _, q in done], dim=2)

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
        with span("fvvdp.predict_traced"):
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

            with span("fvvdp.luminance"):
                lum_t = self._encode(to_lum(x_t))
            with span("fvvdp.luminance"):
                lum_r = self._encode(to_lum(x_r))
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
