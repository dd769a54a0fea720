#!/usr/bin/env python3
"""Smoke run of fovvideovdp_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device: name, power limit; TF32 off for matmuls and cuDNN;
  2. build: compile the kernels of csrc/ with nvcc (sm_90a), timed;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the 4K main path gives it (one video block of the clip below,
     every pyramid level), timed with CUDA events (median of 10), beside
     its bound and, where one exists, a library call computing the same
     function; mov_score with a sweeping gaze on two tables, on one table
     and an offset, on an image, and with the whole LUT in global memory;
     gausspyr_reduce (bit for bit), expand_score2, mov_score and the three
     band scorers on both arms (16-byte loads at the 4K levels; 4-byte loads
     on an odd width, an odd pixel count and views that start off a 16-byte
     boundary), with the registers nvcc -Xptxas -v reported and the SASS
     instructions per pixel(-frame) or output from cuobjdump;
  4. video: fvvdp(display_name="standard_4k").predict on bench.py's clip
     (3840x2160, 60 frames, 30 fps), JOD held to the PyTorch reference's
     9.7688 +- 0.01, warm wall time (median of 3), peak memory, block size
     and the launches of each kernel in that run;
  4b. the same clip with the raw pair kept on the host (residency limit 0):
     the same JOD, its warm wall time and peak memory;
  4c. a source with only the per-frame methods over the same clip: the same
     JOD;
  4d. yuv_file_video: the same clip written as a pair of 8-bit 4:2:0 .yuv
     files (luma the clip's frames, chroma 128) under a temporary directory,
     scored warm through fvvdp_video_source_file (the native reader, pinned
     staging, the conversion on the card), against the array source fed the
     host's float32 decode of the same planes (|dJOD| <= 1e-5); the default
     route's launches; the seconds of reading, uploading, converting and
     scoring apart, and peak memory;
  4e. ffmpeg_pipe_video: the same files through stub ffprobe/ffmpeg
     executables (Python scripts on a temporary PATH) and the native pipe
     reader, the JOD of 4d within 1e-6;
  4f. cli_yuv: run_fvvdp.main on the same files, in-process: the printed JOD
     is 4d's to 4 decimals;
  4g. yuv_10bit_pq_vs_cpu: a 10-bit 4:2:0 BT.2020 1920x1080x8 pair under
     standard_hdr_pq with a bicubic full-screen resize to 3840x2160, card
     against device="cpu" (|dJOD| <= 1e-4);
  4h. packed_array_vs_cpu: the packed YUV source at 1080p x 8 frames, card
     against device="cpu" (|dJOD| <= 1e-4);
  5. image: the first frame pair as a 4K image (reduce and expand_score2
     launch, the temporal kernel does not);
  6. fixed-gaze foveation: the same clip and its first frame through
     fvvdp(foveated=True) (expand_contrast and band_score2_fov launch,
     expand_score2 does not); a 1440x1600 8-frame htc_vive_pro video on
     the card against device="cpu";
  6b. moving-gaze foveation: the clip with a gaze per frame sweeping corner
     to corner (expand_contrast and mov_score launch once per level per
     block, band_score2_fov does not, no table is built); the clip with the
     gaze held at the centre through both foveated routes, in turns; the
     first frame with a (1, 2) gaze; 8 frames with a raw heatmap (composed
     route, mov_score does not launch); the 1440x1600 video with a moving
     gaze against device="cpu";
  7. heatmaps: the 4K image with "threshold" and "raw" maps (the raw map
     against device="cpu"), 8 frames with a "supra-threshold" uint8 map kept
     on the device;
  8. per-channel LUTs: the omega = 5 LUT cut by its last Y knot, the 4K image
     and 8 frames (band_score launches twice per level per block); a 1080p
     clip against device="cpu";
  8b. the differentiable path, each kernel's wrapper behind its
     torch.autograd.Function (the backward recomputes the plain version):
     traced_image (a seeded 4K RGB pair: predict_traced against predict
     within 1e-4 JOD, a finite non-zero gradient, 5 Adam steps lowering the
     loss at every step, forward and forward + backward times, peak memory;
     reduce and expand_score2 launch, the backward launches nothing);
     traced_grad_vs_cpu (a 1080p image and an 8-frame clip under
     standard_fhd: the card's gradient against device="cpu", max |dg| /
     max |g| <= 1e-4); traced_video (16 frames of the 4K clip with and
     without use_checkpoints: the same gradient within 1e-6, temporal_pair
     with an empty carry, reduce and expand_score2 launch, the checkpointed
     scoring twice; times, peaks, the JOD against predict); traced_foveated
     (the 4K image foveated at the centre: expand_contrast and mov_score
     launch; against the CPU at 1080p); torch_loss (fvvdp_torch_loss at
     1080p with grad_ref: 3 Adam steps, the value under no_grad with the
     forward's launches); backward_ms (each Function at the shapes of one
     4K block: the kernel's forward beside the plain VJP's time, its chunk
     of frames and its peak);
  8c. batches of pairs and the do_temporal_channels=False ablation:
     batch_images (64 seeded 512x384 RGB pairs under standard_fhd through
     predict_batch: 8 of them against per-pair predict within 1e-4 JOD;
     warm time and pairs/s beside a loop of predict over the 64; the chunk
     and the peak; reduce and expand_score2 launch once per level per
     chunk, nothing else); batch_clips (3 seeded 1080p clips of 30 frames:
     temporal_pair once per clip with an empty carry, the JODs against
     per-pair predict within 1e-4, the same clips streamed 8 frames at a
     time with their carry, Q_per_ch's shape, warm time); batch_foveated
     (the 64 images with one shared gaze: its tables built once,
     band_score2_fov and not mov_score; with a gaze per pair: mov_score,
     not band_score2_fov, no table; each against per-pair predict);
     ablation_video (the 4K clip with do_temporal_channels=False: the
     transient rows exactly 0, no temporal kernel, warm time);
     batch_vs_cpu (after every timing, which the CPU's threads would slow:
     8 images, the first clip, 8 images in each gaze mode and a 1080p
     8-frame ablation clip against device="cpu" within 1e-4);
     host_resident_batch (the array source's residency limit at 0: the 8
     images in chunks of 3, the first clip whole and streamed, the 1080p
     ablation in one chunk and in chunks of 3, each against the CPU's JODs;
     the 4K ablation streamed from the host in chunks of at most 32 frames
     against its resident run, with its peak);
  8d. the metric's ablations and options and the CSF cache's search order:
     on the 60-frame 4K clip, local_adapt="gpyr2" with contrast="log"
     (gausspyr_reduce and temporal_pair launch, nothing else), the
     contrast_difference_perc_norm masking with pu_dilate=0.5 (and
     expand_contrast, no scorer), ignore_boundary_pixels with an
     equirectangular content mapping, foveated at the centre (expand_contrast,
     no mov_score, no table), and csf_sigma=-2.0 (a generated LUT on the
     default route: expand_score2): the JOD, first and warm wall time, block
     frames, peak bytes per pixel-frame and launches of each; the seconds of
     generating a LUT; then every option group (the five adaptations, log
     contrast, both masking ablations, pu_dilate, ignored boundary pixels,
     the band callback, a content mapping, "simple" with a fixed and a
     moving gaze, a raw heatmap with ignored boundary pixels, csf_sigma,
     k_cm, LUTs read from .mat caches on non-uniform grids) at 960x540x8 on
     the card against device="cpu" (|dJOD| <= 1e-4, 1e-3 foveated), with the
     card's peak bytes per pixel-frame; predict_batch and predict_traced
     under log contrast likewise;
  8e. checkpoint_resume_video (the 4K clip uninterrupted; crashed by its
     source on the fetch after block 0 with a checkpoint after every block;
     resumed: JOD and Q_per_ch bit for bit, no block before the checkpoint
     fetched, reduce, temporal and expand_score2 launched for the remaining
     block only, the file removed; the file's bytes, the save's and the
     load's seconds) and checkpoint_walls (a copy of the file resumed in
     blocks of 16 within rtol 1e-5; warm wall time with a checkpoint after
     every block beside none, in turns); pu_psnr_video (PU21-PSNR of the 4K
     clip on the card against device="cpu" within 1e-3 dB, warm seconds
     and fps, no kernel launched); core_key_sequence (at 1080p: a metric
     whose heatmap dtype, boundary pixels and foveation change between
     calls scores each step as a metric built fresh for it, within 1e-6
     JOD, its heatmap's dtype the same; a replaced core's fixed-gaze
     tables leave the card); update_device (a metric built on the CPU
     moved to the card scores a 1080p clip as a card metric does, within
     1e-6, on the default route); cli_extras (run_fvvdp.main in-process on
     4d's .yuv pair with --metrics fvvdp pu-psnr --checkpoint: both lines,
     the JOD 4d's to 4 decimals, no checkpoint file left);
  8f. scoring over a mesh (parallel.make_mesh) and over processes, on the
     one card: a mesh of two slots on cuda:0 against the same metric without
     a mesh, JOD and Q_per_ch within 1e-6 relative (mesh_video: the 4K clip
     streamed, checked against the reference's JOD too, each slot's
     launches exact, warm walls in turns, the peak, scoring with each slot
     converting its own frames beside the blocks converted on the metric's
     device; mesh_fixed_gaze, mesh_moving_gaze, mesh_heatmap: 8 frames of
     the clip, the heatmap within 2e-3; mesh_batch_images,
     mesh_batch_clips: 64 512x384 pairs and 3 1080p clips through
     predict_batch; mesh_checkpoint_resume: the clip in blocks of 32
     crashed after block 0 and resumed bit for bit, only the second block
     and its halo read); mesh_processes (two processes of this script,
     --mesh-worker, in a gloo group on localhost, each scoring its own 32
     pairs through predict_batch, each JOD within 1e-6 of its solo predict;
     both killed on failure or after their own time limit); with more than
     one card visible, mesh_cards (the clip and 256 pairs on 1, 2 and 4
     cards: JODs, fps, each card's peak);
  9. the kernels line, then the result line.

Every path has its own expectation of which kernels must launch and which
must not; the counts are set to 0 just before it and read just after.

Imports nothing of JAX or of the JAX package.  Exits non-zero without a
CUDA card, and fails at import when the package is not beside it.

To compare two trees on one card, time them in turns, one process after
another:

    python3 chip_smoke.py --time-kernels [--package-root DIR]

builds the kernels of the package under DIR (default: beside this script)
and times gausspyr_reduce, expand_score2, every instance of mov_score and
the three band scorers at the 4K levels of one 32-frame block, and the
array source's build for the 4K clip (median of 3), nothing else; it prints
one JSON line.  DIR may hold an earlier commit's package (git archive) or a
copy with one edit.

    python3 chip_smoke.py --time-upload

times the ways of putting the 4K clip's raw pair on the card in turns (the
pageable copy, the package's staged copy at three chunk sizes, a page-locked
caller buffer), the host transpose of that pair, and the source's build
resident and host-resident; one JSON line.

    python3 chip_smoke.py --traced

runs phases 1, 2 and 8b only (the differentiable path), and prints no
result line;

    python3 chip_smoke.py --batch

runs phases 1, 2 and 8c only (batches and the ablation), and prints no
result line;

    python3 chip_smoke.py --options

runs phases 1, 2 and 8d only (the ablations and options), and prints no
result line;

    python3 chip_smoke.py --extras

runs phases 1, 2 and 8e only (checkpoint and resume, PU21-PSNR, the cores'
key, update_device, the CLI's extras), and prints no result line;

    python3 chip_smoke.py --mesh

runs phases 1, 2 and 8f only (a mesh and processes; on a machine with four
cards, mesh_cards too), and prints no result line.

    python3 chip_smoke.py --mesh-profile

times the stages of 256 pairs through predict_batch on card 0 and on a mesh
of every visible card, slot by slot, with torch.profiler's busiest host ops;
one JSON line per case.
"""
import contextlib
import functools
import gc
import importlib
import io
import json
import os
import re
import shutil
import socket
import stat
import subprocess
import sys
import tempfile
import time

if "--package-root" in sys.argv:
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--package-root") + 1]))

import numpy as np
import torch
import torch.nn.functional as F

import fovvideovdp_tpu_torch as fvt
from fovvideovdp_tpu_torch.ops import cuda as cuda_ops
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops
from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.ops.cuda import band_pipeline as bp
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs
from fovvideovdp_tpu_torch.ops.cuda import expand_contrast as ec
from fovvideovdp_tpu_torch.ops.cuda import mov_score as ms
from fovvideovdp_tpu_torch.ops.cuda import reduce as red
from fovvideovdp_tpu_torch.ops.cuda import temporal as tmp
from fovvideovdp_tpu_torch import native, run_fvvdp
from fovvideovdp_tpu_torch.parallel import make_mesh
from fovvideovdp_tpu_torch.parallel.sharding import split_rows
from fovvideovdp_tpu_torch.ops.pyramid import K5
from fovvideovdp_tpu_torch.video_source_yuv import yuv_block_to_luminance
from fovvideovdp_tpu_torch.visualize import visualize_diff_map_frames

H, W, N_FRAMES, FPS = 2160, 3840, 60, 30.0
GOLDEN_SYNTH_Q = 9.7688   # bench.py: the PyTorch reference's JOD for this clip
JOD_TOL = 0.01

# Peak rates of one H100 SXM (NVIDIA data sheet)
MEM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# log2/exp2 results per clock per SM for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput)
SFU_PER_SM_CLOCK = 16
# transcendentals per fine pixel in expand_score2: log2 of L_bkg, then
# 5 per temporal channel (csrc/score_math.cuh:d_beta_log2)
SFU_PER_PIXEL = 11
# the same in the band scorers: 1 + 5 per channel
SFU_PER_PIXEL_1CH = 6
# mov_score: the 11 of two channels and two square roots (eccentricity, its axis)
SFU_PER_PIXEL_MOV = 13
HEAT_FRAMES = 8           # depth of the heatmap and per-channel-LUT videos

SOURCES = {
    "gausspyr_reduce": dict(
        source="fovvideovdp_tpu_torch/csrc/reduce.cu",
        replaces="fovvideovdp_tpu/ops/pallas/reduce.py:168",
        also_replaces=["fovvideovdp_tpu/ops/pallas/reduce.py:87"]),
    "expand_score2": dict(
        source="fovvideovdp_tpu_torch/csrc/band_pipeline.cu",
        replaces="fovvideovdp_tpu/ops/pallas/band_pipeline.py:83",
        also_replaces=["fovvideovdp_tpu/ops/pallas/score_math.py:43",
                       "fovvideovdp_tpu/ops/pallas/score_math.py:101"]),
    "temporal_pair": dict(
        source="fovvideovdp_tpu_torch/csrc/temporal.cu",
        replaces="fovvideovdp_tpu/ops/pallas/temporal.py:100",
        also_replaces=["fovvideovdp_tpu/ops/pallas/temporal.py:59"]),
    "expand_contrast": dict(
        source="fovvideovdp_tpu_torch/csrc/expand_contrast.cu",
        replaces="fovvideovdp_tpu/ops/pallas/expand.py:49", also_replaces=[]),
    "band_score": dict(
        source="fovvideovdp_tpu_torch/csrc/band_score.cu",
        replaces="fovvideovdp_tpu/ops/pallas/band_score.py:40", also_replaces=[]),
    "band_score2": dict(
        source="fovvideovdp_tpu_torch/csrc/band_score.cu",
        replaces="fovvideovdp_tpu/ops/pallas/band_score.py:62", also_replaces=[]),
    "band_score2_fov": dict(
        source="fovvideovdp_tpu_torch/csrc/band_score.cu",
        replaces="fovvideovdp_tpu/ops/pallas/band_score.py:219", also_replaces=[]),
    "mov_score": dict(
        source="fovvideovdp_tpu_torch/csrc/mov_score.cu",
        replaces="fovvideovdp_tpu/ops/pallas/mov_score.py:51", also_replaces=[]),
}
# the path whose run gives each kernel's "launches" in the kernels line
# (band_score2 is on no path of the package: it is held in phase 3 only)
PATH_OF = {"gausspyr_reduce": "video", "expand_score2": "video", "temporal_pair": "video",
           "expand_contrast": "foveated_video", "band_score2_fov": "foveated_video",
           "band_score": "per_channel_video", "band_score2": None,
           "mov_score": "moving_gaze_video"}


def synth_clip(h, w, n_frames):
    """bench.py's clip, bit for bit (tools/gen_synth_golden.py:43-55)."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, size=(h, w, 1, 8), dtype=np.uint8)
    test = np.clip(base.astype(np.int16) + rng.randint(-12, 12, size=base.shape),
                   0, 255).astype(np.uint8)
    reps = -(-n_frames // base.shape[-1])
    ref_v = np.ascontiguousarray(np.tile(base, (1, 1, 1, reps))[..., :n_frames])
    test_v = np.ascontiguousarray(np.tile(test, (1, 1, 1, reps))[..., :n_frames])
    return test_v, ref_v


def nvidia_smi(query):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, runs=10, warmup=2):
    """Median of ``runs`` CUDA-event timings of fn() on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sweeping_gaze(w, h, n):
    """A gaze per frame, in pixels, from the top-left corner to the bottom-right."""
    return np.stack([np.linspace(0.0, w - 1.0, n), np.linspace(0.0, h - 1.0, n)],
                    axis=1).astype(np.float32)


def split_timings(fv, content, dim_order, dev, runs=3, **predict_kw):
    """Median seconds of building the array source (upload included) and of
    predict_video_source on it, each ending in a synchronise."""
    src_t, score_t = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        vs = fvt.fvvdp_video_source_array(*content, dim_order=dim_order,
                                          display_photometry=fv.display_photometry,
                                          device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fv.predict_video_source(vs, **predict_kw)
        t2 = time.perf_counter()
        src_t.append(t1 - t0)
        score_t.append(t2 - t1)
        del vs
    return float(np.median(src_t)), float(np.median(score_t))


def bound(nbytes, ops, op_rate):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def emit(obj):
    print(json.dumps(obj), flush=True)


def reduce_case(x, main_path, note, cases):
    """One reduce: kernel against plain (bit for bit), timed beside its bound
    and a strided conv2d computing the same level."""
    N, h, w = x.numel() // (x.shape[-2] * x.shape[-1]), x.shape[-2], x.shape[-1]
    got = red.gausspyr_reduce(x)
    want = red.gausspyr_reduce_plain(x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = bool(torch.equal(got, want))
    vec = red.plan_for(x, got).vec
    ms = time_ms(lambda: red.gausspyr_reduce(x))
    plain_ms = time_ms(lambda: red.gausspyr_reduce_plain(x))
    w2d = torch.as_tensor(np.outer(K5, K5), device=x.device)[None, None]
    x3 = x.reshape(N, 1, h, w)
    xpad = F.pad(torch.cat([x3[..., 1:2, :], x3[..., 0:1, :], x3,
                            x3[..., -1:, :], x3[..., -2:-1, :]], dim=-2), (2, 2))
    lib_ms = time_ms(lambda: F.conv2d(xpad, w2d, stride=2))
    del xpad
    ho, wo = got.shape[-2], got.shape[-1]
    b_ms, b_by = bound(4 * N * (h * w + ho * wo), 9 * N * (ho * w + ho * wo),
                       FP32_FLOP_PER_S)
    add_row(cases, dict(case="gausspyr_reduce", shape=[N, h, w],
                        arm="vector" if vec else "scalar", note=note, max_abs_err=err,
                        tolerance="bit for bit", ok=ok, launches_per_call=1, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                        main_path=main_path), f"{(N, h, w)} ({note})")
    return got, vec


def check_reduce(gpyr_in, cases):
    """Every level of one block's pyramid on the vector arm: kernel vs plain
    vs strided conv2d; then the coarsest level once more, which the main path
    never reduces; then the scalar arm: level 1 cut to an odd width, and
    level 2 stored 4 bytes off a 16-byte boundary."""
    x = gpyr_in
    levels = [x]
    while len(levels) < cases["n_levels"] + 2:
        main_path = len(levels) <= cases["n_levels"]
        x, vec = reduce_case(x, main_path, "main path" if main_path else "coarsest level",
                             cases)
        if main_path and not vec:
            raise AssertionError(f"gausspyr_reduce at {tuple(levels[-1].shape)} left the "
                                 f"vector arm")
        levels.append(x)
    for note, xs in (("odd width", levels[1][:8, :, :, :-1].contiguous()),
                     ("input off a 16-byte boundary", offset_by_one_float(levels[2][:8]))):
        if reduce_case(xs, False, note, cases)[1]:
            raise AssertionError(f"gausspyr_reduce ({note}) took the vector arm")
    return levels[:-1]


def offset_by_one_float(t):
    """The same values in storage that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_expand(core, gpyr, sfu_rate, cases):
    """Every level of one block on the vector arm (the main path), then the
    scalar arm: level 1 cut to an odd width, and level 2 stored 4 bytes off a
    16-byte boundary; then one frame of level 2 as the image path gives it,
    with zero transient channels, whose sum must be exactly 0."""
    odd = gpyr[1][:8, :, :, :-1].contiguous()
    image = [g[:1].clone() for g in gpyr[2:4]]
    for g in image:
        g[:, 2:] = 0.0
    # level, fine, coarse, on the main path, on the vector arm
    runs = [(bb, gpyr[bb], gpyr[bb + 1], True, True) for bb in range(core.plan.height)]
    runs += [(1, odd, gpyr[2][:8].contiguous(), False, False),
             (2, offset_by_one_float(gpyr[2][:8]), gpyr[3][:8].contiguous(), False, False),
             (2, image[0], image[1], False, True)]
    for bb, fine, coarse, main_path, want_vec in runs:
        tabs, meta = core._score_tables[bb], core._meta[bb]
        vec = bp.plan_for(fine, coarse, tabs).vec
        if vec != want_vec:
            raise AssertionError(f"expand_score2 at {tuple(fine.shape)}, address % 16 = "
                                 f"{fine.data_ptr() % 16}: vector arm is {vec}")
        got = bp.expand_score2(fine, coarse, tabs, meta).double()
        want = bp.expand_score2_plain(fine, coarse, tabs, meta).double()
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        ok = rel <= 1e-4 and bool(torch.isfinite(got).all())
        if fine is image[0]:
            ok = ok and bool((got[:, 1] == 0.0).all())
        ms = time_ms(lambda: bp.expand_score2(fine, coarse, tabs, meta))
        plain_ms = time_ms(lambda: bp.expand_score2_plain(fine, coarse, tabs, meta),
                           runs=3, warmup=1)
        Fr, _, h, w = fine.shape
        nbytes = 4 * (fine.numel() + coarse.numel() + tabs.numel() + 2 * Fr)
        b_ms, b_by = bound(nbytes, SFU_PER_PIXEL * Fr * h * w, sfu_rate)
        row = dict(case="expand_score2", shape=list(fine.shape),
                   arm="vector" if vec else "scalar", max_abs_err=err,
                   max_rel_err=rel, tolerance="relative 1e-4 on per-frame sums",
                   ok=ok, launches_per_call=1, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by, main_path=main_path)
        emit(row)
        cases["rows"].append(row)
        if not ok:
            raise AssertionError(f"expand_score2 disagrees with its plain version at "
                                 f"level {bb} {tuple(fine.shape)}: max rel err {rel}")


def check_temporal(ct, nt, cr, nr, taps, main_path, cases):
    got = tmp.temporal_pair(ct, nt, cr, nr, taps)
    want = tmp.temporal_pair_plain(ct, nt, cr, nr, taps)
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-4))
    n_out = got.shape[0]
    del got, want
    ms = time_ms(lambda: tmp.temporal_pair(ct, nt, cr, nr, taps))
    plain_ms = time_ms(lambda: tmp.temporal_pair_plain(ct, nt, cr, nr, taps))
    fl = taps.shape[1]
    win = torch.stack([torch.cat([ct, nt]), torch.cat([cr, nr])])[:, None]  # (2,1,T,H,W)
    w3d = torch.flip(taps, dims=[1]).reshape(2, 1, fl, 1, 1).contiguous()
    lib_ms = time_ms(lambda: F.conv3d(win, w3d))
    del win
    hw = nt.shape[1] * nt.shape[2]
    nz = int((taps != 0).sum().item())
    b_ms, b_by = bound(4 * hw * (2 * (ct.shape[0] + nt.shape[0]) + 4 * n_out),
                       2 * 2 * nz * n_out * hw, FP32_FLOP_PER_S)
    row = dict(case="temporal_pair", shape=[ct.shape[0], nt.shape[0], fl] + list(nt.shape[1:]),
               max_abs_err=err, tolerance="rtol 1e-5, atol 1e-4", ok=ok,
               launches_per_call=1, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=b_ms, bound_by=b_by, main_path=main_path)
    emit(row)
    cases["rows"].append(row)
    if not ok:
        raise AssertionError(f"temporal_pair disagrees with its plain version "
                             f"(carry {ct.shape[0]}): max abs err {err}")


def rel_err(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def add_row(cases, row, what):
    emit(row)
    cases["rows"].append(row)
    if not row["ok"]:
        raise AssertionError(f"{row['case']} disagrees with its plain version at {what}: {row}")


def check_expand_contrast(gpyr, n_levels, cases):
    """Every level of one block's pyramid at C = 4 (the video routes), and
    frame 0's first two channels at C = 2 (the image routes).  Returns the
    C = 4 contrast levels [(contrast, L_bkg)] for the band scorers."""
    levels = []
    for bb in range(n_levels):
        for C in (4, 2):
            if C == 4:
                fine, coarse = gpyr[bb], gpyr[bb + 1]
            else:
                fine = gpyr[bb][:1, :2].contiguous()
                coarse = gpyr[bb + 1][:1, :2].contiguous()
            got_c, got_l = ec.expand_contrast(fine, coarse)
            want_c, want_l = ec.expand_contrast_plain(fine, coarse)
            torch.cuda.synchronize()
            err = max((got_c - want_c).abs().max().item(), (got_l - want_l).abs().max().item())
            ok = bool(torch.allclose(got_c, want_c, rtol=2e-5, atol=1e-4)
                      and torch.allclose(got_l, want_l, rtol=1e-5, atol=1e-4))
            del want_c, want_l
            ms = time_ms(lambda: ec.expand_contrast(fine, coarse))
            plain_ms = time_ms(lambda: ec.expand_contrast_plain(fine, coarse), runs=5, warmup=1)
            nbytes = 4 * (fine.numel() + coarse.numel() + got_c.numel() + got_l.numel())
            b_ms, b_by = bound(nbytes, 70 * got_l.numel(), FP32_FLOP_PER_S)
            add_row(cases, dict(
                case="expand_contrast", shape=list(fine.shape), max_abs_err=err,
                tolerance="contrast rtol 2e-5 atol 1e-4, L_bkg rtol 1e-5 atol 1e-4", ok=ok,
                launches_per_call=1, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, main_path=C == 4), f"level {bb}, C = {C}")
            if C == 4:
                levels.append((got_c, got_l))
    return levels


def band_runs(bb, band, L, core_pc, core_2, ts, tt, metaf):
    """(kernel, note, kernel call, plain call, the planes the arm is chosen
    from, per-pixel knots, bytes, transcendentals, bar) of each band scorer
    on one band: band_score on each channel with the per-channel LUT core's
    tables, band_score2 with the default core's shared-grid tables and
    band_score2_fov with the fixation point's per-pixel tables ts, tt."""
    Fr, _, h, w = band.shape
    px = Fr * h * w
    runs = []
    for cc in range(2):
        T, R = band[:, 2 * cc], band[:, 2 * cc + 1]
        table, meta = core_pc._channel_tables[bb][cc], core_pc._channel_meta[bb][cc]
        q = (meta.q_s, meta.q_t)[cc]
        runs.append(("band_score", f"channel {cc}, n = {table.shape[0]}",
                     lambda T=T, R=R, t=table, m=meta, q=q: bs.band_score(T, R, L, t, m, q),
                     lambda T=T, R=R, t=table, m=meta, q=q: bs.band_score_plain(T, R, L, t, m, q),
                     (("T", T), ("R", R), ("L_bkg", L)), 0,
                     4 * (3 * px + table.numel() + Fr), SFU_PER_PIXEL_1CH * px, 1e-4))
    tabs2, meta2 = core_2._score_tables[bb], core_2._meta[bb]
    planes = (("band", band), ("L_bkg", L))
    runs.append(("band_score2", f"n = {tabs2.shape[1]}",
                 lambda: bs.band_score2(band, L, tabs2, meta2),
                 lambda: bs.band_score2_plain(band, L, tabs2, meta2), planes, 0,
                 4 * (5 * px + tabs2.numel() + 2 * Fr), SFU_PER_PIXEL * px, 1e-4))
    runs.append(("band_score2_fov", f"n = {ts.shape[0]}",
                 lambda: bs.band_score2_fov(band, L, ts, tt, metaf),
                 lambda: bs.band_score2_fov_plain(band, L, ts, tt, metaf), planes, ts.shape[0],
                 4 * (5 * px + ts.numel() + tt.numel() + 2 * Fr), SFU_PER_PIXEL * px, 2e-4))
    return runs


def check_band_scores(levels, core_pc, core_2, core_fov, fov_tabs, sfu_rate, cases):
    """band_score (per-channel LUT core's tables, both channels), band_score2
    (the default core's shared-grid tables) and band_score2_fov (the
    fixation point's per-pixel tables) at every level of one block, on the
    vector arm; then level 2 on the scalar arm: cut to 539 x 959 (an odd
    pixel count), and whole with L_bkg stored 4 bytes off a 16-byte
    boundary."""
    for bb, (band, L_bkg) in enumerate(levels):
        L = L_bkg[:, 0]
        ts, tt = fov_tabs[bb]
        metaf = core_fov._fov_meta[bb]
        variants = [("", True, band, L, ts, tt)]
        if bb == 2:
            cut = [t[..., :-1, :-1].contiguous() for t in (band, L, ts, tt)]
            variants += [("odd pixel count, ", False, *cut),
                         ("L_bkg off a 16-byte boundary, ", False, band,
                          offset_by_one_float(L), ts, tt)]
        for prefix, vec_arm, b, l, t_s, t_t in variants:
            for name, note, kernel, plain, planes, n_pix, nbytes, sfu, tol in band_runs(
                    bb, b, l, core_pc, core_2, t_s, t_t, metaf):
                plan = bs.plan_for(name, planes, n_pix)[0]
                if plan.vec != vec_arm:
                    raise AssertionError(f"{name} ({prefix}{note}) at level {bb}: vector arm "
                                         f"is {plan.vec}")
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                rel = rel_err(got, want)
                err = (got.double() - want.double()).abs().max().item()
                ok = rel <= tol and bool(torch.isfinite(got).all())
                del got, want
                ms = time_ms(kernel)
                plain_ms = time_ms(plain, runs=3, warmup=1)
                b_ms, b_by = bound(nbytes, sfu, sfu_rate)
                add_row(cases, dict(
                    case=name, shape=[b.shape[0]] + list(b.shape[-2:]),
                    arm="vector" if plan.vec else "scalar", note=prefix + note,
                    block_pixels=plan.block_pixels, max_abs_err=err, max_rel_err=rel,
                    tolerance=f"relative {tol:g} on per-frame sums", ok=ok,
                    launches_per_call=1, ms=ms, plain_ms=plain_ms, library_ms=None,
                    bound_ms=b_ms, bound_by=b_by, main_path=vec_arm),
                    f"level {bb} ({prefix}{note})")


def block_gaze(core_fov, n_frames):
    """View directions of a gaze sweeping corner to corner over n_frames."""
    return core_fov._gaze_directions(torch.from_numpy(
        sweeping_gaze(core_fov.plan.W, core_fov.plan.H, n_frames)))


def mov_instances(core_fov, bb, band, L_bkg, gaze_dir):
    """(note, on the main path, arguments) of the four instances of mov_score
    at level bb: the shipped LUT pair (two tables in shared memory: the main
    path's instance), the one-table arm (the omega = 5 table replaced by its
    mean offset from the omega = 0 one), an image (one frame, zero transient
    contrast) and the LUT with every knot kept, which the kernel reads from
    global memory."""
    L = L_bkg[:, 0]
    vd = core_fov._band_view_dir[bb]
    d = core_fov._moving_band_data(bb)
    full = core_fov._moving_band_data(bb, windowed=False)
    one = d["meta"]._replace(off5=float((d["V2_5"] - d["V2"]).mean().item()))
    image = band[:1].clone()
    image[:, 2:] = 0.0
    return [
        ("two tables", True, (band, L, vd, d["t_r"], gaze_dir, d["V2"], d["V2_5"], d["meta"])),
        ("one table and off5", False, (band, L, vd, d["t_r"], gaze_dir, d["V2"], None, one)),
        ("image", False, (image, L[:1], vd, d["t_r"], gaze_dir[:1], d["V2"], d["V2_5"],
                          d["meta"])),
        ("whole LUT, global memory", False,
         (band, L, vd, full["t_r"], gaze_dir, full["V2"], full["V2_5"], full["meta"])),
    ]


def mov_scalar_arm_instances(core_fov, bb, band, L_bkg, gaze_dir):
    """Level bb on the arm with 4-byte loads: cut to an odd number of pixels,
    and whole with L_bkg stored 4 bytes off a 16-byte boundary."""
    d = core_fov._moving_band_data(bb)
    vd = core_fov._band_view_dir[bb]
    tail = (d["V2"], d["V2_5"], d["meta"])
    cut = [t[..., :-1, :-1].contiguous() for t in (band, L_bkg[:, 0], vd, d["t_r"])]
    return [("odd pixel count", False, (*cut, gaze_dir, *tail)),
            ("L_bkg off a 16-byte boundary", False,
             (band, offset_by_one_float(L_bkg[:, 0]), vd, d["t_r"], gaze_dir, *tail))]


def check_mov_score(levels, core_fov, sfu_rate, cases):
    """mov_score at every level of one block, every instance, on the vector
    arm; level 2 once more on the scalar arm."""
    gaze_dir = block_gaze(core_fov, levels[0][0].shape[0])
    for bb, (band, L_bkg) in enumerate(levels):
        runs = [r + (True,) for r in mov_instances(core_fov, bb, band, L_bkg, gaze_dir)]
        if bb == 2:
            runs += [r + (False,) for r in
                     mov_scalar_arm_instances(core_fov, bb, band, L_bkg, gaze_dir)]
        for note, main_path, args, want_vec in runs:
            meta = args[-1]
            n_e = args[5].shape[0]
            h, w = args[0].shape[-2:]
            shared = ms.lut_in_shared(n_e, meta)
            if shared != (not note.startswith("whole LUT")):
                raise AssertionError(f"mov_score ({note}): LUT in shared memory is {shared}")
            vec = ms.plan_for(*args[:5], [("V2s", args[5])])[0].vec
            if vec != want_vec:
                raise AssertionError(f"mov_score ({note}) at {(h, w)}: vector arm is {vec}")
            got, want = ms.band_score2_mov(*args), ms.band_score2_mov_plain(*args)
            torch.cuda.synchronize()
            rel = rel_err(got, want)
            err = (got.double() - want.double()).abs().max().item()
            ok = rel <= 2e-4 and bool(torch.isfinite(got).all())
            if note == "image":
                ok = ok and bool((got[:, 1] == 0.0).all())
            del got, want
            ms_k = time_ms(lambda: ms.band_score2_mov(*args))
            plain_ms = time_ms(lambda: ms.band_score2_mov_plain(*args), runs=3, warmup=1)
            nf = args[0].shape[0]
            lut_floats = args[5].numel() * (1 if args[6] is None else 2)
            b_ms, b_by = bound(4 * (5 * nf * h * w + 3 * h * w + lut_floats + 4 * nf),
                               SFU_PER_PIXEL_MOV * nf * h * w, sfu_rate)
            add_row(cases, dict(
                case="mov_score", shape=[nf, h, w], arm="vector" if vec else "scalar",
                note=f"{note}, LUT {n_e} x {meta.ny} x "
                f"{meta.nr} in {'shared' if shared else 'global'} memory", max_abs_err=err,
                max_rel_err=rel, tolerance="relative 2e-4 on per-frame sums", ok=ok,
                launches_per_call=1, ms=ms_k, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, main_path=main_path), f"level {bb} ({note})")


def expect_launches(path, launches, must, must_not):
    """A path's own expectation: kernels that must launch, kernels that must not."""
    bad = [k for k in must if launches[k] <= 0] + [k for k in must_not if launches[k] != 0]
    if bad:
        raise AssertionError(f"{path}: launches of {bad} are wrong: {launches} "
                             f"(expected > 0: {must}; == 0: {must_not})")


def counted(fn):
    """fn() with the launch counts set to 0 just before and read just after."""
    cuda_ops.reset_launch_counts()
    out = fn()
    return out, cuda_ops.launch_counts()


def warm_seconds(fn, runs=3):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return times, float(np.median(times))


def cut_luts(fv):
    """The metric's LUTs with the omega = 5 one cut by its last Y knot, so
    that the two temporal channels no longer share a Y grid."""
    luts = [dict(l) for l in fv._luts]
    luts[1] = dict(luts[1], Y=luts[1]["Y"][:-1].clone(), Y_log=luts[1]["Y_log"][:-1].clone(),
                   S_log=luts[1]["S_log"][:-1].clone())
    return luts


# the kernels whose rows carry registers and SASS counts: library stem, name
# of the __global__ function, template arguments of the main path's instance
# (expand_score2: vector arm, background channel 1; mov_score: two tables,
# LUT in shared memory, vector arm; the band scorers: channels, per-pixel
# tables, vector arm; reduce: vector arm), the leading template arguments of
# the instances that belong to the kernel, and what one unit of work (a
# pixel(-frame), an output) is counted by: the exp2 a scorer runs per pixel,
# the outputs of reduce's stores (one 8-byte store holds two)
_EX2 = lambda n: (lambda text: ("MUFU.EX2" in text) / n)
_STORED_OUTPUTS = lambda text: (2 if text.startswith("STG.E.64") else
                                1 if text.startswith("STG.E") else 0)
REDESIGNED = {"gausspyr_reduce": ("reduce", "reduce_kernel", "1", "", _STORED_OUTPUTS),
              "expand_score2": ("band_pipeline", "expand_score_kernel", "11", "", _EX2(4)),
              "mov_score": ("mov_score", "mov_score_kernel", "111", "", _EX2(4)),
              "band_score": ("band_score", "band_score_kernel", "101", "10", _EX2(2)),
              "band_score2": ("band_score", "band_score_kernel", "201", "20", _EX2(4)),
              "band_score2_fov": ("band_score", "band_score_kernel", "211", "21", _EX2(4))}
SASS_UNIT = {"gausspyr_reduce": "output"}


def _instance(symbol, function):
    """Template arguments (booleans and one-digit integers) of a mangled
    kernel name as a string of digits, or None when the symbol is not an
    instance of ``function``."""
    m = re.search(function + r"I((?:L[bi][0-9]E)+)E", symbol)
    return None if m is None else "".join(re.findall(r"L[bi]([0-9])E", m.group(1)))


@functools.lru_cache(maxsize=None)
def ptxas_usage(stem, function):
    """{instance: (registers, spill bytes)} from what nvcc -Xptxas -v printed."""
    usage, cur, spills = {}, None, 0
    for line in _lib.build_log(stem).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, spills = _instance(m.group(1), function), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            usage[cur] = (int(m.group(1)), spills)
    return usage


@functools.lru_cache(maxsize=None)
def sass_counts(stem, function, units_of):
    """{instance: counts} from cuobjdump -sass of the built library, or None
    where the toolkit has no cuobjdump: every instruction of the kernel but
    the padding, those of its longest loop (the span of the backward branch
    that jumps furthest), and the units of work in each (``units_of``: an
    instruction's text -> the units it accounts for, REDESIGNED), so that
    instructions over units is the instructions per unit."""
    tool = os.path.join(os.path.dirname(_lib.find_nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return None
    r = subprocess.run([tool, "-sass", _lib.build()[stem]], capture_output=True, text=True,
                       timeout=120)
    if r.returncode != 0:
        return None
    out, cur, code = {}, None, []

    def close():
        if cur is None or not code:
            return
        addr = [a for a, _ in code]
        loop = []
        for i, (a, text) in enumerate(code):
            m = re.search(r"\bBRA\S*\s+(?:\S+\s+)?`?\(?(?:0x)?([0-9a-f]+)\)?\s*$", text)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
                span = code[addr.index(int(m.group(1), 16)):i + 1]
                loop = max(loop, span, key=len)
        units = lambda seq: sum(units_of(t) for _, t in seq)
        out[cur] = dict(total=len(code), total_units=units(code), loop=len(loop),
                        loop_units=units(loop))

    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            cur, code = _instance(m.group(1), function), []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if m and cur is not None and not m.group(2).startswith("NOP"):
            code.append((int(m.group(1), 16), m.group(2)))
    close()
    return out


def build_facts(name):
    """Registers, spills and SASS instructions per unit of work of every
    instance of one redesigned kernel, the main path's instance first."""
    stem, function, main_instance, family, units_of = REDESIGNED[name]
    regs = {i: r for i, r in ptxas_usage(stem, function).items() if i.startswith(family)}
    sass = sass_counts(stem, function, units_of)
    if main_instance not in regs:
        raise AssertionError(f"{name}: nvcc -Xptxas -v reported no instance "
                             f"{main_instance} of {function}: {sorted(regs)}")
    facts = {}
    for inst in sorted(regs, key=lambda i: (i != main_instance, i)):
        per = "not measured"
        if sass is not None and inst in sass:
            c = sass[inst]
            n, units = ((c["loop"], c["loop_units"]) if c["loop_units"] >= 1
                        else (c["total"], c["total_units"]))
            per = dict(c, per_unit=n / units if units else None)
        facts[inst] = dict(registers=regs[inst][0], spill_bytes=regs[inst][1], sass=per)
    return main_instance, facts


def kernel_summary(rows, path_launches):
    """One entry per kernel: the sums over the cases of one main-path block
    (every pyramid level, the carried temporal window), the largest error
    over all of that kernel's cases, and the launches in the run of the path
    that owns the kernel (PATH_OF)."""
    out = []
    for name in cuda_ops.KERNELS:
        mine = [r for r in rows if r["case"] == name]
        main = [r for r in mine if r["main_path"]]
        by_bytes = sum(r["bound_ms"] for r in main if r["bound_by"] == "bytes")
        by_ops = sum(r["bound_ms"] for r in main if r["bound_by"] == "operations")
        lib = [r["library_ms"] for r in main]
        out.append(dict(
            name=name, route="cuda", source=SOURCES[name]["source"],
            replaces=SOURCES[name]["replaces"],
            also_replaces=SOURCES[name]["also_replaces"],
            launches=path_launches[PATH_OF[name]][name] if PATH_OF[name] else 0,
            path=PATH_OF[name] or "none (held against its plain version only)",
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in main),
            plain_ms=sum(r["plain_ms"] for r in main),
            bound_ms=sum(r["bound_ms"] for r in main),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=None if any(v is None for v in lib) else sum(lib),
            cases=len(mine)))
        if name in REDESIGNED:
            inst, facts = build_facts(name)
            sass = facts[inst]["sass"]
            out[-1].update(
                registers=facts[inst]["registers"], spill_bytes=facts[inst]["spill_bytes"],
                sass_per_pixel=sass if isinstance(sass, str) else sass["per_unit"],
                sass_unit=SASS_UNIT.get(name, "pixel(-frame)"),
                instances=facts,
                scalar_arm_cases=sum(r.get("arm") == "scalar" for r in mine))
    return out


class FrameSource(fvt.fvvdp_video_source):
    """A source with only the reference's per-frame methods, over another
    source's frames; its blocks are the base class's concatenation."""

    def __init__(self, inner):
        self.inner = inner

    def get_video_size(self):
        return self.inner.get_video_size()

    def get_frames_per_second(self):
        return self.inner.get_frames_per_second()

    def get_test_frame(self, frame, device=None):
        return self.inner.get_test_frame(frame)

    def get_reference_frame(self, frame, device=None):
        return self.inner.get_reference_frame(frame)


def first_block(fv, dev):
    """The clip and its first block as the main path sees it: the source, the
    carried window (ct, cr), the block's new frames (nt, nr), the temporal
    taps and the block size."""
    test_v, ref_v = synth_clip(H, W, N_FRAMES)
    B = fv._pick_block_size(H, W, N_FRAMES)
    vs = fvt.fvvdp_video_source_array(test_v, ref_v, FPS, dim_order="HWCF",
                                      display_photometry=fv.display_photometry,
                                      device=dev)
    fl = temporal_ops.filter_len_for_fps(FPS)
    taps = torch.as_tensor(temporal_ops.temporal_filters(
        FPS, fl, fv.sustained_sigma, fv.sustained_beta), device=dev)
    pad_idx = temporal_ops.padding_indices(N_FRAMES, fl, fv.temp_padding)
    ct, cr = vs.get_indexed_luminance_block(pad_idx[:fl - 1])
    nt, nr = vs.get_luminance_block(0, B)
    return test_v, ref_v, vs, (ct, nt, cr, nr), taps, B


def source_build_seconds(fv, test_v, ref_v, dev, runs=3):
    """Seconds of building the array source of the clip, each ending in a
    synchronise."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vs = fvt.fvvdp_video_source_array(test_v, ref_v, FPS, dim_order="HWCF",
                                          display_photometry=fv.display_photometry,
                                          device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del vs
    return times


def time_kernels(dev):
    """--time-kernels: gausspyr_reduce, expand_score2, every instance of
    mov_score and the three band scorers (band_score on each channel,
    band_score2, band_score2_fov with a centre gaze's tables) at the levels of
    one 4K block, through the wrappers of whatever package was imported,
    timed as phase 3 times them, with a checksum per kernel and level; and
    the build of the array source of the 4K clip (its upload).  One JSON
    line."""
    smi = nvidia_smi("name,power.limit")
    _lib.build()
    fv = fvt.fvvdp(display_name="standard_4k")
    core = fv._get_core(W, H)
    test_v, ref_v, vs, window, taps, B = first_block(fv, dev)
    gpyr = [tmp.temporal_pair(*window, taps)]
    del vs, window
    for _ in range(core.plan.height):
        gpyr.append(red.gausspyr_reduce(gpyr[-1]))
    out = dict(phase="time_kernels", package=os.path.dirname(os.path.abspath(fvt.__file__)),
               nvidia_smi=smi, block_frames=B, expand_score2=[], mov_score={},
               band_score={}, band_score2=[], band_score2_fov=[])
    out["gausspyr_reduce"] = [time_ms(lambda: red.gausspyr_reduce(gpyr[bb]))
                              for bb in range(core.plan.height)]
    out["gausspyr_reduce_sum_ms"] = sum(out["gausspyr_reduce"])
    out["gausspyr_reduce_checksum"] = [g.double().sum().item() for g in gpyr[1:]]
    out["source_build_s"] = source_build_seconds(fv, test_v, ref_v, dev)
    out["source_build_s_median"] = float(np.median(out["source_build_s"]))
    del test_v, ref_v
    sums = []
    for bb in range(core.plan.height):
        args = (gpyr[bb], gpyr[bb + 1], core._score_tables[bb], core._meta[bb])
        sums.append(bp.expand_score2(*args).double().sum().item())
        out["expand_score2"].append(time_ms(lambda: bp.expand_score2(*args)))
    out["expand_score2_sum_ms"] = sum(out["expand_score2"])
    out["expand_score2_checksum"] = sums
    core_fov = fvt.fvvdp(display_name="standard_4k", foveated=True)._get_core(W, H)
    gaze_dir = block_gaze(core_fov, B)
    fov_tabs = core_fov.fov_tables((float(W // 2), float(H // 2)))
    fv_pc = fvt.fvvdp(display_name="standard_4k")
    fv_pc.load_state(fv_pc.parameters, cut_luts(fv_pc))
    core_pc = fv_pc._get_core(W, H)
    sums = {}
    for bb in range(core.plan.height):
        band, L_bkg = ec.expand_contrast(gpyr[bb], gpyr[bb + 1])
        for note, _, args in mov_instances(core_fov, bb, band, L_bkg, gaze_dir):
            if note == "two tables":
                sums.setdefault("mov_score", []).append(
                    ms.band_score2_mov(*args).double().sum().item())
            out["mov_score"].setdefault(note, []).append(
                time_ms(lambda: ms.band_score2_mov(*args)))
        for name, note, kernel, *_ in band_runs(bb, band, L_bkg[:, 0], core_pc, core,
                                                *fov_tabs[bb], core_fov._fov_meta[bb]):
            sums.setdefault(name, []).append(kernel().double().sum().item())
            t = time_ms(kernel)
            if name == "band_score":
                out[name].setdefault(note.split(",")[0], []).append(t)
            else:
                out[name].append(t)
        del band, L_bkg
    out["mov_score_sum_ms"] = {k: sum(v) for k, v in out["mov_score"].items()}
    out["band_score_sum_ms"] = sum(sum(v) for v in out["band_score"].values())
    out["band_score2_sum_ms"] = sum(out["band_score2"])
    out["band_score2_fov_sum_ms"] = sum(out["band_score2_fov"])
    for name, v in sums.items():
        out[f"{name}_checksum"] = v
    emit(out)
    return 0


def upload_pageable(dst, src):
    """The upload before the staged copy: one blocking copy from pageable
    memory."""
    dst.copy_(src)


def upload_registered(dst, src):
    """Page-lock the caller's own buffer, one asynchronous copy, unlock."""
    cudart = torch.cuda.cudart()
    ptr, nbytes = src.data_ptr(), src.numel() * src.element_size()
    rc = int(cudart.cudaHostRegister(ptr, nbytes, 0))
    if rc != 0:
        raise RuntimeError(f"cudaHostRegister failed: cudaError {rc}")
    try:
        dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    finally:
        cudart.cudaHostUnregister(ptr)


def time_upload(dev):
    """--time-upload: the raw pair of the 4K clip (2 x 0.5 GB uint8) put on
    the card by each variant in turns (the pageable copy, the package's
    staged copy at 16, 32 and 64 MB chunks, a page-locked caller buffer),
    each checked byte for byte; the host transpose of the HWCF pair to
    (C, F, H, W); the array source's build, resident and host-resident.
    Seconds end in a synchronise.  One JSON line."""
    from fovvideovdp_tpu_torch import video_source as vsrc
    smi = nvidia_smi("name,power.limit")
    test_v, ref_v = synth_clip(H, W, N_FRAMES)
    srcs = [torch.from_numpy(test_v), torch.from_numpy(ref_v)]
    want = [x.to(dev) for x in srcs]
    dsts = [torch.empty_like(x) for x in want]
    variants = {"pageable": upload_pageable,
                "staged_16MB": functools.partial(vsrc._staged_copy, chunk_bytes=16 << 20),
                "staged_32MB": functools.partial(vsrc._staged_copy, chunk_bytes=32 << 20),
                "staged_64MB": functools.partial(vsrc._staged_copy, chunk_bytes=64 << 20),
                "registered": upload_registered}
    times = {k: [] for k in variants}
    order = list(variants)
    for rep in range(4):
        for name in (order if rep % 2 == 0 else order[::-1]):
            for d in dsts:
                d.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for d, x in zip(dsts, srcs):
                variants[name](d, x)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            if not all(torch.equal(d, w) for d, w in zip(dsts, want)):
                raise AssertionError(f"upload variant {name} changed the bytes")
    del dsts, want
    nbytes = sum(x.numel() for x in srcs)
    transpose = []
    for _ in range(3):
        t0 = time.perf_counter()
        for x in srcs:
            vsrc.reshuffle_dims(x, "HWCF", "BCFHW")[0].contiguous()
        transpose.append(time.perf_counter() - t0)
    fv = fvt.fvvdp(display_name="standard_4k")
    build = {"resident": source_build_seconds(fv, test_v, ref_v, dev)}
    fvt.fvvdp_video_source_array.DEVICE_PRELOAD_LIMIT_BYTES = 0
    build["host_resident"] = source_build_seconds(fv, test_v, ref_v, dev)
    fvt.fvvdp_video_source_array.DEVICE_PRELOAD_LIMIT_BYTES = None
    med = {k: float(np.median(v)) for k, v in times.items()}
    emit(dict(phase="time_upload", nvidia_smi=smi, bytes=nbytes, order=order, seconds=times,
              median_s=med, gb_per_s={k: nbytes / v / 1e9 for k, v in med.items()},
              host_transpose_s=transpose, source_build_s=build,
              chunk_bytes=vsrc.UPLOAD_CHUNK_BYTES))
    return 0


# --- file sources (phases 4d-4h) ------------------------------------------------

def write_yuv420(path, luma_hwf, chroma=None):
    """(H, W, F) luma planes -> a raw 4:2:0 file; chroma 128 (8-bit) unless
    ``chroma(f)`` gives frame f's (u, v) planes."""
    h, w, n = luma_hwf.shape
    gray = np.full(h * w // 2, 128, dtype=luma_hwf.dtype).tobytes()
    # torch's transpose copy runs on all cores, numpy's on one
    frames = torch.from_numpy(luma_hwf.view(np.int16) if luma_hwf.dtype == np.uint16
                              else luma_hwf).permute(2, 0, 1).contiguous().numpy()
    with open(path, "wb") as f:
        for k in range(n):
            f.write(frames[k].tobytes())
            if chroma is None:
                f.write(gray)
            else:
                for plane in chroma(k):
                    f.write(np.ascontiguousarray(plane).tobytes())


def stub_ffmpeg(bindir):
    """ffprobe prints <file>.probe.json; ffmpeg streams the file's raw bytes
    to its stdout, as a decoder of a rawvideo stream would."""
    os.makedirs(bindir, exist_ok=True)
    bodies = {
        "ffprobe": "import sys\nprint(open(sys.argv[-1] + '.probe.json').read())\n",
        "ffmpeg": ("import shutil, sys\n"
                   "path = sys.argv[sys.argv.index('-i') + 1]\n"
                   "with open(path, 'rb') as f:\n"
                   "    shutil.copyfileobj(f, sys.stdout.buffer, 1 << 24)\n")}
    for name, body in bodies.items():
        exe = os.path.join(bindir, name)
        with open(exe, "w", encoding="utf-8") as f:
            f.write(f"#!{sys.executable}\n{body}")
        os.chmod(exe, os.stat(exe).st_mode | stat.S_IEXEC)


class LuminanceSource(fvt.fvvdp_video_source):
    """A clip's (F, H, W) luminance pair already on the card: scoring alone."""

    def __init__(self, t, r, fps):
        self.t, self.r, self.fps = t, r, fps

    def get_video_size(self):
        return self.t.shape[1], self.t.shape[2], self.t.shape[0]

    def get_frames_per_second(self):
        return self.fps

    def get_luminance_block(self, start, count):
        return self.t[start:start + count], self.r[start:start + count]

    def get_indexed_luminance_block(self, indices):
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=self.t.device)
        return self.t.index_select(0, idx), self.r.index_select(0, idx)

    def get_test_frame(self, frame, device=None):
        return self.t[frame][None, None, None]

    def get_reference_frame(self, frame, device=None):
        return self.r[frame][None, None, None]


def yuv_stage_seconds(paths, fv, dev, B):
    """The .yuv source's stages apart, for the pair at ``paths``: the native
    reader into a pinned buffer (host clock), the upload (host clock around
    a synchronised copy), the plain conversion of one block pair on the card
    (CUDA events, median of 10, beside its byte bound), and the scoring of
    the converted clip from a source that holds it on the card."""
    readers = [native.NativeYuvReader(p, W, H, 8, "420") for p in paths]
    n, fb = readers[0].frame_count, readers[0].frame_bytes
    # one staging buffer of a block pair; every source allocates two
    t0 = time.perf_counter()
    pinned = torch.empty(2 * B * fb, dtype=torch.uint8, pin_memory=True)
    pin_alloc_s = time.perf_counter() - t0
    read_s = upload_s = 0.0
    lum = [torch.empty((n, H, W), dtype=torch.float32, device=dev) for _ in paths]
    rgb2y = fvt.utils.json2dict(fvt.utils.config_files.find("color_spaces.json"))["sRGB"]["RGB2Y"]
    args = dict(w=W, h=H, bd=8, ss="420", bt2020=False, resize=None, rh=H, rw=W,
                dm=fv.display_photometry, rgb2y=tuple(float(c) for c in rgb2y))
    for start in range(0, n, B):
        c = min(B, n - start)
        t0 = time.perf_counter()
        for k, rd in enumerate(readers):
            rd.read_block(start, c, out=pinned[k * B * fb:(k * B + c) * fb])
        t1 = time.perf_counter()
        raw = [pinned[k * B * fb:(k * B + c) * fb].to(dev, non_blocking=True).view(c, -1)
               for k in range(2)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        read_s += t1 - t0
        upload_s += t2 - t1
        for k in range(2):
            lum[k][start:start + c] = yuv_block_to_luminance(raw[k], **args)
        if start == 0:
            convert_ms = time_ms(lambda: [yuv_block_to_luminance(x, **args) for x in raw])
            convert_bound_ms = 2 * c * (fb + 4 * H * W) / MEM_BYTES_PER_S * 1e3
            convert_block = c
    for rd in readers:
        rd.close()
    src = LuminanceSource(lum[0], lum[1], FPS)
    score_s = warm_seconds(lambda: (fv.predict_video_source(src), torch.cuda.synchronize()))
    nbytes = 2 * n * fb
    return dict(pin_alloc_s=pin_alloc_s, pin_alloc_bytes=pinned.numel(),
                read_s=read_s, read_gb_per_s=nbytes / read_s / 1e9, upload_s=upload_s,
                upload_gb_per_s=nbytes / upload_s / 1e9, convert_ms_per_block=convert_ms,
                convert_block_frames=convert_block, convert_s=convert_ms / 1e3 * n / convert_block,
                convert_bound_ms=convert_bound_ms,
                convert_bound_by="bytes", score_s_runs=score_s[0], score_s_median=score_s[1])


def file_source_phases(fv, test_v, ref_v, dev):
    """Phases 4d-4h.  The files live in a temporary directory that is deleted
    afterwards; the frame count is cut (and said so) where it lacks room for
    the 4K pair."""
    video_must = ("gausspyr_reduce", "expand_score2", "temporal_pair")
    video_not = ("expand_contrast", "band_score", "band_score2", "band_score2_fov",
                 "mov_score")
    frame_bytes = H * W * 3 // 2
    with tempfile.TemporaryDirectory(prefix="fvvdp_smoke_") as tmp:
        free = shutil.disk_usage(tmp).free
        n = min(N_FRAMES, int(0.8 * free // (2 * frame_bytes)))
        if n < 2:
            raise AssertionError(f"{tmp} has {free} bytes free, too few for two 4K frames")
        t0 = time.perf_counter()
        native_lib = native.build()
        native_build_s = time.perf_counter() - t0
        paths = [os.path.join(tmp, f"{tag}_{W}x{H}_8b_420_709_30fps.yuv") for tag in ("test", "ref")]
        t0 = time.perf_counter()
        for path, clip in zip(paths, (test_v, ref_v)):
            write_yuv420(path, clip[:, :, 0, :n])
        write_s = time.perf_counter() - t0

        # 4d. the .yuv pair through the file source, against the array source
        # fed the host's float32 decode of the same luma planes
        def from_files(**kw):
            vs = fvt.fvvdp_video_source_file(*paths, display_photometry=fv.display_photometry,
                                             device=dev, **kw)
            return fv.predict_video_source(vs)
        t0 = time.perf_counter()
        (q_yuv, s_yuv), launches = counted(from_files)
        first_s = time.perf_counter() - t0
        expect_launches("yuv file video", launches, video_must, video_not)
        B = fv._pick_block_size(H, W, n)
        n_blocks = -(-n // B)
        n_levels = s_yuv["Q_per_ch"].shape[0]
        want = dict(temporal_pair=n_blocks, gausspyr_reduce=n_levels * n_blocks,
                    expand_score2=n_levels * n_blocks)
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"yuv file video: launches {launches}, expected {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, warm_s = warm_seconds(lambda: from_files())
        peak = torch.cuda.max_memory_allocated()
        decode = [np.clip(c[:, :, 0, :n].astype(np.float32) * np.float32(1.0 / 219.0)
                          - np.float32(16.0 / 219.0), 0.0, 1.0) for c in (test_v, ref_v)]
        q_arr, _ = fv.predict(decode[0], decode[1], dim_order="HWF", frames_per_second=FPS)
        del decode
        stages = yuv_stage_seconds(paths, fv, dev, B)
        emit(dict(phase="yuv_file_video", frames=n, jod=q_yuv, jod_array_source=q_arr,
                  tolerance="|dJOD| <= 1e-5", first_call_s=first_s, warm_s_runs=times,
                  warm_s_median=warm_s, fps=n / warm_s, block_frames=B, peak_bytes=peak,
                  peak_bytes_per_px_frame=peak / (B * H * W), file_bytes=2 * n * frame_bytes,
                  write_s=write_s, native_build_s=native_build_s,
                  native_library=os.path.basename(native_lib), launches=launches, **stages))
        if not abs(q_yuv - q_arr) <= 1e-5 or not np.all(np.isfinite(s_yuv["Q_per_ch"])):
            raise AssertionError(f"yuv file video: JOD {q_yuv} vs the array source's {q_arr}")

        # 4e. the same files through an ffmpeg pipe (stub executables) and the
        # native pipe reader
        bindir = os.path.join(tmp, "bin")
        stub_ffmpeg(bindir)
        videos = []
        for path in paths:
            vid = path[:-4] + ".mp4"
            os.symlink(path, vid)
            with open(vid + ".probe.json", "w") as f:
                json.dump({"streams": [{"codec_type": "video", "width": W, "height": H,
                                        "pix_fmt": "yuv420p", "nb_frames": str(n),
                                        "r_frame_rate": "30/1"}]}, f)
            videos.append(vid)
        old_path = os.environ["PATH"]
        os.environ["PATH"] = bindir + os.pathsep + old_path
        try:
            def from_pipe():
                vs = fvt.fvvdp_video_source_file(*videos, display_photometry=fv.display_photometry,
                                                 device=dev)
                return fv.predict_video_source(vs)
            (q_pipe, _), launches = counted(from_pipe)
            expect_launches("ffmpeg pipe video", launches, video_must, video_not)
            times, warm_s = warm_seconds(from_pipe)
        finally:
            os.environ["PATH"] = old_path
        emit(dict(phase="ffmpeg_pipe_video", frames=n, jod=q_pipe, jod_yuv_file=q_yuv,
                  tolerance="|dJOD| <= 1e-6", warm_s_runs=times, warm_s_median=warm_s,
                  fps=n / warm_s, launches=launches))
        if not abs(q_pipe - q_yuv) <= 1e-6:
            raise AssertionError(f"ffmpeg pipe video: JOD {q_pipe} vs the .yuv source's {q_yuv}")

        # 4f. the CLI, in-process
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run_fvvdp.main(["--test", paths[0], "--ref", paths[1], "--display",
                                 "standard_4k", "--quiet"])
        cli_s = time.perf_counter() - t0
        printed = out.getvalue().strip().splitlines()[-1]
        emit(dict(phase="cli_yuv", rc=rc, printed=printed, jod_yuv_file=q_yuv, wall_s=cli_s))
        if rc != 0 or printed != f"{q_yuv:0.4f}":
            raise AssertionError(f"cli: exit {rc}, printed {printed!r}, expected {q_yuv:0.4f}")
        for p in paths + videos:
            os.remove(p)

        # 4g. 10-bit 4:2:0 BT.2020 under PQ, resized bicubic to 4K, card vs CPU
        hd_t, hd_r = synth_clip(1080, 1920, 8)
        rng = np.random.RandomState(1)
        uv = [(rng.randint(448, 577, (540, 960)).astype(np.uint16),
               rng.randint(448, 577, (540, 960)).astype(np.uint16)) for _ in range(8)]
        pq = [os.path.join(tmp, f"{tag}_1920x1080_10b_420_2020_30fps.yuv") for tag in ("t", "r")]
        for path, clip in zip(pq, (hd_t, hd_r)):
            write_yuv420(path, (64 + clip[:, :, 0].astype(np.uint16) * 876 // 255), uv.__getitem__)
        res = {}
        for d in (dev, "cpu"):
            fv_pq = fvt.fvvdp(display_name="standard_hdr_pq", device=d)
            vs = fvt.fvvdp_video_source_file(*pq, display_photometry="standard_hdr_pq",
                                             full_screen_resize="bicubic",
                                             resize_resolution=(3840, 2160), device=d)
            t0 = time.perf_counter()
            (q, s), launches = counted(lambda: fv_pq.predict_video_source(vs))
            res[str(d)] = (q, s, time.perf_counter() - t0, launches)
        expect_launches("10-bit PQ yuv", res[str(dev)][3], video_must, video_not)
        q_card, q_cpu = res[str(dev)][0], res["cpu"][0]
        emit(dict(phase="yuv_10bit_pq_vs_cpu", shape=[1080, 1920, 8], resized_to=[2160, 3840],
                  jod=q_card, jod_cpu=q_cpu, tolerance="|dJOD| <= 1e-4",
                  wall_s=res[str(dev)][2], wall_s_cpu=res["cpu"][2],
                  max_rel_q_per_ch=float(np.max(
                      np.abs(res[str(dev)][1]["Q_per_ch"] - res["cpu"][1]["Q_per_ch"])
                      / np.maximum(np.abs(res["cpu"][1]["Q_per_ch"]), 1e-6))),
                  launches=res[str(dev)][3]))
        if not abs(q_card - q_cpu) <= 1e-4 or res[str(dev)][1]["Q_per_ch"].shape[2] != 8:
            raise AssertionError(f"10-bit PQ yuv: card {q_card} vs CPU {q_cpu}")

    # 4h. the packed YUV source at 1080p, card vs CPU
    rng = np.random.RandomState(2)
    header = [8, 1080, 1920, 8, 420, 1080, 1920]
    packed = []
    for clip in (hd_t, hd_r):
        body = [np.concatenate([clip[:, :, 0, k].ravel(),
                                rng.randint(100, 156, 2 * 540 * 960)]) for k in range(8)]
        packed.append(np.concatenate([header] + body).astype(np.uint16))
    res = {}
    for d in (dev, "cpu"):
        vs = fvt.fvvdp_video_source_packed_array(*packed, FPS, display_photometry="standard_fhd",
                                                 device=d)
        t0 = time.perf_counter()
        (q, _), launches = counted(lambda: fvt.fvvdp(display_name="standard_fhd", device=d)
                                   .predict_video_source(vs))
        res[str(d)] = (q, time.perf_counter() - t0, launches)
    expect_launches("packed array", res[str(dev)][2], video_must, video_not)
    emit(dict(phase="packed_array_vs_cpu", shape=[1080, 1920, 8], jod=res[str(dev)][0],
              jod_cpu=res["cpu"][0], tolerance="|dJOD| <= 1e-4", wall_s=res[str(dev)][1],
              wall_s_cpu=res["cpu"][1], launches=res[str(dev)][2]))
    if not abs(res[str(dev)][0] - res["cpu"][0]) <= 1e-4:
        raise AssertionError(f"packed array: card {res[str(dev)][0]} vs CPU {res['cpu'][0]}")
    return q_yuv if n == N_FRAMES else None


# ---------------------------------------------------------------------------
# 8b. the differentiable path: predict_traced, loss, use_checkpoints and the
# torch loss; each kernel's wrapper goes through its autograd Function
# ---------------------------------------------------------------------------

TRACED_FRAMES = 16        # depth of the traced 4K clip
HD_H, HD_W = 1080, 1920   # standard_fhd, the card-against-CPU size
# card against the CPU: max |dg| over max |g| where both devices score the
# same luminance; where the sRGB EOTF runs on each (CUDA's powf and the
# CPU's differ by an ulp), the relative L2 norm of the difference, because
# an ulp moves the gradient's jumps (see grad_vs_cpu)
GRAD_VS_CPU_TOL = 1e-4
GRAD_VS_CPU_L2_TOL = 1e-3
CKPT_TOL = 1e-6           # the same, with and without use_checkpoints
TRACED_JOD_TOL = 1e-4     # predict_traced against predict
ALL_KERNELS = ("gausspyr_reduce", "expand_score2", "temporal_pair", "expand_contrast",
               "band_score", "band_score2", "band_score2_fov", "mov_score")


def lum_pair(h, w, frames=None, seed=0, noise=0.05):
    """A luminance pair in cd/m^2 on the host, (h, w) or (h, w, frames),
    inside [0.5, 200]: a reference of log-uniform noise and a test with 5 %
    multiplicative noise, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    shape = (h, w) if frames is None else (h, w, frames)
    ref = 0.5 * 400.0 ** torch.rand(shape, generator=g)
    return torch.clamp(ref * (1.0 + noise * torch.randn(shape, generator=g)), 0.5, 200.0), ref


def absolute_fhd(**kw):
    """standard_fhd's geometry with content given in cd/m^2: no EOTF, so the
    card and the CPU score bit-identical luminance."""
    return dict(display_photometry=fvt.fvvdp_display_photo_absolute(L_max=200.0, L_min=0.2),
                display_geometry=fvt.fvvdp_display_geometry.load("standard_fhd"), **kw)


def rgb_pair(h, w, frames=None, seed=0, noise=0.05):
    """A display-encoded RGB pair in [0, 1] on the host, (h, w, 3) or
    (h, w, 3, frames): a reference of uniform noise and a test with Gaussian
    noise added and clipped, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    shape = (h, w, 3) if frames is None else (h, w, 3, frames)
    ref = torch.rand(shape, generator=g)
    return torch.clamp(ref + noise * torch.randn(shape, generator=g), 0.0, 1.0), ref


def not_launched(must):
    return tuple(k for k in ALL_KERNELS if k not in must)


def traced_grad(fv, test, ref, dev, **call):
    """(loss, d loss / d test, launches of the forward, launches of forward
    and backward) of fv.loss on copies of the pair on ``dev``."""
    x = test.to(dev, copy=True).requires_grad_()
    cuda_ops.reset_launch_counts()
    loss = fv.loss(x, ref.to(dev), **call)
    fwd = cuda_ops.launch_counts()
    loss.backward()
    return float(loss.detach()), x.grad, fwd, cuda_ops.launch_counts()


def rel_grad_err(got, want):
    want = want.double().cpu()
    return float((got.double().cpu() - want).abs().max() / want.abs().max())


def traced_costs(fv, test, ref, runs=3, **call):
    """Warm forward and forward + backward times (median of ``runs``, CUDA
    events, ms) of fv.loss with the test image requiring grad, and the
    peak memory of one forward + backward above what was allocated before."""
    x = test.clone().requires_grad_()
    fwd_ms = time_ms(lambda: fv.loss(x, ref, **call), runs=runs, warmup=1)
    both_ms = time_ms(lambda: fv.loss(x, ref, **call).backward(), runs=runs, warmup=1)
    x.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fv.loss(x, ref, **call).backward()
    torch.cuda.synchronize()
    return fwd_ms, both_ms, torch.cuda.max_memory_allocated() - base


def grad_vs_cpu(kw, test, ref, dev, same_luminance=True, **call):
    """The loss and its gradient on the card against the same call with
    device="cpu" (the plain versions throughout): max |dg| / max |g| <=
    GRAD_VS_CPU_TOL when both score the same luminance.  The gradient jumps
    where the masking's min(|T|, |R|) changes sides; at an exact tie it
    splits, as in JAX.  Where the EOTF runs on each device, an ulp of powf
    can break or make such a tie, which moves a few values of the gradient
    by up to a few tenths of their own size, so there the bar is on the
    relative L2 norm of the difference, GRAD_VS_CPU_L2_TOL."""
    card, cpu = [], []
    metrics = [fvt.fvvdp(device=d, **kw) for d in (dev, torch.device("cpu"))]
    if kw.get("foveated"):
        # the geometry's static maps differ by up to 2e-4 relative between the
        # card's tan and the CPU's (ROADMAP section 3, magnification ulp),
        # which moves S as much: the CPU scores with the card's maps
        h, w = test.shape[:2]
        core_card, core_cpu = (m._get_core(w, h) for m in metrics)
        core_cpu._band_rho = [t.cpu() for t in core_card._band_rho]
        core_cpu._band_view_dir = [t.cpu() for t in core_card._band_view_dir]
    for fv, out in zip(metrics, (card, cpu)):
        t0 = time.perf_counter()
        loss, g, _, _ = traced_grad(fv, test, ref, fv.device, **call)
        out += [loss, g.cpu().double(), time.perf_counter() - t0]
    diff = (card[1] - cpu[1]).abs()
    err = float(diff.max() / cpu[1].abs().max())
    l2 = float(diff.norm() / cpu[1].norm())
    ok = err <= GRAD_VS_CPU_TOL if same_luminance else l2 <= GRAD_VS_CPU_L2_TOL
    if not ok or not bool(torch.isfinite(card[1]).all()):
        raise AssertionError(f"gradient on the card against the CPU ({kw}, {call}): "
                             f"max |dg| / max |g| = {err}, relative L2 {l2}")
    return dict(loss=card[0], loss_cpu=cpu[0], rel_grad_err=err, rel_l2_err=l2,
                over_1e4_of_max=int((diff > 1e-4 * cpu[1].abs().max()).sum()),
                values=diff.numel(),
                tolerance=(f"max |dg| / max |g| <= {GRAD_VS_CPU_TOL:g}" if same_luminance
                           else f"|dg|_2 / |g|_2 <= {GRAD_VS_CPU_L2_TOL:g}"),
                card_s=card[2], cpu_s=cpu[2])


def traced_image_phase(dev, smi):
    """The 4K image: predict_traced against predict, a finite non-zero
    gradient, 5 Adam steps that lower the loss at every step, times and
    peak memory.  Returns the pair."""
    fv = fvt.fvvdp(display_name="standard_4k")
    test, ref = (t.to(dev) for t in rgb_pair(H, W))
    call = dict(dim_order="HWC")
    (q_pred, _), pred_launches = counted(lambda: fv.predict(test, ref, **call))
    loss, g, fwd, launches = traced_grad(fv, test, ref, dev, **call)
    must = ("gausspyr_reduce", "expand_score2")
    expect_launches("traced image", launches, must, not_launched(must))
    if launches != fwd or fwd != pred_launches:
        raise AssertionError(f"traced image: forward {fwd}, with the backward {launches}, "
                             f"predict {pred_launches}: the backward launches no kernel")
    q_traced = 10.0 - loss
    g_max = float(g.abs().max())
    if not abs(q_traced - q_pred) <= TRACED_JOD_TOL or not bool(torch.isfinite(g).all()) \
            or not g_max > 0.0:
        raise AssertionError(f"traced 4K image: JOD {q_traced} against predict's {q_pred}, "
                             f"max |g| {g_max}")
    fwd_ms, both_ms, peak = traced_costs(fv, test, ref, **call)
    x = test.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=2e-3)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        step = fv.loss(x, ref, **call)
        step.backward()
        opt.step()
        losses.append(float(step.detach()))
    with torch.no_grad():
        losses.append(float(fv.loss(x, ref, **call)))
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"Adam on the traced 4K image: losses {losses} do not fall "
                             f"at every step")
    emit(dict(phase="traced_image", nvidia_smi=smi, shape=[H, W, 3], jod=q_traced,
              jod_predict=q_pred, tolerance=f"|dJOD| <= {TRACED_JOD_TOL:g}",
              grad_max_abs=g_max, adam_losses=losses, forward_ms=fwd_ms,
              forward_backward_ms=both_ms, peak_bytes=peak, launches=launches))
    return test, ref


def traced_grad_vs_cpu_phase(dev, smi):
    """1080p: an image and an 8-frame clip, the card's gradient against the
    CPU's, in luminance (the same input to the scoring on both) and as
    display-encoded RGB under standard_fhd."""
    video_call = dict(frames_per_second=FPS)
    out = dict(
        image=grad_vs_cpu(absolute_fhd(), *lum_pair(HD_H, HD_W, seed=1), dev, dim_order="HW"),
        video=grad_vs_cpu(absolute_fhd(), *lum_pair(HD_H, HD_W, 8, seed=2), dev,
                          dim_order="HWF", **video_call),
        image_rgb=grad_vs_cpu(dict(display_name="standard_fhd"),
                              *rgb_pair(HD_H, HD_W, seed=1), dev, False, dim_order="HWC"),
        video_rgb=grad_vs_cpu(dict(display_name="standard_fhd"),
                              *rgb_pair(HD_H, HD_W, 8, seed=2), dev, False,
                              dim_order="HWCF", **video_call))
    emit(dict(phase="traced_grad_vs_cpu", nvidia_smi=smi, shape=[HD_H, HD_W],
              frames_video=8, **out))


def traced_video_phase(dev, smi, test_v, ref_v):
    """The first TRACED_FRAMES frames of the 4K clip, with and without
    use_checkpoints: the same gradient, the launches, times and peaks."""
    n = TRACED_FRAMES
    test = torch.as_tensor(test_v[..., :n], device=dev).to(torch.float32) / 255.0
    ref = torch.as_tensor(ref_v[..., :n], device=dev).to(torch.float32) / 255.0
    call = dict(dim_order="HWCF", frames_per_second=FPS)
    must = ("temporal_pair", "gausspyr_reduce", "expand_score2")
    runs, grads = {}, {}
    for ckpt in (False, True):
        fv = fvt.fvvdp(display_name="standard_4k", use_checkpoints=ckpt)
        loss, grads[ckpt], fwd, launches = traced_grad(fv, test, ref, dev, **call)
        name = "traced video" + (" with checkpoints" if ckpt else "")
        expect_launches(name, launches, must, not_launched(must))
        # the checkpointed scoring relaunches its kernels in the backward;
        # the temporal stage lies outside it
        want = {k: v * (2 if ckpt and k != "temporal_pair" else 1) for k, v in fwd.items()}
        if launches != want:
            raise AssertionError(f"{name}: forward {fwd}, with the backward {launches}")
        fwd_ms, both_ms, peak = traced_costs(fv, test, ref, **call)
        runs["checkpoints" if ckpt else "plain"] = dict(
            loss=loss, forward_ms=fwd_ms, forward_backward_ms=both_ms, peak_bytes=peak,
            peak_bytes_per_px_frame=peak / (n * H * W), launches=launches)
    q_pred, _ = fvt.fvvdp(display_name="standard_4k").predict(test, ref, **call)
    err = rel_grad_err(grads[True], grads[False])
    q_traced = 10.0 - runs["plain"]["loss"]
    emit(dict(phase="traced_video", nvidia_smi=smi, shape=[H, W, 1, n], jod=q_traced,
              jod_predict=q_pred, checkpoints_rel_grad_err=err,
              tolerance=f"max |dg| / max |g| <= {CKPT_TOL:g}, |dJOD| <= {TRACED_JOD_TOL:g}",
              **runs))
    if not err <= CKPT_TOL or not abs(q_traced - q_pred) <= TRACED_JOD_TOL \
            or not bool(torch.isfinite(grads[False]).all()):
        raise AssertionError(f"traced 4K video: checkpoints change the gradient by {err}, "
                             f"JOD {q_traced} against predict's {q_pred}")


def traced_foveated_phase(dev, smi, test, ref):
    """The 4K image foveated at the centre (the moving-gaze route), and its
    gradient against the CPU at 1080p."""
    fv = fvt.fvvdp(display_name="standard_4k", foveated=True)
    call = dict(dim_order="HWC")
    loss, g, fwd, launches = traced_grad(fv, test, ref, dev, **call)
    must = ("gausspyr_reduce", "expand_contrast", "mov_score")
    expect_launches("traced foveated image", launches, must, not_launched(must))
    q_pred, _ = fv.predict(test, ref, fixation_point=np.array([[W // 2, H // 2]]), **call)
    q_traced = 10.0 - loss
    if not abs(q_traced - q_pred) <= TRACED_JOD_TOL or not bool(torch.isfinite(g).all()) \
            or launches != fwd:
        raise AssertionError(f"traced foveated 4K image: JOD {q_traced} against predict's "
                             f"{q_pred}, launches {fwd} then {launches}")
    fwd_ms, both_ms, peak = traced_costs(fv, test, ref, **call)
    hd = grad_vs_cpu(absolute_fhd(foveated=True), *lum_pair(HD_H, HD_W, seed=3), dev,
                     dim_order="HW")
    emit(dict(phase="traced_foveated", nvidia_smi=smi, shape=[H, W, 3], jod=q_traced,
              jod_predict_centre_gaze=q_pred, forward_ms=fwd_ms, forward_backward_ms=both_ms,
              peak_bytes=peak, launches=launches, vs_cpu_1080p=hd))


def torch_loss_phase(dev, smi):
    """fvvdp_torch_loss at 1080p with grad_ref: 3 Adam steps on the test
    image, the reference's gradient, and the value under no_grad."""
    fv = fvt.fvvdp(display_name="standard_fhd")
    loss_fn = fvt.fvvdp_torch_loss(fv, dim_order="HWC", grad_ref=True)
    test, ref = (t.to(dev) for t in rgb_pair(HD_H, HD_W, seed=4))
    x, r = test.clone().requires_grad_(), ref.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=2e-3)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        r.grad = None
        loss = loss_fn(x, r)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    r_max = float(r.grad.abs().max())
    if not losses[-1] < losses[0] or not bool(torch.isfinite(r.grad).all()) or not r_max > 0:
        raise AssertionError(f"torch loss: losses {losses}, max |d/d ref| {r_max}")
    with torch.no_grad():
        v_eval, eval_launches = counted(lambda: loss_fn(x, r))
    v_train, train_launches = counted(lambda: loss_fn(x, r))
    if float(v_eval) != float(v_train.detach()) or eval_launches != train_launches \
            or v_eval.grad_fn is not None or v_train.grad_fn is None:
        raise AssertionError(f"torch loss under no_grad: {float(v_eval)} ({eval_launches}) "
                             f"against {float(v_train.detach())} ({train_launches})")
    emit(dict(phase="torch_loss", nvidia_smi=smi, shape=[HD_H, HD_W, 3], losses=losses,
              ref_grad_max_abs=r_max, no_grad_value=float(v_eval),
              no_grad_launches=eval_launches))


def backward_ms_phase(dev, smi):
    """Each Function at the 4K main path's shapes (one block of the clip,
    every level): the kernel's forward time beside the backward's, the
    plain version's VJP recomputed a chunk of frames at a time, CUDA events,
    median of 3; the chunk and the backward's peak above what was
    allocated before."""
    from fovvideovdp_tpu_torch.ops.cuda import _autograd
    fv = fvt.fvvdp(display_name="standard_4k")
    core = fv._get_core(W, H)
    fv_fov = fvt.fvvdp(display_name="standard_4k", foveated=True)
    core_fov = fv_fov._get_core(W, H)
    _, _, vs, (ct, nt, cr, nr), taps, B = first_block(fv, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {k: dict(forward_ms=0.0, backward_ms=0.0, calls=0, chunk_frames=[],
                    peak_bytes=0) for k in ALL_KERNELS}

    def case(name, fn, args, diff):
        op = fn.op
        outs = op.run(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cot = tuple(torch.randn(o.shape, generator=g, device=dev) for o in outs)
        del outs
        frames = _autograd.recompute_frames(op, args)
        row = rows[name]
        row["forward_ms"] += time_ms(lambda: op.run(*args), runs=3, warmup=1)
        row["backward_ms"] += time_ms(lambda: _autograd.vjp(op, args, diff, cot, frames),
                                      runs=3, warmup=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _autograd.vjp(op, args, diff, cot, frames)
        torch.cuda.synchronize()
        row["peak_bytes"] = max(row["peak_bytes"], torch.cuda.max_memory_allocated() - base)
        row["calls"] += 1
        row["chunk_frames"].append(frames)

    case("temporal_pair", tmp.temporal_pair, [ct, nt, cr, nr, taps], (0, 1, 2, 3))
    R = tmp.temporal_pair(ct, nt, cr, nr, taps)
    del ct, nt, cr, nr, vs
    gpyr = core.plan.gaussian_pyramid(R)
    del R
    gaze_dir = block_gaze(core_fov, B)
    for bb in range(core.plan.height):
        fine, coarse = gpyr[bb], gpyr[bb + 1]
        case("gausspyr_reduce", red.gausspyr_reduce, [fine], (0,))
        case("expand_score2", bp.expand_score2,
             [fine, coarse, core._score_tables[bb], core._meta[bb], 1], (0, 1))
        case("expand_contrast", ec.expand_contrast, [fine, coarse, 1], (0, 1))
        band, L_bkg = ec.expand_contrast(fine, coarse)
        L = L_bkg[:, 0]
        meta, tabs = core._meta[bb], core._score_tables[bb]
        for cc in range(2):
            case("band_score", bs.band_score, [band[:, 2 * cc], band[:, 2 * cc + 1], L,
                                               tabs[cc], meta, (meta.q_s, meta.q_t)[cc]],
                 (0, 1, 2))
        case("band_score2", bs.band_score2, [band, L, tabs, meta], (0, 1))
        ts, tt = core_fov.fov_tables((float(W // 2), float(H // 2)))[bb]
        case("band_score2_fov", bs.band_score2_fov, [band, L, ts, tt, core_fov._fov_meta[bb]],
             (0, 1))
        d = core_fov._moving_band_data(bb)
        case("mov_score", ms.band_score2_mov, [band, L, core_fov._band_view_dir[bb], d["t_r"],
                                               gaze_dir, d["V2"], d["V2_5"], d["meta"]],
             (0, 1))
        del band, L_bkg, L, ts, tt
    core_fov.drop_fov_tables()
    del gpyr
    torch.cuda.empty_cache()
    emit(dict(phase="backward_ms", nvidia_smi=smi, block_frames=B, shape=[B, 4, H, W],
              note="forward: the kernel; backward: the plain version's VJP, sums over "
                   "the levels of one block", kernels=rows))
    return rows


def traced_phases(dev, smi):
    """Phase 8b, each raising on failure.  Returns backward_ms's rows."""
    test, ref = traced_image_phase(dev, smi)
    torch.cuda.empty_cache()
    traced_grad_vs_cpu_phase(dev, smi)
    torch.cuda.empty_cache()
    test_v, ref_v = synth_clip(H, W, TRACED_FRAMES)
    traced_video_phase(dev, smi, test_v, ref_v)
    torch.cuda.empty_cache()
    traced_foveated_phase(dev, smi, test, ref)
    del test, ref
    torch.cuda.empty_cache()
    torch_loss_phase(dev, smi)
    torch.cuda.empty_cache()
    rows = backward_ms_phase(dev, smi)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# 8c. batches of pairs (predict_batch) and the do_temporal_channels=False
# ablation: independent frames, a chunk of them per launch
# ---------------------------------------------------------------------------
IMG_N, IMG_H, IMG_W = 64, 384, 512   # the image size of TID2013 and KADID-10k
N_CHECKED = 8                         # pairs held against per-pair predict and the CPU
CLIP_N, CLIP_FRAMES = 3, 30           # 1080p clips at 30 fps
BATCH_TOL = 1e-4


def image_batch(n, h, w, seed=0):
    """n seeded RGB uint8 pairs (n, h, w, 3): a uniform reference and a
    test with integer noise in [-12, 12)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    test = np.clip(ref.astype(np.int16) + rng.integers(-12, 12, size=ref.shape, dtype=np.int16),
                   0, 255).astype(np.uint8)
    return test, ref


def clip_batch(n, h, w, frames):
    """n gray clip pairs (n, h, w, 1, frames), each built as bench.py's clip
    is (8 distinct frames, tiled) from its own seed."""
    pairs = []
    for i in range(n):
        rng = np.random.RandomState(100 + i)
        base = rng.randint(0, 255, size=(h, w, 1, 8), dtype=np.uint8)
        test = np.clip(base.astype(np.int16) + rng.randint(-12, 12, size=base.shape),
                       0, 255).astype(np.uint8)
        reps = -(-frames // 8)
        pairs.append([np.tile(x, (1, 1, 1, reps))[..., :frames] for x in (test, base)])
    return (np.ascontiguousarray(np.stack([p[k] for p in pairs])) for k in (0, 1))


def worst(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def batch_images_phase(dev, smi, fv, test, ref):
    """64 512x384 RGB pairs through predict_batch against a loop of predict."""
    n_levels = fv._get_core(IMG_W, IMG_H, with_heatmap=False).plan.height
    must = ("gausspyr_reduce", "expand_score2")
    (jods, _), launches = counted(lambda: fv.predict_batch(test, ref, dim_order="BHWC"))
    expect_launches("batch_images", launches, must, not_launched(must))
    chunk = fv._pick_chunk(IMG_H, IMG_W, IMG_N, 1, "fused",
                           importlib.import_module("fovvideovdp_tpu_torch.fvvdp")._IMAGE_STACK_BYTES)
    n_chunks = -(-IMG_N // chunk)
    if launches["expand_score2"] != n_levels * n_chunks \
            or launches["gausspyr_reduce"] != n_levels * n_chunks:
        raise AssertionError(f"batch_images: {launches}, expected {n_levels} levels x "
                             f"{n_chunks} chunks of {chunk}")
    per_pair = [fv.predict(test[i], ref[i], dim_order="HWC")[0] for i in range(N_CHECKED)]
    err_pp = worst(jods[:N_CHECKED], per_pair)
    if jods.shape != (IMG_N,) or not np.all(np.isfinite(jods)) or not err_pp <= BATCH_TOL:
        raise AssertionError(f"batch_images: JODs {jods[:N_CHECKED]}, per-pair predict "
                             f"{per_pair} ({err_pp})")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, warm_s = warm_seconds(lambda: fv.predict_batch(test, ref, dim_order="BHWC"))
    peak = torch.cuda.max_memory_allocated()

    def loop():
        for i in range(IMG_N):
            fv.predict(test[i], ref[i], dim_order="HWC")
    _, loop_launches = counted(loop)
    loop_times, loop_s = warm_seconds(loop)
    emit(dict(phase="batch_images", nvidia_smi=smi, pairs=IMG_N, shape=[IMG_H, IMG_W, 3],
              chunk=chunk, jods_checked=jods[:N_CHECKED].tolist(), max_abs_vs_predict=err_pp,
              warm_s_runs=times, warm_s_median=warm_s,
              pairs_per_s=IMG_N / warm_s, loop_s_runs=loop_times, loop_s_median=loop_s,
              loop_pairs_per_s=IMG_N / loop_s, speedup=loop_s / warm_s, peak_bytes=peak,
              resident_bytes_before=resident, raw_batch_bytes=test.nbytes + ref.nbytes,
              peak_bytes_per_px_frame=(peak - resident) / (chunk * IMG_H * IMG_W),
              launches=launches, loop_launches=loop_launches))
    return launches, jods[:N_CHECKED]


def batch_clips_phase(dev, smi):
    """3 1080p clips of 30 frames: each filtered whole by temporal_pair with
    an empty carry, the chunk's responses scored in one call; then streamed
    with their carry (block_frames=8)."""
    test, ref = clip_batch(CLIP_N, HD_H, HD_W, CLIP_FRAMES)
    call = dict(dim_order="BHWCF", frames_per_second=FPS)
    fv = fvt.fvvdp(display_name="standard_fhd")
    n_levels = fv._get_core(HD_W, HD_H).plan.height
    must = ("gausspyr_reduce", "expand_score2", "temporal_pair")
    (jods, stats), launches = counted(lambda: fv.predict_batch(test, ref, **call))
    expect_launches("batch_clips", launches, must, not_launched(must))
    fl = temporal_ops.filter_len_for_fps(FPS)
    chunk = fv._pick_chunk(HD_H, HD_W, CLIP_N, CLIP_FRAMES + fl - 1, "fused")
    if chunk < 1 or launches["temporal_pair"] != CLIP_N \
            or launches["expand_score2"] != n_levels * -(-CLIP_N // chunk):
        raise AssertionError(f"batch_clips: chunk {chunk}, {launches}: expected temporal_pair "
                             f"once per clip with an empty carry")
    q_pc = stats["Q_per_ch"]
    if q_pc.shape != (n_levels, 2, CLIP_N, CLIP_FRAMES) or not np.all(np.isfinite(q_pc)):
        raise AssertionError(f"batch_clips: Q_per_ch {q_pc.shape}")
    per_pair = [fv.predict(test[i], ref[i], dim_order="HWCF", frames_per_second=FPS)[0]
                for i in range(CLIP_N)]
    streamed_fv = fvt.fvvdp(display_name="standard_fhd", block_frames=8)
    (streamed, _), stream_launches = counted(lambda: streamed_fv.predict_batch(test, ref, **call))
    n_blocks = -(-CLIP_FRAMES // 8)
    err_pp, err_st = worst(jods, per_pair), worst(streamed, per_pair)
    if not err_pp <= BATCH_TOL or not err_st <= BATCH_TOL \
            or stream_launches["temporal_pair"] != CLIP_N * n_blocks:
        raise AssertionError(f"batch_clips: JODs {jods}, streamed {streamed} "
                             f"({stream_launches}), per-pair predict {per_pair}")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, warm_s = warm_seconds(lambda: fv.predict_batch(test, ref, **call))
    peak = torch.cuda.max_memory_allocated()
    loop_times, loop_s = warm_seconds(lambda: [
        fv.predict(test[i], ref[i], dim_order="HWCF", frames_per_second=FPS)
        for i in range(CLIP_N)])
    emit(dict(phase="batch_clips", nvidia_smi=smi, clips=CLIP_N, shape=[HD_H, HD_W, 1, CLIP_FRAMES],
              chunk=chunk, jods=jods.tolist(), per_pair_jods=per_pair, streamed_jods=streamed.tolist(),
              max_abs_vs_predict=err_pp, max_abs_streamed_vs_predict=err_st,
              q_per_ch_shape=list(q_pc.shape), warm_s_runs=times, warm_s_median=warm_s,
              frames_per_s=CLIP_N * CLIP_FRAMES / warm_s, loop_s_median=loop_s,
              loop_frames_per_s=CLIP_N * CLIP_FRAMES / loop_s, peak_bytes=peak,
              resident_bytes_before=resident,
              peak_bytes_per_px_frame=(peak - resident) / (chunk * CLIP_FRAMES * HD_H * HD_W),
              launches=launches,
              streamed_launches=stream_launches))
    return launches, (test[:1], ref[:1], jods[:1], q_pc[:, :, :1])


def batch_foveated_phase(dev, smi, test, ref):
    """The 64 images foveated: one gaze shared by all pairs (its tables built
    once, band_score2_fov), then a gaze per pair (mov_score, no table)."""
    fv = fvt.fvvdp(display_name="standard_fhd", foveated=True)
    core = fv._get_core(IMG_W, IMG_H, with_heatmap=False)
    shared = np.array([150.0, 100.0], np.float32)
    rng = np.random.default_rng(5)
    per_pair = (rng.random((IMG_N, 2)) * [IMG_W - 1, IMG_H - 1]).astype(np.float32)
    out, all_launches, checked = {}, {}, {}
    for mode, gaze, must, none in (
            ("shared_gaze", shared, ("gausspyr_reduce", "expand_contrast", "band_score2_fov"),
             ("mov_score",)),
            ("gaze_per_pair", per_pair, ("gausspyr_reduce", "expand_contrast", "mov_score"),
             ("band_score2_fov",))):
        (jods, _), launches = counted(lambda: fv.predict_batch(
            test, ref, dim_order="BHWC", fixation_point=gaze))
        expect_launches(f"batch_foveated {mode}", launches, must, not_launched(must))
        tables = len(core._fov_table_cache)
        if tables != (1 if mode == "shared_gaze" else 0):
            raise AssertionError(f"batch_foveated {mode}: {tables} table sets resident")
        pp = [fv.predict(test[i], ref[i], dim_order="HWC",
                         fixation_point=gaze if gaze.ndim == 1 else gaze[i][None])[0]
              for i in range(N_CHECKED)]
        err = worst(jods[:N_CHECKED], pp)
        if not err <= BATCH_TOL or not np.all(np.isfinite(jods)):
            raise AssertionError(f"batch_foveated {mode}: {jods[:N_CHECKED]} vs per-pair "
                                 f"predict {pp}")
        times, warm_s = warm_seconds(lambda: fv.predict_batch(
            test, ref, dim_order="BHWC", fixation_point=gaze))
        out[mode] = dict(jods_checked=jods[:N_CHECKED].tolist(), max_abs_vs_predict=err,
                         warm_s_runs=times, warm_s_median=warm_s, pairs_per_s=IMG_N / warm_s,
                         table_sets_resident=tables, launches=launches)
        all_launches[mode] = launches
        checked[mode] = (gaze if gaze.ndim == 1 else gaze[:N_CHECKED], jods[:N_CHECKED])
    emit(dict(phase="batch_foveated", nvidia_smi=smi, pairs=IMG_N, shape=[IMG_H, IMG_W, 3],
              table_bytes=core.fov_table_bytes(), **out))
    fv.load_state(fv.parameters, fv._luts)
    return all_launches, checked


def ablation_video_phase(dev, smi, test_v, ref_v):
    """The 4K clip with do_temporal_channels=False: its frames scored as
    images, no temporal kernel; a 1080p 8-frame clip, for the CPU check."""
    video_kw = dict(dim_order="HWCF", frames_per_second=FPS)
    fv = fvt.fvvdp(display_name="standard_4k", do_temporal_channels=False)
    must = ("gausspyr_reduce", "expand_score2")
    (q, stats), launches = counted(lambda: fv.predict(test_v, ref_v, **video_kw))
    expect_launches("ablation_video", launches, must, not_launched(must))
    q_pc = stats["Q_per_ch"]
    if not np.isfinite(q) or not np.all(q_pc[:, 1] == 0.0) or not np.all(np.isfinite(q_pc)):
        raise AssertionError(f"ablation 4K clip: JOD {q}, transient rows not 0")
    chunk = fv._pick_chunk(H, W, N_FRAMES, 1, "fused",
                           importlib.import_module("fovvideovdp_tpu_torch.fvvdp")._IMAGE_STACK_BYTES)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, warm_s = warm_seconds(lambda: fv.predict(test_v, ref_v, **video_kw))
    peak = torch.cuda.max_memory_allocated()
    hd_t, hd_r = synth_clip(HD_H, HD_W, HEAT_FRAMES)
    q_hd, _ = fvt.fvvdp(display_name="standard_fhd", do_temporal_channels=False).predict(
        hd_t, hd_r, **video_kw)
    emit(dict(phase="ablation_video", nvidia_smi=smi, jod=q, chunk=chunk, warm_s_runs=times,
              warm_s_median=warm_s, fps=N_FRAMES / warm_s, peak_bytes=peak,
              resident_bytes_before=resident,
              peak_bytes_per_px_frame=(peak - resident) / (chunk * H * W), launches=launches,
              jod_1080p=q_hd))
    return launches, q, (hd_t, hd_r, q_hd)


def batch_vs_cpu_phase(smi, images, clip, foveated, hd_clip):
    """The card's results of phase 8c against device="cpu" on the same
    inputs: 8 images, the first 1080p clip (JOD and Q_per_ch), 8 images in
    each foveated gaze mode, the 1080p ablation clip.  Run after every
    timing of the phase, which the CPU's threads would slow.  Returns the
    CPU's JODs of the images, the clip and the ablation clip."""
    img_t, img_r, img_card = images
    clip_t, clip_r, clip_card, clip_q = clip
    hd_t, hd_r, hd_card = hd_clip
    fhd = functools.partial(fvt.fvvdp, display_name="standard_fhd", device="cpu")
    t0 = time.perf_counter()
    img_cpu, _ = fhd().predict_batch(img_t, img_r, dim_order="BHWC")
    clip_cpu, clip_stats = fhd().predict_batch(clip_t, clip_r, dim_order="BHWCF",
                                               frames_per_second=FPS)
    fov = {mode: fhd(foveated=True).predict_batch(img_t, img_r, dim_order="BHWC",
                                                  fixation_point=gaze)[0]
           for mode, (gaze, _) in foveated.items()}
    hd_cpu, _ = fhd(do_temporal_channels=False).predict(hd_t, hd_r, dim_order="HWCF",
                                                       frames_per_second=FPS)
    errs = dict(batch_images=worst(img_card, img_cpu), batch_clips=worst(clip_card, clip_cpu),
                **{f"batch_foveated_{mode}": worst(card, fov[mode])
                   for mode, (_, card) in foveated.items()},
                ablation_1080p=abs(hd_card - hd_cpu))
    emit(dict(phase="batch_vs_cpu", nvidia_smi=smi, max_abs_jod=errs,
              clip_q_per_ch_max_abs=worst(clip_q, clip_stats["Q_per_ch"]),
              cpu_s=time.perf_counter() - t0))
    bad = {case: err for case, err in errs.items() if not err <= BATCH_TOL}
    if bad:
        raise AssertionError(f"batch_vs_cpu: card against CPU over {BATCH_TOL}: {bad}")
    return img_cpu, float(clip_cpu[0]), hd_cpu


def host_resident_batch_phase(dev, smi, images, clip, hd_clip, test_v, ref_v, q_4k):
    """The host-resident paths of phase 8c, with the array source's
    residency limit at 0: a batch stays on the host and goes up a chunk at a
    time (_upload_bcfhw), the ablation's frames a chunk at a time through
    the pinned staging buffers with the next chunk prefetched.  Each against
    the CPU on the inputs of the cases above, the 4K ablation against its
    resident run.  Returns each case's launches."""
    img_t, img_r, img_cpu = images
    clip_t, clip_r, clip_cpu = clip
    hd_t, hd_r, hd_cpu = hd_clip
    video_kw = dict(dim_order="HWCF", frames_per_second=FPS)
    clip_kw = dict(dim_order="BHWCF", frames_per_second=FPS)
    fhd = functools.partial(fvt.fvvdp, display_name="standard_fhd")
    vsrc = importlib.import_module("fovvideovdp_tpu_torch.video_source")
    runs = (
        # (case, call, CPU JOD(s), kernels that must launch, kernels that must not)
        ("images_chunks_of_3", lambda: fhd(block_frames=3).predict_batch(
            img_t, img_r, dim_order="BHWC")[0], img_cpu,
         ("gausspyr_reduce", "expand_score2"), ("temporal_pair",)),
        ("clip_whole", lambda: fhd().predict_batch(clip_t, clip_r, **clip_kw)[0], [clip_cpu],
         ("gausspyr_reduce", "expand_score2", "temporal_pair"), ("expand_contrast",)),
        ("clip_streamed", lambda: fhd(block_frames=8).predict_batch(
            clip_t, clip_r, **clip_kw)[0], [clip_cpu],
         ("gausspyr_reduce", "expand_score2", "temporal_pair"), ("expand_contrast",)),
        ("ablation_1080p", lambda: [fhd(do_temporal_channels=False).predict(
            hd_t, hd_r, **video_kw)[0]], [hd_cpu],
         ("gausspyr_reduce", "expand_score2"), ("temporal_pair",)),
        ("ablation_1080p_chunks_of_3", lambda: [fhd(do_temporal_channels=False, block_frames=3)
                                                .predict(hd_t, hd_r, **video_kw)[0]], [hd_cpu],
         ("gausspyr_reduce", "expand_score2"), ("temporal_pair",)),
    )
    out, all_launches = {}, {}
    fvt.fvvdp_video_source_array.DEVICE_PRELOAD_LIMIT_BYTES = 0
    try:
        pb = vsrc.PairBatch(img_t, img_r, "BHWC", 0, None, None, dev)
        src = fvt.fvvdp_video_source_array(hd_t, hd_r, FPS, dim_order="HWCF", device=dev)
        if pb._t.device.type != "cpu" or src.resident:
            raise AssertionError("host_resident_batch: the residency limit of 0 was not applied")
        del pb, src
        for case, call, want, must, none in runs:
            got, launches = counted(call)
            expect_launches(f"host_resident_batch {case}", launches, must, none)
            err = worst(got, want)
            if not err <= BATCH_TOL or not np.all(np.isfinite(got)):
                raise AssertionError(f"host_resident_batch {case}: card {got} vs CPU {want}")
            out[case] = dict(jods=np.asarray(got, np.float64).tolist(), max_abs_vs_cpu=err,
                             launches=launches)
            all_launches[case] = launches
        # the 4K ablation streamed from the host: chunks of at most a block
        fv4k = fvt.fvvdp(display_name="standard_4k", do_temporal_channels=False)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (q_host, stats), launches = counted(lambda: fv4k.predict(test_v, ref_v, **video_kw))
        peak = torch.cuda.max_memory_allocated()
        q_pc = stats["Q_per_ch"]
        expect_launches("host_resident_batch ablation_4k", launches,
                        ("gausspyr_reduce", "expand_score2"), ("temporal_pair",))
        n_levels = fv4k._get_core(W, H).plan.height
        chunks = launches["expand_score2"] // n_levels
        if not abs(q_host - q_4k) <= BATCH_TOL or not np.all(q_pc[:, 1] == 0.0) \
                or chunks < -(-N_FRAMES // 32):
            raise AssertionError(f"host_resident_batch ablation_4k: JOD {q_host} vs resident "
                                 f"{q_4k}, {chunks} chunks, {launches}")
        out["ablation_4k"] = dict(jod=q_host, resident_jod=q_4k, abs_vs_resident=abs(q_host - q_4k),
                                  chunks=chunks, peak_bytes=peak,
                                  resident_bytes_before=resident, launches=launches)
        all_launches["ablation_4k"] = launches
    finally:
        fvt.fvvdp_video_source_array.DEVICE_PRELOAD_LIMIT_BYTES = None
    emit(dict(phase="host_resident_batch", nvidia_smi=smi, **out))
    return all_launches


def batch_phases(dev, smi, test_v, ref_v):
    """Phase 8c, each raising on failure: the timed cases on the card, their
    check against the CPU, then the host-resident cases against the CPU's
    JODs.  Returns each case's launches."""
    test, ref = image_batch(IMG_N, IMG_H, IMG_W)
    launches = {}
    launches["batch_images"], img_card = batch_images_phase(
        dev, smi, fvt.fvvdp(display_name="standard_fhd"), test, ref)
    torch.cuda.empty_cache()
    launches["batch_clips"], clip = batch_clips_phase(dev, smi)
    torch.cuda.empty_cache()
    fov_launches, foveated = batch_foveated_phase(dev, smi, test, ref)
    for mode, counts in fov_launches.items():
        launches[f"batch_foveated_{mode}"] = counts
    torch.cuda.empty_cache()
    launches["ablation_video"], q_4k, hd_clip = ablation_video_phase(dev, smi, test_v, ref_v)
    torch.cuda.empty_cache()
    images = (test[:N_CHECKED], ref[:N_CHECKED])
    img_cpu, clip_cpu, hd_cpu = batch_vs_cpu_phase(smi, images + (img_card,), clip, foveated,
                                                   hd_clip)
    for case, counts in host_resident_batch_phase(
            dev, smi, images + (img_cpu,), clip[:2] + (clip_cpu,), hd_clip[:2] + (hd_cpu,),
            test_v, ref_v, q_4k).items():
        launches[f"host_resident_{case}"] = counts
    torch.cuda.empty_cache()
    return launches

# ---------------------------------------------------------------------------
# 8d. the ablations and options, and the CSF cache's search order
# ---------------------------------------------------------------------------

OPT_H, OPT_W = 540, 960   # the card-against-CPU size of phase 8d (the CPU's
                          # composition of a 1080p clip takes ~4x as long)
OPT_TOL, OPT_TOL_FOV = 1e-4, 1e-3
KERNEL_ROUTE = ("gausspyr_reduce", "temporal_pair")


def equirect(w, h):
    return fvt.fvvdp_content_mapping_equirect(w, h)


# The four configurations phase 8d drives at full width on the 4K clip: the
# metric's options, the fixation point, and the kernels JAX's gating
# (fovvideovdp_tpu/core.py:418-449) launches for them.
OPT_CONFIGS = {
    # another adaptation and log contrast: the Laplacian decomposition of
    # the reduce kernel's pyramid, composed in tensor operations
    "gpyr2_log": (dict(parameter_overrides={"local_adapt": "gpyr2", "contrast": "log"}),
                  None, KERNEL_ROUTE),
    # a masking ablation under gpyr with Weber contrast: expand_contrast, no scorer
    "masking_pu_dilate": (dict(parameter_overrides={
        "masking_model": "contrast_difference_perc_norm", "pu_dilate": 0.5}),
        None, KERNEL_ROUTE + ("expand_contrast",)),
    # foveated 360 content: a gaze per frame from the one point, no tables,
    # never mov_score
    "boundary_content_mapping": (dict(ignore_boundary_pixels=True, foveated=True,
                                      content_mapping=equirect(W, H)),
                                 np.array([W // 2, H // 2]),
                                 KERNEL_ROUTE + ("expand_contrast",)),
    # a generated LUT (no packaged .npz for sigma = -2): the default route
    "csf_sigma": (dict(parameter_overrides={"csf_sigma": -2.0}), None,
                  KERNEL_ROUTE + ("expand_score2",)),
}


def warped_lut(omega, n=12):
    """A CSF LUT in the reference's cache format on grids warped away from
    uniform (tests/test_round2_fixes.py:104-109), its S from the analytic
    model: what a user's .mat cache may hold."""
    from fovvideovdp_tpu_torch import csf_generator

    def warp(lo, hi):
        u = np.linspace(0.0, 1.0, n)
        return (lo + (hi - lo) * u ** 1.35).astype(np.float32)
    Y_log, rho_log, ecc_sqrt = warp(np.log2(1e-3), np.log2(1e4)), warp(-4.0, 6.0), \
        warp(0.0, np.sqrt(120.0))
    Y, rho, ecc = 2.0 ** Y_log, 2.0 ** rho_log, ecc_sqrt ** 2
    Yg, rg, eg = np.meshgrid(Y, rho, ecc, indexing="ij")
    S = np.maximum(csf_generator.sensitivity(rg, omega, Yg, eg, -1.5, 0.604562), 1e-4)
    return dict(Y=Y, rho=rho, ecc=ecc, Y_log=Y_log, rho_log=rho_log, ecc_sqrt=ecc_sqrt,
                S_log=np.log2(S).reshape(n, n, n).astype(np.float32))


def mat_luts(tmp, device):
    """Both channels' warped LUTs written as .mat caches under ``tmp`` and
    read back through CSFCache's search (key sigma = -1.7, no .npz)."""
    import scipy.io as sio
    from fovvideovdp_tpu_torch import csf
    for omega in (0.0, 5.0):
        sio.savemat(os.path.join(tmp, csf.cache_key(omega, -1.7, 0.604562) + "_gpu0.mat"),
                    {"lut": {k: np.asarray(v, np.float64)
                             for k, v in warped_lut(omega).items()}})
    cache = csf.CSFCache(device, extra_dirs=[tmp])
    luts = [cache.get(omega, -1.7, 0.604562) for omega in (0.0, 5.0)]
    if any(all(l["_uniform"].values()) for l in luts):
        raise AssertionError("the .mat LUTs were not read on their non-uniform grids")
    return luts


def option_groups(w, h):
    """Every option group of phase 8d's card-against-CPU check: (fvvdp
    keyword arguments, predict keyword arguments, foveated)."""
    mid = np.array([w // 3, h // 2])
    rows = sweeping_gaze(w, h, HEAT_FRAMES)
    la = lambda v, **o: dict(parameter_overrides=dict(local_adapt=v, **o))  # noqa: E731
    return {
        "simple": (la("simple"), {}, False), "global": (la("global"), {}, False),
        "gpyr0": (la("gpyr0"), {}, False), "gpyr2": (la("gpyr2"), {}, False),
        "log": (dict(parameter_overrides={"contrast": "log"}), {}, False),
        "log_gpyr0": (la("gpyr0", contrast="log"), {}, False),
        "contrast_difference": (dict(parameter_overrides={
            "masking_model": "contrast_difference"}), {}, False),
        "contrast_difference_perc_norm": (dict(parameter_overrides={
            "masking_model": "contrast_difference_perc_norm"}), {}, False),
        "pu_dilate": (dict(parameter_overrides={"pu_dilate": 0.5}), {}, False),
        "ignore_boundary_pixels": (dict(ignore_boundary_pixels=True), {}, False),
        "band_callback": (dict(band_callback=lambda *a: None), {}, False),
        "content_mapping": (dict(foveated=True, content_mapping=equirect(w, h)),
                            dict(fixation_point=mid), True),
        "simple_fixed_gaze": (dict(foveated=True, **la("simple")),
                              dict(fixation_point=mid), True),
        "simple_moving_gaze": (dict(foveated=True, **la("simple")),
                               dict(fixation_point=rows), True),
        "raw_heatmap_boundary": (dict(heatmap="raw", ignore_boundary_pixels=True), {}, False),
        "csf_sigma": (dict(parameter_overrides={"csf_sigma": -2.0}), {}, False),
        "k_cm": (dict(parameter_overrides={"k_cm": 0.5}), {}, False),
        "mat_non_uniform": ("mat", {}, False),
    }


def options_vs_cpu(dev, smi, tmp):
    """Each option group at OPT_H x OPT_W x 8 frames on the card against
    device="cpu" (JOD within OPT_TOL, OPT_TOL_FOV when foveated), with the
    card's peak bytes per pixel-frame of the block; predict_batch of 4
    images and predict_traced of one image under log contrast likewise."""
    test_v, ref_v = synth_clip(OPT_H, OPT_W, HEAT_FRAMES)
    video_kw = dict(dim_order="HWCF", frames_per_second=FPS)
    fvvdp_mod = importlib.import_module("fovvideovdp_tpu_torch.fvvdp")
    out, bad = {}, {}
    luts = {d: mat_luts(tmp, d) for d in (dev, "cpu")}
    half = HEAT_FRAMES // 2
    for group, (kw, call, foveated) in option_groups(OPT_W, OPT_H).items():
        jods = {}
        for d in (dev, "cpu"):
            fv = fvt.fvvdp(display_name="standard_fhd", device=d,
                           **({} if kw == "mat" else kw))
            if kw == "mat":
                fv.load_state(fv.parameters, luts[d])
            jods[d], _ = fv.predict(test_v, ref_v, **video_kw, **call)
            if d != dev:
                continue
            # the block's bytes per pixel-frame: the slope of the peak between
            # blocks of 8 and 4 frames, after a first call that built what
            # stays (fixed-gaze tables), so that nothing fixed counts
            peaks, q_blocks = [], []
            for bf in (None, half):
                fv.block_frames = bf
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                q_blocks.append(fv.predict(test_v, ref_v, **video_kw, **call)[0])
                peaks.append(torch.cuda.max_memory_allocated() - resident)
            fv.block_frames = None
            core = fv._get_core(OPT_W, OPT_H)
            route = fvvdp_mod._memory_route(core, foveated and "fixed" not in group)
            B = fv._pick_block_size(OPT_H, OPT_W, HEAT_FRAMES, route)
        err = abs(jods[dev] - jods["cpu"])
        out[group] = dict(jod=jods[dev], jod_cpu=jods["cpu"], abs_err=err,
                          jod_blocks_of_4=q_blocks[1], route=core.route, memory_route=route,
                          block_frames=B, peak_bytes=peaks,
                          peak_bytes_per_px_frame=peaks[0] / (B * OPT_H * OPT_W),
                          block_bytes_per_px_frame=(peaks[0] - peaks[1])
                          / ((B - half) * OPT_H * OPT_W))
        if not err <= (OPT_TOL_FOV if foveated else OPT_TOL) \
                or not abs(q_blocks[1] - jods[dev]) <= 1e-5:
            bad[group] = (err, q_blocks)
    img_t, img_r = test_v[..., 0], ref_v[..., 0]
    log = dict(parameter_overrides={"contrast": "log"})
    batch_t = np.stack([img_t, np.roll(img_t, 7, axis=1), img_r, np.roll(img_r, 3, axis=0)])
    batch_r = np.stack([img_r, img_r, np.roll(img_r, 5, axis=1), img_r])
    jods = {d: fvt.fvvdp(display_name="standard_fhd", device=d, **log).predict_batch(
        batch_t, batch_r, dim_order="BHWC")[0] for d in (dev, "cpu")}
    err = float(np.max(np.abs(jods[dev] - jods["cpu"])))
    out["batch_log"] = dict(jods=jods[dev].tolist(), jods_cpu=jods["cpu"].tolist(),
                            abs_err=err)
    if not err <= OPT_TOL:
        bad["batch_log"] = err
    x = img_t.astype(np.float32) / 255.0
    y = img_r.astype(np.float32) / 255.0
    jods = {d: float(fvt.fvvdp(display_name="standard_fhd", device=d, **log).predict_traced(
        x, y, dim_order="HWC")) for d in (dev, "cpu")}
    err = abs(jods[dev] - jods["cpu"])
    out["traced_log"] = dict(jod=jods[dev], jod_cpu=jods["cpu"], abs_err=err)
    if not err <= OPT_TOL:
        bad["traced_log"] = err
    return out, bad


def options_phase(dev, smi, test_v, ref_v):
    """Phase 8d: the four OPT_CONFIGS on the 60-frame 4K clip (JOD, first and
    warm wall time, block frames, peak bytes per pixel-frame, launches per
    kernel, each launch JAX's gating forbids an error; the generated LUT's
    seconds), then every option group against the CPU.  Returns each
    configuration's launches."""
    video_kw = dict(dim_order="HWCF", frames_per_second=FPS)
    fvvdp_mod = importlib.import_module("fovvideovdp_tpu_torch.fvvdp")
    launches = {}
    for name, (kw, gaze, must) in OPT_CONFIGS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fv = fvt.fvvdp(display_name="standard_4k", **kw)
        build_s = time.perf_counter() - t0
        call = dict(video_kw) if gaze is None else dict(video_kw, fixation_point=gaze)
        t0 = time.perf_counter()
        (q, stats), counts = counted(lambda: fv.predict(test_v, ref_v, **call))
        first_s = time.perf_counter() - t0
        launches[name] = counts
        expect_launches(f"options {name}", counts, must, not_launched(must))
        core = fv._get_core(W, H)
        q_pc = stats["Q_per_ch"]
        if not np.isfinite(q) or not 0.0 <= q <= 10.0 or not np.all(np.isfinite(q_pc)) \
                or q_pc.shape != (core.plan.height, 2, N_FRAMES):
            raise AssertionError(f"options {name}: JOD {q}, Q_per_ch {q_pc.shape}")
        if core._fov_table_cache or core.fov_table_bytes():
            raise AssertionError(f"options {name}: fixed-gaze tables were built")
        route = fvvdp_mod._memory_route(core, gaze is not None)
        B = fv._pick_block_size(H, W, N_FRAMES, route)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times, warm_s = warm_seconds(lambda: fv.predict(test_v, ref_v, **call), runs=2)
        peak = torch.cuda.max_memory_allocated() - resident
        emit(dict(phase="options", config=name, nvidia_smi=smi, jod=q, first_call_s=first_s,
                  warm_s_runs=times, warm_s_median=warm_s, fps=N_FRAMES / warm_s,
                  route=core.route, memory_route=route, block_frames=B, peak_bytes=peak,
                  peak_bytes_per_px_frame=peak / (B * H * W), launches=counts,
                  metric_build_s=build_s))
        del fv, core
        torch.cuda.empty_cache()
    from fovvideovdp_tpu_torch import csf_generator
    t0 = time.perf_counter()
    csf_generator.precompute_lut(0.0, -2.0, 0.604562)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        groups, bad = options_vs_cpu(torch.device("cuda"), smi, tmp)
    emit(dict(phase="options_vs_cpu", nvidia_smi=smi, shape=[OPT_H, OPT_W, HEAT_FRAMES],
              generate_lut_s=gen_s, groups=groups, seconds=time.perf_counter() - t0))
    if bad:
        raise AssertionError(f"options_vs_cpu: card against CPU over the bars: {bad}")
    torch.cuda.empty_cache()
    return launches

# ---------------------------------------------------------------------------
# 8e. checkpoint and resume of the streaming loop, PU21-PSNR, the cores' key,
# update_device and the CLI's extras
# ---------------------------------------------------------------------------

EXTRA_H, EXTRA_W = 1080, 1920     # the cores' key and update_device
MAIN_KERNELS = ("gausspyr_reduce", "temporal_pair", "expand_score2")


class BlockLog(fvt.fvvdp_video_source_array):
    """The array source, logging the luminance blocks it serves and raising
    on the call after the ``limit``-th: a crash mid-video."""

    def __init__(self, *a, limit=None, **kw):
        super().__init__(*a, **kw)
        self.limit, self.calls, self.blocks = limit, 0, []

    def get_luminance_block(self, start, count):
        self.calls += 1
        if self.limit is not None and self.calls > self.limit:
            raise RuntimeError("simulated crash")
        self.blocks.append((int(start), int(count)))
        return super().get_luminance_block(start, count)


def check_resume_launches(counts, n_blocks, n_levels):
    """The resumed run scores its remaining blocks on the default route and
    nothing else."""
    want = dict(gausspyr_reduce=n_levels * n_blocks, temporal_pair=n_blocks,
                expand_score2=n_levels * n_blocks)
    if any(v != want.get(k, 0) for k, v in counts.items()):
        raise AssertionError(f"resumed run: launches {counts}, expected {want}")


def timed_checkpoint_io(fv, seconds):
    """Wrap the metric's checkpoint save and load: each call's seconds (the
    save's include the copy of Q_per_ch and the carry off the card)."""
    for name in ("_save_checkpoint", "_load_checkpoint"):
        real = getattr(fv, name)

        def timed(*a, _real=real, _name=name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*a)
            seconds.setdefault(_name, []).append(time.perf_counter() - t0)
            return out
        setattr(fv, name, timed)


def checkpoint_phase(dev, smi, test_v, ref_v):
    """The 4K clip uninterrupted, then crashed after its first block with a
    checkpoint after every block, then resumed (bit for bit, only the
    remaining block fetched and scored), then resumed from a copy of the
    same file in blocks of 16 (rtol 1e-5); the file's bytes, the save's and
    the load's seconds, and the warm wall time with a checkpoint after every
    block beside the time without one.  Returns each run's launches."""
    fv = fvt.fvvdp(display_name="standard_4k")

    def source(limit=None):
        return BlockLog(test_v, ref_v, FPS, dim_order="HWCF",
                        display_photometry=fv.display_photometry, device=dev, limit=limit)
    launches = {}
    (q_full, s_full), launches["checkpoint_uninterrupted"] = counted(
        lambda: fv.predict_video_source(source()))
    if not abs(q_full - GOLDEN_SYNTH_Q) <= JOD_TOL:
        raise AssertionError(f"checkpoint phase: 4K clip JOD {q_full}")
    B = fv._pick_block_size(H, W, N_FRAMES)
    if B >= N_FRAMES:
        raise AssertionError(f"the 4K clip fits one block of {B}: nothing to resume")
    n_levels = s_full["Q_per_ch"].shape[0]
    io_s = {}
    timed_checkpoint_io(fv, io_s)
    with tempfile.TemporaryDirectory(prefix="fvvdp_ckpt_") as tmp:
        ckpt = os.path.join(tmp, "clip.ckpt")
        crashing = source(limit=2)     # the probe, block 0, then the crash
        cuda_ops.reset_launch_counts()
        try:
            fv.predict_video_source(crashing, checkpoint_path=ckpt, checkpoint_every=1)
            raise AssertionError("the crashing source did not crash")
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
        launches["checkpoint_crash"] = cuda_ops.launch_counts()
        if not os.path.isfile(ckpt):
            raise AssertionError("the crash left no checkpoint")
        ckpt_bytes = os.path.getsize(ckpt)
        shutil.copyfile(ckpt, ckpt + ".copy")
        with np.load(ckpt) as d:
            pos = int(d["pos"])
        remaining = list(range(pos, N_FRAMES, B))
        resumed = source()
        (q_res, s_res), counts = counted(
            lambda: fv.predict_video_source(resumed, checkpoint_path=ckpt, checkpoint_every=1))
        launches["checkpoint_resume"] = counts
        emit(dict(phase="checkpoint_resume_video", nvidia_smi=smi, jod=q_full, jod_resumed=q_res,
                  block_frames=B, checkpoint_pos=pos, checkpoint_bytes=ckpt_bytes,
                  save_s=io_s.get("_save_checkpoint"), load_s=io_s.get("_load_checkpoint"),
                  resumed_blocks=resumed.blocks, crash_launches=launches["checkpoint_crash"],
                  launches=counts))
        if q_res != q_full or not np.array_equal(s_res["Q_per_ch"], s_full["Q_per_ch"]):
            raise AssertionError(f"resumed JOD {q_res} vs uninterrupted {q_full}, Q_per_ch "
                                 f"max diff {np.abs(s_res['Q_per_ch'] - s_full['Q_per_ch']).max()}")
        if [s for s, n in resumed.blocks if n > 1] != remaining or os.path.exists(ckpt):
            raise AssertionError(f"resumed run: blocks {resumed.blocks}, expected {remaining} "
                                 f"after the probe; file left: {os.path.exists(ckpt)}")
        check_resume_launches(counts, len(remaining), n_levels)
        # a process that picks another block size resumes the same file
        os.replace(ckpt + ".copy", ckpt)
        fv16 = fvt.fvvdp(display_name="standard_4k", block_frames=16)
        resumed16 = source()
        (q_16, s_16), launches["checkpoint_resume_b16"] = counted(
            lambda: fv16.predict_video_source(resumed16, checkpoint_path=ckpt))
        rel = float(np.max(np.abs(s_16["Q_per_ch"] - s_full["Q_per_ch"])
                           / np.maximum(np.abs(s_full["Q_per_ch"]), 1e-30)))
        if not np.allclose(s_16["Q_per_ch"], s_full["Q_per_ch"], rtol=1e-5, atol=0) \
                or [s for s, n in resumed16.blocks if n > 1] != list(range(pos, N_FRAMES, 16)):
            raise AssertionError(f"resume in blocks of 16: Q_per_ch rel err {rel}, "
                                 f"blocks {resumed16.blocks}")
        # warm wall time: a checkpoint after every block against none
        walls = {}
        for mode in ("none", "every_block", "every_block", "none"):
            kw = {} if mode == "none" else dict(checkpoint_path=ckpt, checkpoint_every=1)
            walls.setdefault(mode, []).append(warm_seconds(
                lambda: fv.predict_video_source(source(), **kw), runs=2)[1])
    emit(dict(phase="checkpoint_walls", nvidia_smi=smi, jod_resumed_b16=q_16,
              resumed_b16_max_rel_q_per_ch=rel, warm_s_no_checkpoint=walls["none"],
              warm_s_checkpoint_every_block=walls["every_block"], saves_per_run=1,
              order="none, every block, every block, none",
              save_s_all=io_s.get("_save_checkpoint"), load_s_all=io_s.get("_load_checkpoint"),
              launches_b16=launches["checkpoint_resume_b16"]))
    return launches


def pu_psnr_phase(dev, smi, test_v, ref_v):
    """PU21-PSNR of the 4K clip on the card (no kernel launches) against
    device="cpu" (|dB| <= 1e-3); warm seconds and fps."""
    kw = dict(dim_order="HWCF", frames_per_second=FPS)
    pp = fvt.pu_psnr()
    (q, stats), counts = counted(lambda: pp.predict(test_v, ref_v, **kw))
    times, warm_s = warm_seconds(lambda: pp.predict(test_v, ref_v, **kw))
    t0 = time.perf_counter()
    q_cpu, _ = fvt.pu_psnr(device="cpu").predict(test_v, ref_v, **kw)
    cpu_s = time.perf_counter() - t0
    emit(dict(phase="pu_psnr_video", nvidia_smi=smi, db=q, db_cpu=q_cpu, abs_err=abs(q - q_cpu),
              tolerance="|d dB| <= 1e-3", warm_s_runs=times, warm_s_median=warm_s,
              fps=N_FRAMES / warm_s, cpu_s=cpu_s, launches=counts))
    if any(counts.values()) or stats is not None or not np.isfinite(q) \
            or not abs(q - q_cpu) <= 1e-3:
        raise AssertionError(f"pu_psnr: card {q} dB vs CPU {q_cpu}, launches {counts}")
    return counts


def seeded_image(h, w, seed=5):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-25, 25, ref.shape), 0, 255).astype(np.uint8)
    return tst, ref


# each step sets one attribute on the metric of the step before it
# (ROADMAP's sequence of the cores' key)
KEY_STEPS = [("first call", {}), ("uint8 heatmap", {"heatmap_dtype": "uint8"}),
             ("boundary pixels", {"ignore_boundary_pixels": True}),
             ("foveated", {"foveated": True})]


def core_key_phase(dev, smi):
    """The sequence at 1080p on the card: each step's JOD and heatmap dtype
    those of a metric built fresh for it (|dJOD| <= 1e-6); then a step that
    replaces the foveated core frees its fixed-gaze tables."""
    tst, ref = seeded_image(EXTRA_H, EXTRA_W)
    fv = fvt.fvvdp(display_name="standard_fhd", heatmap="threshold")
    steps, kw, launches = [], {}, {}
    for name, attrs in KEY_STEPS:
        for k, v in attrs.items():
            setattr(fv, k, v)
        kw.update(attrs)
        (q, s), launches[name] = counted(lambda: fv.predict(tst, ref, dim_order="HWC"))
        q_f, s_f = fvt.fvvdp(display_name="standard_fhd", heatmap="threshold", **kw).predict(
            tst, ref, dim_order="HWC")
        steps.append(dict(step=name, jod=q, jod_fresh=q_f, dtype=str(s["heatmap"].dtype),
                          dtype_fresh=str(s_f["heatmap"].dtype)))
    core_fov = fv._get_core(EXTRA_W, EXTRA_H)
    table_bytes = core_fov.fov_table_bytes()
    held = bool(core_fov._fov_table_cache)
    gc.collect()                # the fresh metrics above, should a cycle hold them
    torch.cuda.synchronize()
    with_tables = torch.cuda.memory_allocated()
    fv.heatmap_dtype = "float16"                # a new core for the same resolution
    new_core = fv._get_core(EXTRA_W, EXTRA_H)
    new_core_tables = bool(new_core._fov_table_cache)
    cores = len(fv._cores)
    # the new core's own tensors leave with it, so that what was freed is
    # what the replaced core held
    fv._cores = {k: c for k, c in fv._cores.items() if c is not new_core}
    del new_core
    gc.collect()
    torch.cuda.synchronize()
    freed = with_tables - torch.cuda.memory_allocated()
    emit(dict(phase="core_key_sequence", nvidia_smi=smi, shape=[EXTRA_H, EXTRA_W], steps=steps,
              table_bytes=table_bytes, tables_held_before=held, freed_bytes=freed,
              tables_held_after=bool(core_fov._fov_table_cache), cores=cores,
              new_core_tables=new_core_tables, launches=launches))
    bad = [s for s in steps if not abs(s["jod"] - s["jod_fresh"]) <= 1e-6
           or s["dtype"] != s["dtype_fresh"]]
    if bad or [s["dtype"] for s in steps] != ["float16", "uint8", "uint8", "uint8"]:
        raise AssertionError(f"core key sequence: {steps}")
    if not held or core_fov._fov_table_cache or new_core_tables or not freed >= table_bytes:
        raise AssertionError(f"the replaced core's tables ({table_bytes} B, held {held}) "
                             f"freed {freed} B")
    return launches


def update_device_phase(dev, smi):
    """A metric built on the CPU scores a 1080p clip; moved to the card it
    scores as a metric built there (|dJOD| <= 1e-6), on the default route."""
    clip_t, clip_r = synth_clip(EXTRA_H, EXTRA_W, 8)
    kw = dict(dim_order="HWCF", frames_per_second=FPS)
    fv = fvt.fvvdp(display_name="standard_fhd", device="cpu")
    q_cpu, _ = fv.predict(clip_t, clip_r, **kw)
    fv.update_device("cuda")
    (q_moved, _), counts = counted(lambda: fv.predict(clip_t, clip_r, **kw))
    q_card, _ = fvt.fvvdp(display_name="standard_fhd").predict(clip_t, clip_r, **kw)
    on_card = all(v.is_cuda for lut in fv._luts for v in lut.values() if torch.is_tensor(v))
    emit(dict(phase="update_device", nvidia_smi=smi, shape=[EXTRA_H, EXTRA_W, 8], jod_cpu=q_cpu,
              jod_moved=q_moved, jod_card=q_card, luts_on_card=on_card, launches=counts))
    expect_launches("update_device", counts, MAIN_KERNELS, not_launched(MAIN_KERNELS))
    if not abs(q_moved - q_card) <= 1e-6 or not on_card or not abs(q_cpu - q_card) <= 1e-4:
        raise AssertionError(f"update_device: moved {q_moved}, card {q_card}, CPU {q_cpu}")
    return counts


def cli_extras_phase(dev, smi, test_v, ref_v, q_yuv=None):
    """run_fvvdp.main in-process on phase 4d's .yuv pair with both metrics and
    a checkpoint: the JOD is 4d's to 4 decimals, the PU21-PSNR that of
    pu_psnr on the same files, and no checkpoint file is left."""
    fv = fvt.fvvdp(display_name="standard_4k")
    frame_bytes = H * W * 3 // 2
    with tempfile.TemporaryDirectory(prefix="fvvdp_cli_") as tmp:
        n = min(N_FRAMES, int(0.8 * shutil.disk_usage(tmp).free // (2 * frame_bytes)))
        paths = [os.path.join(tmp, f"{tag}_{W}x{H}_8b_420_709_30fps.yuv") for tag in ("test", "ref")]
        for path, clip in zip(paths, (test_v, ref_v)):
            write_yuv420(path, clip[:, :, 0, :n])

        def file_source():
            return fvt.fvvdp_video_source_file(*paths, display_photometry="standard_4k",
                                               device=dev)
        if q_yuv is None or n != N_FRAMES:
            q_yuv, _ = fv.predict_video_source(file_source())
        db, _ = fvt.pu_psnr().predict_video_source(file_source())
        ckpt = os.path.join(tmp, "state.ckpt")
        out = io.StringIO()
        t0 = time.perf_counter()
        cuda_ops.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            rc = run_fvvdp.main(["--test", paths[0], "--ref", paths[1], "--display", "standard_4k",
                                 "--metrics", "fvvdp", "pu-psnr", "--checkpoint", ckpt])
        counts = cuda_ops.launch_counts()
        wall = time.perf_counter() - t0
        lines = out.getvalue().strip().splitlines()
        left = sorted(os.listdir(tmp))
    want = [f"FovVideoVDP={q_yuv:0.4f} [JOD]", f"PU21-PSNR={db:0.4f} [dB]"]
    emit(dict(phase="cli_extras", nvidia_smi=smi, frames=n, rc=rc, printed=lines, expected=want,
              wall_s=wall, files_left=left, launches=counts))
    if rc != 0 or lines[-2:] != want or any("ckpt" in f for f in left):
        raise AssertionError(f"cli extras: exit {rc}, printed {lines}, expected {want}, "
                             f"files {left}")
    expect_launches("cli extras", counts, MAIN_KERNELS, not_launched(MAIN_KERNELS))
    return counts


def extras_phases(dev, smi, test_v, ref_v, q_yuv=None):
    """Phase 8e.  Returns each case's launches."""
    launches = checkpoint_phase(dev, smi, test_v, ref_v)
    torch.cuda.empty_cache()
    launches["pu_psnr_video"] = pu_psnr_phase(dev, smi, test_v, ref_v)
    torch.cuda.empty_cache()
    for step, counts in core_key_phase(dev, smi).items():
        launches[f"core_key {step}"] = counts
    torch.cuda.empty_cache()
    launches["update_device"] = update_device_phase(dev, smi)
    torch.cuda.empty_cache()
    launches["cli_extras"] = cli_extras_phase(dev, smi, test_v, ref_v, q_yuv)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 8f. scoring over a mesh: two slots on the card, two processes on the card,
# and every visible card when there are several
# ---------------------------------------------------------------------------
MESH_TOL = 1e-6            # relative, JOD and Q_per_ch, mesh against one device
MESH_FRAMES = 8            # depth of the foveated and heatmap clips under the mesh
MP_PAIRS = 32              # 512x384 pairs per process of the two-process run
MP_TIMEOUT_S = 180         # the two processes' own limit
SCALE_PAIRS = 256          # predict_batch pairs of the multi-card run


def rel_err_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def counted_slots(fn, n_slots):
    """fn() with the launch counts set to 0 just before; the totals and each
    slot's counts read just after."""
    cuda_ops.reset_launch_counts()
    out = fn()
    return out, cuda_ops.launch_counts(), [cuda_ops.launch_counts(k) for k in range(n_slots)]


def sub_blocks(B, n_frames, n_slots, start=0):
    """How many sub-blocks each slot scores when blocks of B frames from
    ``start`` are split over n_slots (parallel.sharding.split_rows)."""
    subs = [0] * n_slots
    for pos in range(start, n_frames, B):
        for k, (a, b) in enumerate(split_rows(min(B, n_frames - pos), n_slots)):
            subs[k] += b > a
    return subs


def check_slot_launches(case, per_slot, subs, n_levels, per_level, others=()):
    """Each slot launched temporal_pair once per sub-block, each kernel of
    ``per_level`` once per level per sub-block, each of ``others`` at
    least once, and nothing else."""
    for k, (got, s) in enumerate(zip(per_slot, subs)):
        want = dict({name: n_levels * s for name in per_level}, temporal_pair=s)
        bad = {name: n for name, n in got.items()
               if (name in others and not n > 0)
               or (name not in others and n != want.get(name, 0))}
        if bad:
            raise AssertionError(f"{case}: slot {k} launched {got}, expected {want} "
                                 f"(and {others} > 0) for {s} sub-blocks")


class MeshBlockLog(fvt.fvvdp_video_source_array):
    """The array source, counting reads of more than one frame, whether a
    block on its device or a slot's frames (luminance_at), and raising on
    the read after the ``limit``-th: a crash mid-video under a mesh."""

    def __init__(self, *a, limit=None, **kw):
        super().__init__(*a, **kw)
        self.limit, self.reads, self.frames = limit, 0, []
        self.lock = __import__("threading").Lock()

    def _read(self, idx):
        if len(idx) > 1:
            with self.lock:
                self.reads += 1
                if self.limit is not None and self.reads > self.limit:
                    raise RuntimeError("simulated crash")
                self.frames.extend(int(i) for i in idx)

    def get_luminance_block(self, start, count):
        self._read(np.arange(start, start + count))
        return super().get_luminance_block(start, count)

    def luminance_at(self, indices, device):
        self._read(np.asarray(indices))
        return super().luminance_at(indices, device)


def mesh_video_phase(smi, test_v, ref_v, mesh):
    """The 60-frame 4K clip streamed over the mesh against the same metric
    without one: JOD and Q_per_ch within MESH_TOL (predicted bit for bit),
    the JOD against the reference's; launches per slot; warm walls in
    turns, fps and the peak."""
    fv = fvt.fvvdp(display_name="standard_4k", device="cuda:0")
    n_levels = fv._get_core(W, H).plan.height
    q_one, s_one = fv.predict(test_v, ref_v, dim_order="HWCF", frames_per_second=FPS)
    B = fv._pick_mesh_block(H, W, N_FRAMES, mesh)
    (q, s), totals, per_slot = counted_slots(lambda: fv.predict(
        test_v, ref_v, dim_order="HWCF", frames_per_second=FPS, mesh=mesh), mesh.size)
    subs = sub_blocks(B, N_FRAMES, mesh.size)
    check_slot_launches("mesh_video", per_slot, subs, n_levels,
                        ("gausspyr_reduce", "expand_score2"))
    err_q, err_pc = rel_err_max(q, q_one), rel_err_max(s["Q_per_ch"], s_one["Q_per_ch"])
    if not err_q <= MESH_TOL or not err_pc <= MESH_TOL or not abs(q - GOLDEN_SYNTH_Q) <= JOD_TOL:
        raise AssertionError(f"mesh_video: JOD {q} vs one card {q_one} ({err_q}), Q_per_ch "
                             f"{err_pc}, reference {GOLDEN_SYNTH_Q}")
    call = dict(dim_order="HWCF", frames_per_second=FPS)
    walls = {"mesh": [], "one": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for how in ("mesh", "one", "one", "mesh"):
        kw = dict(call, mesh=mesh) if how == "mesh" else call
        walls[how] += warm_seconds(lambda: fv.predict(test_v, ref_v, **kw), runs=2)[0]
    peak = torch.cuda.max_memory_allocated()
    warm = {k: float(np.median(v)) for k, v in walls.items()}
    # scoring a source already on the card: each slot converting its own
    # frames, against the blocks converted on the metric's device and each
    # slot's luminance copied from there (luminance_at turned off), in turns
    vs = fvt.fvvdp_video_source_array(test_v, ref_v, FPS, dim_order="HWCF",
                                      display_photometry=fv.display_photometry, device="cuda:0")
    vs_dev = fvt.fvvdp_video_source_array(test_v, ref_v, FPS, dim_order="HWCF",
                                          display_photometry=fv.display_photometry,
                                          device="cuda:0")
    vs_dev.luminance_at = None
    scores = {"slots": [], "device": []}
    for how in ("slots", "device", "device", "slots"):
        src = vs if how == "slots" else vs_dev
        scores[how] += warm_seconds(lambda: fv.predict_video_source(src, mesh=mesh), runs=2)[0]
    q_dev, _ = fv.predict_video_source(vs_dev, mesh=mesh)
    del vs, vs_dev
    if not rel_err_max(q_dev, q_one) <= MESH_TOL:
        raise AssertionError(f"mesh_video, luminance on the metric's device: {q_dev} vs {q_one}")
    emit(dict(phase="mesh_video", nvidia_smi=smi, slots=[str(d) for d in mesh.slots], jod=q,
              jod_one_card=q_one, reference_jod=GOLDEN_SYNTH_Q, rel_err_jod=err_q,
              rel_err_q_per_ch=err_pc, bit_for_bit=bool(q == q_one and np.array_equal(
                  s["Q_per_ch"], s_one["Q_per_ch"])),
              block_frames=B, sub_blocks_per_slot=subs, warm_s_runs=walls,
              warm_s_median=warm["mesh"], warm_s_median_one_card=warm["one"],
              fps=N_FRAMES / warm["mesh"], fps_one_card=N_FRAMES / warm["one"],
              order="mesh, one, one, mesh", peak_bytes=peak,
              score_s_runs=scores, score_s_median_slot_luminance=float(np.median(
                  scores["slots"])), score_s_median_device_luminance=float(np.median(
                      scores["device"])), jod_device_luminance=q_dev,
              launches=totals, launches_per_slot=per_slot))
    return totals, q_one


def mesh_clip_cases(smi, test_v, ref_v, mesh):
    """A fixed gaze, a moving gaze and a threshold heatmap on 8 frames of the
    clip, each against the same metric without the mesh."""
    sub_t = np.ascontiguousarray(test_v[..., :MESH_FRAMES])
    sub_r = np.ascontiguousarray(ref_v[..., :MESH_FRAMES])
    call = dict(dim_order="HWCF", frames_per_second=FPS)
    cases = {
        "mesh_fixed_gaze": (dict(foveated=True),
                            dict(fixation_point=np.array([W / 3, H / 3], np.float32)),
                            ("gausspyr_reduce", "expand_contrast", "band_score2_fov")),
        "mesh_moving_gaze": (dict(foveated=True),
                             dict(fixation_point=sweeping_gaze(W, H, MESH_FRAMES)),
                             ("gausspyr_reduce", "expand_contrast", "mov_score")),
        # the composition's launches per level are not fixed: each must launch
        "mesh_heatmap": (dict(heatmap="threshold"), {}, ()),
    }
    launches = {}
    for case, (kw, ckw, per_level) in cases.items():
        fv = fvt.fvvdp(display_name="standard_4k", device="cuda:0", **kw)
        n_levels = fv._get_core(W, H).plan.height
        q_one, s_one = fv.predict(sub_t, sub_r, **call, **ckw)
        B = fv._pick_mesh_block(H, W, MESH_FRAMES, mesh,
                                fvvdp_module()._memory_route(
                                    fv._get_core(W, H), case == "mesh_moving_gaze"))
        t0 = time.perf_counter()
        (q, s), totals, per_slot = counted_slots(
            lambda: fv.predict(sub_t, sub_r, mesh=mesh, **call, **ckw), mesh.size)
        wall = time.perf_counter() - t0
        subs = sub_blocks(B, MESH_FRAMES, mesh.size)
        check_slot_launches(case, per_slot, subs, n_levels, per_level,
                            () if per_level else ("gausspyr_reduce", "expand_contrast"))
        err_q, err_pc = rel_err_max(q, q_one), rel_err_max(s["Q_per_ch"], s_one["Q_per_ch"])
        heat_err = None
        if "heatmap" in s_one:
            heat_err = worst(s["heatmap"].astype(np.float32), s_one["heatmap"].astype(np.float32))
        emit(dict(phase=case, nvidia_smi=smi, frames=MESH_FRAMES, jod=q, jod_one_card=q_one,
                  rel_err_jod=err_q, rel_err_q_per_ch=err_pc, heatmap_max_abs_err=heat_err,
                  block_frames=B, sub_blocks_per_slot=subs, wall_s=wall, launches=totals,
                  launches_per_slot=per_slot))
        if not err_q <= MESH_TOL or not err_pc <= MESH_TOL \
                or (heat_err is not None and not heat_err <= 2e-3):
            raise AssertionError(f"{case}: JOD {q} vs {q_one} ({err_q}), Q_per_ch {err_pc}, "
                                 f"heatmap {heat_err}")
        launches[case] = totals
        del fv, s, s_one
        torch.cuda.empty_cache()
    return launches


def fvvdp_module():
    return importlib.import_module("fovvideovdp_tpu_torch.fvvdp")


def mesh_batch_cases(smi, mesh):
    """64 seeded 512x384 RGB pairs and 3 1080p clips through
    predict_batch(mesh=), each against the same metric without the mesh."""
    img_t, img_r = image_batch(IMG_N, IMG_H, IMG_W)
    clip_t, clip_r = clip_batch(CLIP_N, HD_H, HD_W, CLIP_FRAMES)
    cases = {"mesh_batch_images": (img_t, img_r, dict(dim_order="BHWC"), IMG_N),
             "mesh_batch_clips": (clip_t, clip_r, dict(dim_order="BHWCF", frames_per_second=FPS),
                                  CLIP_N * CLIP_FRAMES)}
    launches = {}
    for case, (t, r, call, frames) in cases.items():
        fv = fvt.fvvdp(display_name="standard_fhd", device="cuda:0")
        j_one, s_one = fv.predict_batch(t, r, **call)
        (j, s), totals, per_slot = counted_slots(
            lambda: fv.predict_batch(t, r, mesh=mesh, **call), mesh.size)
        must = ("gausspyr_reduce", "expand_score2") + (("temporal_pair",) if "F" in
                                                        call["dim_order"] else ())
        for k, counts in enumerate(per_slot):
            expect_launches(f"{case} slot {k}", counts, must, not_launched(must))
        err = rel_err_max(j, j_one)
        err_pc = rel_err_max(s["Q_per_ch"], s_one["Q_per_ch"]) if "Q_per_ch" in s else 0.0
        walls = {"mesh": [], "one": []}
        for how in ("mesh", "one", "one", "mesh"):
            kw = dict(call, mesh=mesh) if how == "mesh" else call
            walls[how] += warm_seconds(lambda: fv.predict_batch(t, r, **kw), runs=2)[0]
        warm = {k: float(np.median(v)) for k, v in walls.items()}
        emit(dict(phase=case, nvidia_smi=smi, pairs=int(t.shape[0]), rel_err_jods=err,
                  rel_err_q_per_ch=err_pc, jods=j[:4].tolist(), warm_s_runs=walls,
                  warm_s_median=warm["mesh"], warm_s_median_one_card=warm["one"],
                  frames_per_s=frames / warm["mesh"], frames_per_s_one_card=frames / warm["one"],
                  order="mesh, one, one, mesh", launches=totals, launches_per_slot=per_slot))
        if not err <= MESH_TOL or not err_pc <= MESH_TOL or j.shape != j_one.shape:
            raise AssertionError(f"{case}: JODs {j[:4]} vs {j_one[:4]} ({err}), Q_per_ch {err_pc}")
        launches[case] = totals
    return launches


def mesh_checkpoint_case(smi, test_v, ref_v, mesh, q_one):
    """The clip under the mesh in blocks of 32 (16 frames per slot), crashed
    after block 0 with a checkpoint after every block, then resumed under
    the mesh: bit for bit against the clean mesh run, only the second
    block's frames and halo read, each slot launching for one sub-block."""
    fv = fvt.fvvdp(display_name="standard_4k", device="cuda:0", block_frames=32)
    n_levels = fv._get_core(W, H).plan.height
    fl = temporal_ops.filter_len_for_fps(FPS)

    def source(limit=None):
        return MeshBlockLog(test_v, ref_v, FPS, dim_order="HWCF",
                            display_photometry=fv.display_photometry, device="cuda:0",
                            limit=limit)
    q_clean, s_clean = fv.predict_video_source(source(), mesh=mesh)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "mesh.ckpt")
        # block 0's two slot reads, then the carried frames the save reads
        try:
            fv.predict_video_source(source(limit=mesh.size + 1), mesh=mesh,
                                    checkpoint_path=ckpt, checkpoint_every=1)
            raise AssertionError("mesh checkpoint: the source did not crash")
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
        saved = os.path.getsize(ckpt)
        resumed = source()
        (q, s), totals, per_slot = counted_slots(lambda: fv.predict_video_source(
            resumed, mesh=mesh, checkpoint_path=ckpt), mesh.size)
        left = os.path.exists(ckpt)
    subs = sub_blocks(32, N_FRAMES, mesh.size, start=32)
    check_slot_launches("mesh_checkpoint", per_slot, subs, n_levels,
                        ("gausspyr_reduce", "expand_score2"))
    first = min(resumed.frames)
    bit = q == q_clean and np.array_equal(s["Q_per_ch"], s_clean["Q_per_ch"])
    emit(dict(phase="mesh_checkpoint_resume", nvidia_smi=smi, jod=q, jod_clean_mesh=q_clean,
              jod_one_card=q_one, bit_for_bit=bool(bit), checkpoint_bytes=saved,
              first_frame_read=first, reads=resumed.reads, file_left=left, launches=totals,
              launches_per_slot=per_slot))
    if not bit or left or first != 32 - (fl - 1) or not rel_err_max(q, q_one) <= MESH_TOL:
        raise AssertionError(f"mesh checkpoint: JOD {q} vs clean {q_clean} (bit for bit "
                             f"{bit}), one card {q_one}, first frame read {first}, file "
                             f"left {left}")
    return totals


def mesh_worker(pid, port, out):
    """One of the two processes of mesh_processes_case (run as
    ``chip_smoke.py --mesh-worker PID PORT OUT``): its own 32 pairs through
    predict_batch in a gloo group of two on localhost, on card 0, and each
    pair alone through predict."""
    import torch.distributed as dist
    from fovvideovdp_tpu_torch.parallel import init_multihost
    init_multihost(f"localhost:{port}", num_processes=2, process_id=pid, local_device_ids=[0])
    try:
        test, ref = image_batch(MP_PAIRS, IMG_H, IMG_W, seed=10 + pid)
        fv = fvt.fvvdp(display_name="standard_fhd")
        fv.predict_batch(test, ref, dim_order="BHWC")        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (jods, stats), launches = counted(lambda: fv.predict_batch(test, ref, dim_order="BHWC"))
        batch_s = time.perf_counter() - t0
        solo = [fv.predict(test[i], ref[i], dim_order="HWC")[0] for i in range(MP_PAIRS)]
        with open(out, "w") as f:
            json.dump(dict(pid=pid, jods=jods.tolist(), solo=solo, batch_s=batch_s,
                           n_processes=stats["n_processes"], launches=launches), f)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_processes_case(smi):
    """Two processes on the card, each scoring its own 32 pairs through
    predict_batch, the results gathered over gloo: each equals its pairs'
    solo predict within 1e-6 JOD.  Both are killed if either fails or the
    limit passes."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"proc{i}.json") for i in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker",
                                   str(i), str(port), outs[i]],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for i in range(2)]
        try:
            for p in procs:
                _, err = p.communicate(timeout=MP_TIMEOUT_S)
                if p.returncode != 0:
                    raise AssertionError(f"mesh process exited {p.returncode}: {err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        res = []
        for out in outs:
            with open(out) as f:
                res.append(json.load(f))
    errs = [worst(r["jods"], r["solo"]) for r in res]
    emit(dict(phase="mesh_processes", nvidia_smi=smi, processes=2, pairs_per_process=MP_PAIRS,
              max_abs_vs_solo=errs, n_processes=[r["n_processes"] for r in res],
              batch_s=[r["batch_s"] for r in res], wall_s=wall,
              jods=[r["jods"][:4] for r in res], launches=[r["launches"] for r in res]))
    if any(not e <= 1e-6 for e in errs) or any(r["n_processes"] != 2 for r in res) \
            or any(len(r["jods"]) != MP_PAIRS for r in res):
        raise AssertionError(f"mesh processes: {errs}, {[r['n_processes'] for r in res]}")
    return res[0]["launches"]


def mesh_cards_case(smi, test_v, ref_v):
    """With several cards visible: the 4K clip streamed and 256 512x384
    pairs through predict_batch on meshes of 1, 2 and 4 cards; JODs within
    MESH_TOL of one card's, warm fps (the clip's with and without building
    its source, the upload to card 0), and each card's peak."""
    n_cards = torch.cuda.device_count()
    smi_cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    img_t, img_r = image_batch(SCALE_PAIRS, IMG_H, IMG_W, seed=3)
    rows, ref_q, ref_j = [], None, None
    for n in (k for k in (1, 2, 4) if k <= n_cards):
        mesh = None if n == 1 else make_mesh([f"cuda:{i}" for i in range(n)])
        fv = fvt.fvvdp(display_name="standard_4k", device="cuda:0")
        fv_b = fvt.fvvdp(display_name="standard_fhd", device="cuda:0")
        video = lambda: fv.predict(test_v, ref_v, dim_order="HWCF",  # noqa: E731
                                   frames_per_second=FPS, mesh=mesh)
        batch = lambda: fv_b.predict_batch(img_t, img_r, dim_order="BHWC", mesh=mesh)  # noqa: E731
        vs = fvt.fvvdp_video_source_array(test_v, ref_v, FPS, dim_order="HWCF",
                                          display_photometry=fv.display_photometry,
                                          device="cuda:0")
        score = lambda: fv.predict_video_source(vs, mesh=mesh)  # noqa: E731
        q, _ = video()
        j, _ = batch()
        for i in range(n_cards):
            torch.cuda.reset_peak_memory_stats(i)
        v_times, v_s = warm_seconds(video)
        s_times, s_s = warm_seconds(score)
        b_times, b_s = warm_seconds(batch)
        # the same source with the slots' own conversion turned off: each
        # block converted on card 0 and the slots' luminance copied from there
        vs.luminance_at = None
        q_c, _ = score()
        c_times, c_s = warm_seconds(score)
        del vs
        ref_q = q if ref_q is None else ref_q
        ref_j = j if ref_j is None else ref_j
        row = dict(cards=n, jod=q, rel_err_jod=rel_err_max(q, ref_q),
                   batch_rel_err=rel_err_max(j, ref_j), video_warm_s_runs=v_times,
                   video_fps=N_FRAMES / v_s, video_score_s_runs=s_times,
                   video_score_fps=N_FRAMES / s_s, video_score_card0_lum_s_runs=c_times,
                   video_score_card0_lum_fps=N_FRAMES / c_s,
                   rel_err_jod_card0_lum=rel_err_max(q_c, q), batch_warm_s_runs=b_times,
                   batch_pairs_per_s=SCALE_PAIRS / b_s,
                   peak_bytes_per_card=[torch.cuda.max_memory_allocated(i) for i in range(n)])
        rows.append(row)
        emit(dict(phase="mesh_cards", nvidia_smi=smi, nvidia_smi_cards=smi_cards, **row))
        if not row["rel_err_jod"] <= MESH_TOL or not row["batch_rel_err"] <= MESH_TOL \
                or not row["rel_err_jod_card0_lum"] <= MESH_TOL:
            raise AssertionError(f"mesh over {n} cards: {row}")
        del fv, fv_b
        torch.cuda.empty_cache()
    return rows


def mesh_profile(dev):
    """--mesh-profile: where the time of a mesh over every visible card
    goes.  The 256 512x384 pairs of phase 8f through predict_batch, on card 0
    alone and on all cards: each slot's seconds of building its PairBatch
    (the upload of its rows) and of converting and scoring them, each ending
    in a synchronise of its stream, beside the whole call's; then
    torch.profiler over one warm call of each: its 15 ops with the most
    host time and its 10 with the most device time.  One JSON line per
    case."""
    from fovvideovdp_tpu_torch.video_source import PairBatch, rgb_to_y
    smi = nvidia_smi("name,power.limit")
    n_cards = torch.cuda.device_count()
    img_t, img_r = image_batch(SCALE_PAIRS, IMG_H, IMG_W, seed=3)
    meshes = {"card0": make_mesh(["cuda:0"]),
              "cards": make_mesh([f"cuda:{i}" for i in range(n_cards)])}
    for name, mesh in meshes.items():
        fv = fvt.fvvdp(display_name="standard_fhd", device="cuda:0")
        core = fv._get_core(IMG_W, IMG_H, with_heatmap=False)
        cores = {d: core.replica(d) for d in set(mesh.slots)}
        parts = split_rows(SCALE_PAIRS, mesh.size)

        def stages(k):
            a, b = parts[k]
            dev_k = mesh.slots[k]

            def fn():
                stream = torch.cuda.current_stream(dev_k)
                t0 = time.perf_counter()
                pairs = PairBatch(PairBatch.rows(img_t, "BHWC", a, b),
                                  PairBatch.rows(img_r, "BHWC", a, b), "BHWC", 0,
                                  fv.display_photometry, rgb_to_y(fv.color_space), dev_k)
                stream.synchronize()
                t1 = time.perf_counter()
                fv._score_pairs(cores[dev_k], pairs, "fused", None, None, dev_k, 1)
                stream.synchronize()
                return dict(upload_s=t1 - t0, score_s=time.perf_counter() - t1)
            return fn
        call = lambda: fv.predict_batch(img_t, img_r, dim_order="BHWC",  # noqa: E731
                                        mesh=mesh if mesh.size > 1 else None)
        call()
        runs = [mesh.run([stages(k) for k in range(mesh.size)]) for _ in range(3)]
        walls = warm_seconds(call)[0]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        top = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
        device_us = [(e, getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0)) for e in avg]
        top_dev = sorted(device_us, key=lambda x: x[1], reverse=True)[:10]
        emit(dict(phase="mesh_profile", case=name, nvidia_smi=smi, cards=n_cards,
                  slots=[str(d) for d in mesh.slots], pairs=SCALE_PAIRS,
                  slot_stage_s_runs=runs, call_s_runs=walls,
                  top_host_ops=[dict(name=e.key, calls=e.count,
                                     self_cpu_ms=e.self_cpu_time_total / 1e3) for e in top],
                  top_device_ops=[dict(name=e.key, calls=e.count, self_device_ms=us / 1e3)
                                  for e, us in top_dev]))
    return 0


def mesh_phases(dev, smi, test_v, ref_v):
    """Phase 8f.  Returns each case's launches (totals over the slots)."""
    t0 = time.perf_counter()
    mesh = make_mesh(["cuda:0", "cuda:0"])
    launches = {}
    launches["mesh_video"], q_one = mesh_video_phase(smi, test_v, ref_v, mesh)
    torch.cuda.empty_cache()
    launches.update(mesh_clip_cases(smi, test_v, ref_v, mesh))
    launches.update(mesh_batch_cases(smi, mesh))
    torch.cuda.empty_cache()
    launches["mesh_checkpoint"] = mesh_checkpoint_case(smi, test_v, ref_v, mesh, q_one)
    torch.cuda.empty_cache()
    launches["mesh_processes"] = mesh_processes_case(smi)
    if torch.cuda.device_count() > 1:
        mesh_cards_case(smi, test_v, ref_v)
    emit(dict(phase="mesh_seconds", seconds=time.perf_counter() - t0,
              cards=torch.cuda.device_count()))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if "--mesh-worker" in sys.argv:
        i = sys.argv.index("--mesh-worker")
        return mesh_worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3])
    if "--time-kernels" in sys.argv:
        return time_kernels(dev)
    if "--time-upload" in sys.argv:
        return time_upload(dev)
    if "--mesh-profile" in sys.argv:
        return mesh_profile(dev)
    traced_only = "--traced" in sys.argv
    batch_only = "--batch" in sys.argv
    options_only = "--options" in sys.argv
    extras_only = "--extras" in sys.argv
    mesh_only = "--mesh" in sys.argv

    # 1. device
    smi = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sfu_rate = SFU_PER_SM_CLOCK * props.multi_processor_count * max_clock_mhz * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}", flush=True)
    print(smi, flush=True)
    emit(dict(phase="device", name=name, nvidia_smi=smi, sms=props.multi_processor_count,
              max_sm_clock_mhz=max_clock_mhz, sfu_ops_per_s=sfu_rate,
              torch=torch.__version__, cuda=torch.version.cuda))

    # 2. build
    t0 = time.perf_counter()
    _lib.build()
    for k in _lib._SIGNATURES:
        _lib.kernel_fn(k)
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=_lib.build_seconds))
    if traced_only:
        traced_phases(dev, smi)
        return 0
    if batch_only:
        batch_phases(dev, smi, *synth_clip(H, W, N_FRAMES))
        return 0
    if options_only:
        options_phase(dev, smi, *synth_clip(H, W, N_FRAMES))
        return 0
    if extras_only:
        extras_phases(dev, smi, *synth_clip(H, W, N_FRAMES))
        return 0
    if mesh_only:
        mesh_phases(dev, smi, *synth_clip(H, W, N_FRAMES))
        return 0

    # 3. kernels vs plain at the main path's shapes (one block of the clip)
    fv = fvt.fvvdp(display_name="standard_4k")
    core = fv._get_core(W, H)
    test_v, ref_v, vs, (ct, nt, cr, nr), taps, B = first_block(fv, dev)
    # the plain-PyTorch stage before the kernels: decode, EOTF, RGB -> Y
    emit(dict(phase="luminance_block", frames=B,
              ms=time_ms(lambda: vs.get_luminance_block(0, B))))
    cases = dict(rows=[], n_levels=core.plan.height)
    check_temporal(ct, nt, cr, nr, taps, True, cases)
    empty = torch.empty((0, H, W), dtype=torch.float32, device=dev)
    check_temporal(empty, torch.cat([ct, nt]), empty, torch.cat([cr, nr]), taps,
                   False, cases)
    R = tmp.temporal_pair(ct, nt, cr, nr, taps)
    gpyr = check_reduce(R, cases)
    check_expand(core, gpyr, sfu_rate, cases)
    del R, ct, cr, nt, nr, vs, empty
    levels = check_expand_contrast(gpyr, core.plan.height, cases)
    del gpyr
    fv_fov = fvt.fvvdp(display_name="standard_4k", foveated=True)
    core_fov = fv_fov._get_core(W, H)
    centre = (float(W // 2), float(H // 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fov_tabs = core_fov.fov_tables(centre)
    torch.cuda.synchronize()
    emit(dict(phase="fov_tables", seconds=time.perf_counter() - t0,
              bytes=core_fov.fov_table_bytes(), knots=int(fov_tabs[0][0].shape[0]),
              cache_entries=core_fov._fov_cache_entries()))
    fv_pc = fvt.fvvdp(display_name="standard_4k")
    fv_pc.load_state(fv_pc.parameters, cut_luts(fv_pc))
    check_band_scores(levels, fv_pc._get_core(W, H), core, core_fov, fov_tabs, sfu_rate,
                      cases)
    del fov_tabs
    core_fov.drop_fov_tables()     # phase 6 builds them again, inside its first call
    check_mov_score(levels, core_fov, sfu_rate, cases)
    del levels
    core_fov._mov_cache.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4. video through the user's entry point
    B = fv._pick_block_size(H, W, N_FRAMES)   # the block predict will take
    path_launches = {}
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    q_video, stats = fv.predict(test_v, ref_v, dim_order="HWCF", frames_per_second=FPS)
    first_s = time.perf_counter() - t0
    launches = path_launches["video"] = cuda_ops.launch_counts()
    video_must = ("gausspyr_reduce", "expand_score2", "temporal_pair")
    video_not = ("expand_contrast", "band_score", "band_score2", "band_score2_fov",
                 "mov_score")
    expect_launches("video", launches, video_must, video_not)
    if not abs(q_video - GOLDEN_SYNTH_Q) <= JOD_TOL:
        raise AssertionError(f"4K clip JOD {q_video} vs the reference's {GOLDEN_SYNTH_Q}")
    q_pc = stats["Q_per_ch"]
    if q_pc.shape != (core.plan.height, 2, N_FRAMES) or not np.all(np.isfinite(q_pc)):
        raise AssertionError(f"Q_per_ch {q_pc.shape} not finite or misshapen")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        q_rep, _ = fv.predict(test_v, ref_v, dim_order="HWCF", frames_per_second=FPS)
        times.append(time.perf_counter() - t0)
        if q_rep != q_video:
            raise AssertionError(f"repeat JOD {q_rep} differs from {q_video}")
    peak = torch.cuda.max_memory_allocated()
    warm_s = float(np.median(times))
    # the same call split in two: building the source (the clip's upload)
    # and scoring a source already on the card
    src_s, score_s = split_timings(fv, (test_v, ref_v, FPS), "HWCF", dev)
    emit(dict(phase="video", jod=q_video, reference_jod=GOLDEN_SYNTH_Q,
              first_call_s=first_s, warm_s_runs=times, warm_s_median=warm_s,
              fps=N_FRAMES / warm_s, source_s_median=src_s, score_s_median=score_s,
              block_frames=B, peak_bytes=peak,
              peak_bytes_per_px_frame=peak / (B * H * W),
              launches=launches))

    # 4b. the same clip with the raw pair kept on the host: each block goes up
    # when it is needed, the next one's copy overlapping this one's scoring
    video_kw = dict(dim_order="HWCF", frames_per_second=FPS)
    fvt.fvvdp_video_source_array.DEVICE_PRELOAD_LIMIT_BYTES = 0
    try:
        (q_host, s_host), launches = counted(lambda: fv.predict(test_v, ref_v, **video_kw))
        expect_launches("host-resident video", launches, video_must, video_not)
        if q_host != q_video or not np.array_equal(s_host["Q_per_ch"], q_pc):
            raise AssertionError(f"host-resident clip: JOD {q_host} vs resident {q_video}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, warm_s = warm_seconds(lambda: fv.predict(test_v, ref_v, **video_kw))
        peak_host = torch.cuda.max_memory_allocated()
        src_s, score_s = split_timings(fv, (test_v, ref_v, FPS), "HWCF", dev)
    finally:
        fvt.fvvdp_video_source_array.DEVICE_PRELOAD_LIMIT_BYTES = None
    emit(dict(phase="host_resident_video", jod=q_host, warm_s_runs=times,
              warm_s_median=warm_s, fps=N_FRAMES / warm_s, source_s_median=src_s,
              score_s_median=score_s, peak_bytes=peak_host, resident_peak_bytes=peak,
              peak_below_resident_bytes=peak - peak_host,
              raw_pair_bytes=test_v.nbytes + ref_v.nbytes, launches=launches))

    # 4c. a source with only the per-frame methods, over the same clip
    frames = FrameSource(fvt.fvvdp_video_source_array(
        test_v, ref_v, FPS, dim_order="HWCF", display_photometry=fv.display_photometry,
        device=dev))
    t0 = time.perf_counter()
    (q_frames, s_frames), launches = counted(lambda: fv.predict_video_source(frames))
    frames_s = time.perf_counter() - t0
    expect_launches("per-frame source", launches, video_must, video_not)
    frames_diff = float(np.max(np.abs(s_frames["Q_per_ch"] - q_pc)))
    emit(dict(phase="per_frame_source", jod=q_frames, jod_array_source=q_video,
              max_abs_q_per_ch_diff=frames_diff, wall_s=frames_s, launches=launches))
    if q_frames != q_video or frames_diff != 0.0:
        raise AssertionError(f"per-frame source: JOD {q_frames} vs array source {q_video}, "
                             f"Q_per_ch differs by {frames_diff}")
    del frames

    # 4d-4h. file sources: .yuv, an ffmpeg pipe, the CLI, 10-bit PQ, packed
    q_yuv = file_source_phases(fv, test_v, ref_v, dev)
    torch.cuda.empty_cache()

    # 5. image through the same entry point
    cuda_ops.reset_launch_counts()
    q_img, s_img = fv.predict(test_v[..., 0], ref_v[..., 0], dim_order="HWC")
    img_launches = cuda_ops.launch_counts()
    if not np.isfinite(q_img) or not np.all(np.isfinite(s_img["Q_per_ch"])):
        raise AssertionError(f"4K image JOD {q_img} not finite")
    expect_launches("image", img_launches, must=("gausspyr_reduce", "expand_score2"),
                    must_not=("temporal_pair", "expand_contrast", "band_score",
                              "band_score2", "band_score2_fov", "mov_score"))
    img_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fv.predict(test_v[..., 0], ref_v[..., 0], dim_order="HWC")
        img_times.append(time.perf_counter() - t0)
    src_s, score_s = split_timings(fv, (test_v[..., 0], ref_v[..., 0], 0), "HWC", dev)
    emit(dict(phase="image", jod=q_img, launches=img_launches,
              warm_ms_median=1e3 * float(np.median(img_times)),
              source_ms_median=1e3 * src_s, score_ms_median=1e3 * score_s))

    # 6. fixed-gaze foveation: the 4K clip, its first frame, and a VR-sized
    # video against the CPU
    img_t, img_r = test_v[..., 0], ref_v[..., 0]
    fov_must = ("gausspyr_reduce", "expand_contrast", "band_score2_fov")
    fov_not = ("expand_score2", "band_score", "band_score2", "mov_score")
    (q_fov, s_fov), launches = counted(lambda: fv_fov.predict(test_v, ref_v, **video_kw))
    path_launches["foveated_video"] = launches
    expect_launches("foveated video", launches, fov_must + ("temporal_pair",), fov_not)
    q_pc = s_fov["Q_per_ch"]
    if not np.isfinite(q_fov) or q_pc.shape != (core.plan.height, 2, N_FRAMES) \
            or not np.all(np.isfinite(q_pc)):
        raise AssertionError(f"foveated 4K clip: JOD {q_fov}, Q_per_ch {q_pc.shape}")
    if not q_fov > q_video:
        raise AssertionError(f"foveated JOD {q_fov} is not above the non-foveated "
                             f"{q_video}: sensitivity falls with eccentricity")
    torch.cuda.reset_peak_memory_stats()
    times, warm_s = warm_seconds(lambda: fv_fov.predict(test_v, ref_v, **video_kw))
    peak = torch.cuda.max_memory_allocated()
    B_fov = fv_fov._pick_block_size(H, W, N_FRAMES, "banded")
    src_s, score_s = split_timings(fv_fov, (test_v, ref_v, FPS), "HWCF", dev)
    emit(dict(phase="foveated_video", jod=q_fov, warm_s_runs=times, warm_s_median=warm_s,
              fps=N_FRAMES / warm_s, source_s_median=src_s, score_s_median=score_s,
              table_bytes=core_fov.fov_table_bytes(), block_frames=B_fov, peak_bytes=peak,
              peak_bytes_per_px_frame=(peak - core_fov.fov_table_bytes()) / (B_fov * H * W),
              launches=launches))
    (q_fimg, s_fimg), launches = counted(lambda: fv_fov.predict(img_t, img_r, dim_order="HWC"))
    expect_launches("foveated image", launches, fov_must, fov_not + ("temporal_pair",))
    if not np.isfinite(q_fimg) or not np.all(s_fimg["Q_per_ch"][:, 1] == 0.0):
        raise AssertionError(f"foveated 4K image: JOD {q_fimg}")
    times, warm_s = warm_seconds(lambda: fv_fov.predict(img_t, img_r, dim_order="HWC"))
    emit(dict(phase="foveated_image", jod=q_fimg, warm_ms_median=1e3 * warm_s,
              launches=launches))

    # 6b. moving-gaze foveation.  A metric of its own: a gaze per frame frees
    # its core's fixed-gaze tables, and fv_fov's stay for the comparison.
    n_levels = core.plan.height
    mov_must = ("gausspyr_reduce", "expand_contrast", "mov_score")
    mov_not = ("expand_score2", "band_score", "band_score2", "band_score2_fov")
    fv_mov = fvt.fvvdp(display_name="standard_4k", foveated=True)
    gaze = sweeping_gaze(W, H, N_FRAMES)
    t0 = time.perf_counter()
    (q_mov, s_mov), launches = counted(
        lambda: fv_mov.predict(test_v, ref_v, fixation_point=gaze, **video_kw))
    first_s = time.perf_counter() - t0
    path_launches["moving_gaze_video"] = launches
    expect_launches("moving-gaze video", launches, mov_must + ("temporal_pair",), mov_not)
    core_mov = fv_mov._get_core(W, H)
    B_mov = fv_mov._pick_block_size(H, W, N_FRAMES, "moving")
    n_blocks = -(-N_FRAMES // B_mov)
    if launches["mov_score"] != n_levels * n_blocks \
            or launches["expand_contrast"] != n_levels * n_blocks:
        raise AssertionError(f"moving-gaze video: {launches}, expected {n_levels} levels x "
                             f"{n_blocks} blocks of mov_score and expand_contrast")
    if core_mov._fov_table_cache or core_mov.moving_route != "banded":
        raise AssertionError("moving-gaze video built fixed-gaze tables or left the kernel route")
    q_pc = s_mov["Q_per_ch"]
    if not np.isfinite(q_mov) or q_pc.shape != (n_levels, 2, N_FRAMES) \
            or not np.all(np.isfinite(q_pc)) or not q_video < q_mov < 10.0:
        raise AssertionError(f"moving-gaze 4K clip: JOD {q_mov} (default {q_video}), "
                             f"Q_per_ch {q_pc.shape}")
    # what stays on the card between calls (fv_fov's tables among it) is not the block's
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, warm_s = warm_seconds(
        lambda: fv_mov.predict(test_v, ref_v, fixation_point=gaze, **video_kw))
    peak = torch.cuda.max_memory_allocated()
    src_s, score_s = split_timings(fv_mov, (test_v, ref_v, FPS), "HWCF", dev,
                                   fixation_point=gaze)
    emit(dict(phase="moving_gaze_video", jod=q_mov, first_call_s=first_s, warm_s_runs=times,
              warm_s_median=warm_s, fps=N_FRAMES / warm_s, source_s_median=src_s,
              score_s_median=score_s,
              fov_table_bytes_resident=len(core_mov._fov_table_cache) * core_mov.fov_table_bytes(),
              block_frames=B_mov, peak_bytes=peak, resident_bytes_before=resident,
              peak_bytes_per_px_frame=(peak - resident) / (B_mov * H * W), launches=launches))

    # the gaze held at the centre, through both routes in turns
    centre_rows = np.tile(np.array(centre, np.float32), (N_FRAMES, 1))
    routes = {"fixed": (fv_fov, dict(fixation_point=np.array(centre, np.float32))),
              "moving": (fv_mov, dict(fixation_point=centre_rows))}
    jods, warm, scores = {}, {"fixed": [], "moving": []}, {"fixed": [], "moving": []}
    for route in ("fixed", "moving", "moving", "fixed"):
        fv_r, kw_r = routes[route]
        (jods[route], _), launches = counted(
            lambda: fv_r.predict(test_v, ref_v, **kw_r, **video_kw))
        expect_launches(f"centre gaze, {route} route", launches,
                        ("band_score2_fov",) if route == "fixed" else ("mov_score",),
                        ("mov_score",) if route == "fixed" else ("band_score2_fov",))
        warm[route].append(warm_seconds(
            lambda: fv_r.predict(test_v, ref_v, **kw_r, **video_kw))[1])
        scores[route].append(split_timings(fv_r, (test_v, ref_v, FPS), "HWCF", dev, **kw_r)[1])
    # a new metric's first call: the tables' build against the band data's
    first = {}
    for route in ("fixed", "moving"):
        fv_new = fvt.fvvdp(display_name="standard_4k", foveated=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fv_new.predict(test_v, ref_v, **routes[route][1], **video_kw)
        first[route] = time.perf_counter() - t0
        fv_new.load_state(fv_new.parameters, fv_new._luts)
        del fv_new
    emit(dict(phase="centre_gaze_fixed_vs_moving", jod_fixed=jods["fixed"],
              jod_moving=jods["moving"], warm_s_fixed=warm["fixed"],
              warm_s_moving=warm["moving"], score_s_fixed=scores["fixed"],
              score_s_moving=scores["moving"], first_call_s_fixed=first["fixed"],
              first_call_s_moving=first["moving"], table_bytes_fixed=core_fov.fov_table_bytes(),
              order="fixed, moving, moving, fixed"))
    if not abs(jods["fixed"] - jods["moving"]) <= 1e-3 or not abs(jods["fixed"] - q_fov) <= 1e-6:
        raise AssertionError(f"centre gaze: fixed route {jods['fixed']} (phase 6: {q_fov}), "
                             f"moving route {jods['moving']}")
    fv_fov.load_state(fv_fov.parameters, fv_fov._luts)    # frees the 4K tables
    del core_fov, routes

    (q_mimg, s_mimg), launches = counted(lambda: fv_mov.predict(
        img_t, img_r, dim_order="HWC", fixation_point=gaze[N_FRAMES // 3][None]))
    expect_launches("moving-gaze image", launches, mov_must, mov_not + ("temporal_pair",))
    if launches["mov_score"] != n_levels or not np.isfinite(q_mimg) \
            or not np.all(s_mimg["Q_per_ch"][:, 1] == 0.0):
        raise AssertionError(f"moving-gaze 4K image: JOD {q_mimg}, {launches}")
    times, warm_s = warm_seconds(lambda: fv_mov.predict(
        img_t, img_r, dim_order="HWC", fixation_point=gaze[N_FRAMES // 3][None]))
    emit(dict(phase="moving_gaze_image", jod=q_mimg, warm_ms_median=1e3 * warm_s,
              launches=launches))

    n_h = HEAT_FRAMES
    sub_t = np.ascontiguousarray(test_v[..., :n_h])
    sub_r = np.ascontiguousarray(ref_v[..., :n_h])
    gaze_h = sweeping_gaze(W, H, n_h)
    fv_mh = fvt.fvvdp(display_name="standard_4k", foveated=True, heatmap="raw")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (q_mh, s_mh), launches = counted(
        lambda: fv_mh.predict(sub_t, sub_r, fixation_point=gaze_h, **video_kw))
    peak = torch.cuda.max_memory_allocated()
    expect_launches("moving-gaze heatmap video", launches,
                    ("gausspyr_reduce", "expand_contrast", "temporal_pair"),
                    mov_not + ("mov_score",))
    hm = s_mh["heatmap"]
    q_mplain, _ = fv_mov.predict(sub_t, sub_r, fixation_point=gaze_h, **video_kw)
    if hm.shape != (1, 1, n_h, H, W) or not np.all(np.isfinite(hm)) \
            or not abs(q_mh - q_mplain) <= 1e-3:
        raise AssertionError(f"moving-gaze heatmap: {hm.shape}, JOD {q_mh} (composed route) vs "
                             f"{q_mplain} (mov_score)")
    B_mh = fv_mh._pick_block_size(H, W, n_h, "composed")
    times, warm_s = warm_seconds(
        lambda: fv_mh.predict(sub_t, sub_r, fixation_point=gaze_h, **video_kw))
    emit(dict(phase="moving_gaze_heatmap", frames=n_h, jod=q_mh, jod_kernel_route=q_mplain,
              warm_s_median=warm_s, block_frames=B_mh, peak_bytes=peak,
              resident_bytes_before=resident,
              peak_bytes_per_px_frame=(peak - resident) / (B_mh * H * W),
              heatmap_max=float(hm.max()),
              launches=launches))
    del hm, s_mh, fv_mh
    fv_mov.load_state(fv_mov.parameters, fv_mov._luts)
    del core_mov

    vr_t, vr_r = synth_clip(1600, 1440, 8)
    vr_kw = dict(dim_order="HWCF", frames_per_second=FPS, fixation_point=np.array([500, 600]))
    (q_vr, s_vr), launches = counted(lambda: fvt.fvvdp(
        display_name="htc_vive_pro", foveated=True).predict(vr_t, vr_r, **vr_kw))
    expect_launches("foveated VR video", launches, fov_must + ("temporal_pair",), fov_not)
    q_vr_cpu, s_vr_cpu = fvt.fvvdp(display_name="htc_vive_pro", foveated=True,
                                   device="cpu").predict(vr_t, vr_r, **vr_kw)
    emit(dict(phase="foveated_vs_cpu", shape=[1600, 1440, 8], jod=q_vr, jod_cpu=q_vr_cpu,
              max_rel_q_per_ch=float(np.max(np.abs(s_vr["Q_per_ch"] - s_vr_cpu["Q_per_ch"])
                                            / np.maximum(np.abs(s_vr_cpu["Q_per_ch"]), 1e-6)))))
    if not abs(q_vr - q_vr_cpu) <= 1e-3:
        raise AssertionError(f"foveated 1440x1600 video: card {q_vr} vs CPU {q_vr_cpu}")
    vr_kw["fixation_point"] = sweeping_gaze(1440, 1600, 8)
    (q_vm, s_vm), launches = counted(lambda: fvt.fvvdp(
        display_name="htc_vive_pro", foveated=True).predict(vr_t, vr_r, **vr_kw))
    expect_launches("moving-gaze VR video", launches, mov_must + ("temporal_pair",), mov_not)
    q_vm_cpu, s_vm_cpu = fvt.fvvdp(display_name="htc_vive_pro", foveated=True,
                                   device="cpu").predict(vr_t, vr_r, **vr_kw)
    emit(dict(phase="moving_gaze_vs_cpu", shape=[1600, 1440, 8], jod=q_vm, jod_cpu=q_vm_cpu,
              max_rel_q_per_ch=float(np.max(np.abs(s_vm["Q_per_ch"] - s_vm_cpu["Q_per_ch"])
                                            / np.maximum(np.abs(s_vm_cpu["Q_per_ch"]), 1e-6))),
              launches=launches))
    if not abs(q_vm - q_vm_cpu) <= 1e-3:
        raise AssertionError(f"moving-gaze 1440x1600 video: card {q_vm} vs CPU {q_vm_cpu}")
    del vr_t, vr_r

    # 7. heatmaps
    heat_must = ("gausspyr_reduce", "expand_contrast")
    heat_not = ("expand_score2", "band_score", "band_score2", "band_score2_fov", "mov_score")
    heat = {}
    for kind in ("threshold", "raw"):
        fv_h = fvt.fvvdp(display_name="standard_4k", heatmap=kind)
        (q_h, s_h), launches = counted(lambda: fv_h.predict(img_t, img_r, dim_order="HWC"))
        expect_launches(f"heatmap {kind} image", launches, heat_must,
                        heat_not + ("temporal_pair",))
        hm = s_h["heatmap"]
        c = 1 if kind == "raw" else 3
        if not isinstance(hm, np.ndarray) or hm.shape != (1, c, 1, H, W) \
                or hm.dtype != np.float16 or not np.all(np.isfinite(hm)):
            raise AssertionError(f"{kind} heatmap: {type(hm)} {hm.shape} {hm.dtype}")
        if kind != "raw" and (hm.min() < 0.0 or hm.max() > 1.0):
            raise AssertionError(f"{kind} heatmap outside [0, 1]: {hm.min()}..{hm.max()}")
        if not abs(q_h - q_img) <= 1e-3:
            raise AssertionError(f"JOD with a {kind} heatmap {q_h} vs without {q_img}")
        torch.cuda.reset_peak_memory_stats()
        times, warm_s = warm_seconds(lambda: fv_h.predict(img_t, img_r, dim_order="HWC"))
        peak = torch.cuda.max_memory_allocated()
        src_s, score_s = split_timings(fv_h, (img_t, img_r, 0), "HWC", dev)
        heat[kind] = hm
        emit(dict(phase=f"heatmap_{kind}_image", jod=q_h, warm_ms_median=1e3 * warm_s,
                  source_ms_median=1e3 * src_s, score_ms_median=1e3 * score_s,
                  peak_bytes=peak, peak_bytes_per_px_frame=peak / (H * W),
                  heatmap_max=float(hm.max()), launches=launches))
    _, s_cpu = fvt.fvvdp(display_name="standard_4k", heatmap="raw", device="cpu").predict(
        img_t, img_r, dim_order="HWC")
    raw_err = float(np.max(np.abs(heat["raw"].astype(np.float32)
                                  - s_cpu["heatmap"].astype(np.float32))))
    # the parts of the heatmap image's scoring time that have a function of
    # their own: the colour map with its tone curve, and the copy to the host
    dmap = torch.as_tensor(heat["raw"][0, :, 0].astype(np.float32), device=dev)[None]
    ctx = torch.rand((1, 1, H, W), device=dev) * 100.0 + 0.1
    rgb = visualize_diff_map_frames(dmap, ctx, "threshold").to(torch.float16)
    # and the same image scored with the map left on the device: what remains
    # of the host-resident run's scoring time is the copy to the host
    _, dev_score_s = split_timings(
        fvt.fvvdp(display_name="standard_4k", heatmap="threshold", device_heatmap=True),
        (img_t, img_r, 0), "HWC", dev)
    emit(dict(phase="heatmap_raw_vs_cpu", max_abs_err=raw_err, tolerance="atol 2e-3",
              visualize_ms=time_ms(lambda: visualize_diff_map_frames(dmap, ctx, "threshold")),
              to_host_ms=time_ms(lambda: rgb.cpu()),
              threshold_score_ms_device_heatmap=1e3 * dev_score_s))
    if not raw_err <= 2e-3:
        raise AssertionError(f"raw 4K heatmap differs from the CPU's by {raw_err}")
    del heat, s_cpu, dmap, ctx, rgb

    fv_h = fvt.fvvdp(display_name="standard_4k", heatmap="supra-threshold",
                     device_heatmap=True, heatmap_dtype="uint8")
    torch.cuda.reset_peak_memory_stats()
    (q_hv, s_hv), launches = counted(lambda: fv_h.predict(sub_t, sub_r, **video_kw))
    peak = torch.cuda.max_memory_allocated()
    expect_launches("heatmap video", launches, heat_must + ("temporal_pair",), heat_not)
    hm = s_hv["heatmap"]
    if not isinstance(hm, torch.Tensor) or not hm.is_cuda or hm.dtype != torch.uint8 \
            or tuple(hm.shape) != (1, 3, n_h, H, W):
        raise AssertionError(f"device heatmap: {type(hm)} {getattr(hm, 'shape', None)}")
    q_plain, _ = fv.predict(sub_t, sub_r, **video_kw)
    if not abs(q_hv - q_plain) <= 1e-3:
        raise AssertionError(f"JOD with a device heatmap {q_hv} vs without {q_plain}")
    B_h = fv_h._pick_block_size(H, W, n_h, "composed")
    del hm, s_hv
    times, warm_s = warm_seconds(lambda: fv_h.predict(sub_t, sub_r, **video_kw))
    emit(dict(phase="heatmap_video", frames=n_h, jod=q_hv, jod_without=q_plain,
              warm_s_median=warm_s, block_frames=B_h, peak_bytes=peak,
              peak_bytes_per_px_frame=peak / (B_h * H * W), launches=launches))

    # 8. per-channel LUTs (the temporal channels' Y grids differ)
    pc_must = ("gausspyr_reduce", "expand_contrast", "band_score")
    pc_not = ("expand_score2", "band_score2", "band_score2_fov", "mov_score")
    (q_pci, _), launches = counted(lambda: fv_pc.predict(img_t, img_r, dim_order="HWC"))
    expect_launches("per-channel image", launches, pc_must, pc_not + ("temporal_pair",))
    torch.cuda.reset_peak_memory_stats()
    (q_pcv, s_pcv), launches = counted(lambda: fv_pc.predict(sub_t, sub_r, **video_kw))
    peak = torch.cuda.max_memory_allocated()
    path_launches["per_channel_video"] = launches
    expect_launches("per-channel video", launches, pc_must + ("temporal_pair",), pc_not)
    B_pc = fv_pc._pick_block_size(H, W, n_h, "banded")
    n_blocks = -(-n_h // B_pc)
    if launches["band_score"] != 2 * core.plan.height * n_blocks:
        raise AssertionError(f"band_score launched {launches['band_score']} times, expected "
                             f"2 x {core.plan.height} levels x {n_blocks} blocks")
    # the cut knot lies above the display's peak, so the scores are the default's
    if not abs(q_pcv - q_plain) <= 1e-3 or not abs(q_pci - q_img) <= 1e-3:
        raise AssertionError(f"per-channel LUTs: video {q_pcv} vs {q_plain}, "
                             f"image {q_pci} vs {q_img}")
    times, warm_s = warm_seconds(lambda: fv_pc.predict(sub_t, sub_r, **video_kw))
    hd_t, hd_r = synth_clip(1080, 1920, 8)
    fv_hd = fvt.fvvdp(display_name="standard_fhd")
    fv_hd.load_state(fv_hd.parameters, cut_luts(fv_hd))
    q_hd, _ = fv_hd.predict(hd_t, hd_r, **video_kw)
    fv_hd_cpu = fvt.fvvdp(display_name="standard_fhd", device="cpu")
    fv_hd_cpu.load_state(fv_hd_cpu.parameters, cut_luts(fv_hd_cpu))
    q_hd_cpu, _ = fv_hd_cpu.predict(hd_t, hd_r, **video_kw)
    emit(dict(phase="per_channel_luts", frames=n_h, jod_image=q_pci, jod_video=q_pcv,
              warm_s_median=warm_s, block_frames=B_pc, peak_bytes=peak,
              peak_bytes_per_px_frame=peak / (B_pc * H * W), launches=launches,
              jod_1080p=q_hd, jod_1080p_cpu=q_hd_cpu))
    if not abs(q_hd - q_hd_cpu) <= 1e-3:
        raise AssertionError(f"per-channel LUTs at 1080p: card {q_hd} vs CPU {q_hd_cpu}")

    # 8b. the differentiable path
    del fv_pc, fv_h, fv_hd, fv_hd_cpu
    torch.cuda.empty_cache()
    backward = traced_phases(dev, smi)

    # 8c. batches of pairs and the ablation
    batch = batch_phases(dev, smi, test_v, ref_v)

    # 8d. the ablations and options
    options = options_phase(dev, smi, test_v, ref_v)
    torch.cuda.empty_cache()

    # 8e. checkpoint and resume, PU21-PSNR, the cores' key, update_device, the CLI
    extras = extras_phases(dev, smi, test_v, ref_v, q_yuv)
    torch.cuda.empty_cache()

    # 8f. a mesh of two slots on the card, two processes on the card
    mesh = mesh_phases(dev, smi, test_v, ref_v)

    # 9. kernels line, result line
    print(smi, flush=True)
    summary = kernel_summary(cases["rows"], path_launches)
    for row in summary:
        # the Function's backward (the plain VJP) at the same block's shapes
        row["backward_plain_ms"] = backward[row["name"]]["backward_ms"]
        # launches in each case of phase 8c (temporal_pair in batch_clips:
        # once per clip, with an empty carry)
        row["batch_launches"] = {case: counts[row["name"]] for case, counts in batch.items()}
        # launches in each full-width configuration of phase 8d
        row["options_launches"] = {case: counts[row["name"]]
                                   for case, counts in options.items()}
        # launches in each case of phase 8e
        row["extras_launches"] = {case: counts[row["name"]] for case, counts in extras.items()}
        # launches in each case of phase 8f, summed over the mesh's slots
        row["mesh_launches"] = {case: counts[row["name"]] for case, counts in mesh.items()}
    emit(dict(kernels=summary))
    emit(dict(ok=True, device=dict(platform="gpu", kind=name,
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
