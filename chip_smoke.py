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
  4. video: fvvdp(display_name="standard_4k").predict on bench.py's clip
     (3840x2160, 60 frames, 30 fps), JOD held to the PyTorch reference's
     9.7688 +- 0.01, warm wall time (median of 3), peak memory, block size
     and the launches of each kernel in that run;
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
  9. the kernels line, then the result line.

Every path has its own expectation of which kernels must launch and which
must not; the counts are set to 0 just before it and read just after.

Imports nothing of JAX or of the JAX package.  Exits non-zero without a
CUDA card, and fails at import when the package is not beside it.
"""
import json
import subprocess
import sys
import time

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
from fovvideovdp_tpu_torch.ops.pyramid import K5
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


def check_reduce(gpyr_in, cases):
    """Every level of one block's pyramid: kernel vs plain vs strided conv2d;
    then the coarsest level once more, which the main path never reduces."""
    w2d = torch.as_tensor(np.outer(K5, K5), device=gpyr_in.device)[None, None]
    x = gpyr_in
    levels = [x]
    while len(levels) < cases["n_levels"] + 2:
        main_path = len(levels) <= cases["n_levels"]
        N, h, w = x.shape[0] * x.shape[1], x.shape[-2], x.shape[-1]
        got = red.gausspyr_reduce(x)
        want = red.gausspyr_reduce_plain(x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-4))
        ms = time_ms(lambda: red.gausspyr_reduce(x))
        plain_ms = time_ms(lambda: red.gausspyr_reduce_plain(x))
        x3 = x.reshape(N, 1, h, w)
        xpad = F.pad(torch.cat([x3[..., 1:2, :], x3[..., 0:1, :], x3,
                                x3[..., -1:, :], x3[..., -2:-1, :]], dim=-2), (2, 2))
        lib_ms = time_ms(lambda: F.conv2d(xpad, w2d, stride=2))
        del xpad
        ho, wo = got.shape[-2], got.shape[-1]
        b_ms, b_by = bound(4 * N * (h * w + ho * wo), 9 * N * (ho * w + ho * wo),
                           FP32_FLOP_PER_S)
        row = dict(case="gausspyr_reduce", shape=[N, h, w], max_abs_err=err,
                   tolerance="rtol 1e-5, atol 1e-4", ok=ok, launches_per_call=1,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, main_path=main_path)
        emit(row)
        cases["rows"].append(row)
        if not ok:
            raise AssertionError(f"gausspyr_reduce disagrees with its plain version at "
                                 f"{(N, h, w)}: max abs err {err}")
        levels.append(got)
        x = got
    return levels[:-1]


def check_expand(core, gpyr, sfu_rate, cases):
    for bb in range(core.plan.height):
        fine, coarse = gpyr[bb], gpyr[bb + 1]
        tabs, meta = core._score_tables[bb], core._meta[bb]
        got = bp.expand_score2(fine, coarse, tabs, meta).double()
        want = bp.expand_score2_plain(fine, coarse, tabs, meta).double()
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        ok = rel <= 1e-4
        ms = time_ms(lambda: bp.expand_score2(fine, coarse, tabs, meta))
        plain_ms = time_ms(lambda: bp.expand_score2_plain(fine, coarse, tabs, meta))
        Fr, _, h, w = fine.shape
        nbytes = 4 * (fine.numel() + coarse.numel() + tabs.numel() + 2 * Fr)
        b_ms, b_by = bound(nbytes, SFU_PER_PIXEL * Fr * h * w, sfu_rate)
        row = dict(case="expand_score2", shape=list(fine.shape), max_abs_err=err,
                   max_rel_err=rel, tolerance="relative 1e-4 on per-frame sums",
                   ok=ok, launches_per_call=1, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by, main_path=True)
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


def check_band_scores(levels, core_pc, core_2, core_fov, fov_tabs, sfu_rate, cases):
    """band_score (per-channel LUT core's tables, both channels), band_score2
    (the default core's shared-grid tables) and band_score2_fov (the
    fixation point's per-pixel tables) at every level of one block."""
    for bb, (band, L_bkg) in enumerate(levels):
        L = L_bkg[:, 0]
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
                         4 * (3 * px + table.numel() + Fr), SFU_PER_PIXEL_1CH * px, 1e-4))
        tabs2, meta2 = core_2._score_tables[bb], core_2._meta[bb]
        runs.append(("band_score2", f"n = {tabs2.shape[1]}",
                     lambda: bs.band_score2(band, L, tabs2, meta2),
                     lambda: bs.band_score2_plain(band, L, tabs2, meta2),
                     4 * (5 * px + tabs2.numel() + 2 * Fr), SFU_PER_PIXEL * px, 1e-4))
        ts, tt = fov_tabs[bb]
        metaf = core_fov._fov_meta[bb]
        runs.append(("band_score2_fov", f"n = {ts.shape[0]}",
                     lambda: bs.band_score2_fov(band, L, ts, tt, metaf),
                     lambda: bs.band_score2_fov_plain(band, L, ts, tt, metaf),
                     4 * (5 * px + ts.numel() + tt.numel() + 2 * Fr), SFU_PER_PIXEL * px, 2e-4))
        for name, note, kernel, plain, nbytes, sfu, tol in runs:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            rel = rel_err(got, want)
            err = (got.double() - want.double()).abs().max().item()
            del got, want
            ms = time_ms(kernel)
            plain_ms = time_ms(plain, runs=3, warmup=1)
            b_ms, b_by = bound(nbytes, sfu, sfu_rate)
            add_row(cases, dict(
                case=name, shape=[Fr, h, w], note=note, max_abs_err=err, max_rel_err=rel,
                tolerance=f"relative {tol:g} on per-frame sums", ok=rel <= tol,
                launches_per_call=1, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by,
                main_path=True), f"level {bb} ({note})")


def check_mov_score(levels, core_fov, sfu_rate, cases):
    """mov_score at every level of one block: the shipped LUT pair with a
    gaze sweeping corner to corner (two tables in shared memory: the main
    path's instance), the one-table arm (the omega = 5 table replaced by its
    mean offset from the omega = 0 one), an image (one frame, zero transient
    contrast) and the LUT with every knot kept, which the kernel reads from
    global memory."""
    plan = core_fov.plan
    n_frames = levels[0][0].shape[0]
    gaze_dir = core_fov._gaze_directions(torch.from_numpy(
        sweeping_gaze(plan.W, plan.H, n_frames)))
    for bb, (band, L_bkg) in enumerate(levels):
        L = L_bkg[:, 0]
        Fr, _, h, w = band.shape
        vd = core_fov._band_view_dir[bb]
        d = core_fov._moving_band_data(bb)
        full = core_fov._moving_band_data(bb, windowed=False)
        one = d["meta"]._replace(off5=float((d["V2_5"] - d["V2"]).mean().item()))
        image = band[:1].clone()
        image[:, 2:] = 0.0
        runs = [
            ("two tables", True, (band, L, vd, d["t_r"], gaze_dir, d["V2"], d["V2_5"], d["meta"])),
            ("one table and off5", False, (band, L, vd, d["t_r"], gaze_dir, d["V2"], None, one)),
            ("image", False, (image, L[:1], vd, d["t_r"], gaze_dir[:1], d["V2"], d["V2_5"],
                              d["meta"])),
            ("whole LUT, global memory", False,
             (band, L, vd, full["t_r"], gaze_dir, full["V2"], full["V2_5"], full["meta"])),
        ]
        for note, main_path, args in runs:
            meta = args[-1]
            n_e = args[5].shape[0]
            shared = ms.lut_in_shared(n_e, meta)
            if shared != (not note.startswith("whole LUT")):
                raise AssertionError(f"mov_score ({note}): LUT in shared memory is {shared}")
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
                case="mov_score", shape=[nf, h, w], note=f"{note}, LUT {n_e} x {meta.ny} x "
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
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")

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

    # 3. kernels vs plain at the main path's shapes (one block of the clip)
    test_v, ref_v = synth_clip(H, W, N_FRAMES)
    fv = fvt.fvvdp(display_name="standard_4k")
    core = fv._get_core(W, H)
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
    expect_launches("video", launches,
                    must=("gausspyr_reduce", "expand_score2", "temporal_pair"),
                    must_not=("expand_contrast", "band_score", "band_score2",
                              "band_score2_fov", "mov_score"))
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
    video_kw = dict(dim_order="HWCF", frames_per_second=FPS)
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

    # 9. kernels line, result line
    print(smi, flush=True)
    emit(dict(kernels=kernel_summary(cases["rows"], path_launches)))
    emit(dict(ok=True, device=dict(platform="gpu", kind=name,
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
