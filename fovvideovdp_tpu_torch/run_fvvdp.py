"""Command-line interface: ``fvvdp-torch --test ... --ref ...``, or
``python -m fovvideovdp_tpu_torch.run_fvvdp``.

Counterpart of ``fovvideovdp_tpu/run_fvvdp.py``, with the same flags:
wildcard expansion, display listing with ``--display ?``, heatmaps written
as PNG (cv2 or PIL) or video (the ffmpeg binary, else cv2), the features
JSON, ``--metrics fvvdp pu-psnr``, ``--checkpoint``.  It runs on the CUDA
card ``--gpu N`` unless ``--device cpu`` asks for the plain PyTorch versions
on the CPU.  ``--all-devices`` streams each pair over a mesh of every
visible card (``parallel.make_mesh()``; with ``--device cpu``, a mesh of
``CPU_MESH_SLOTS`` slots of the CPU, which drives the mesh's code where
there is no card).
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import shutil
import subprocess
import sys

import numpy as np

import fovvideovdp_tpu_torch as pkg
from fovvideovdp_tpu_torch import utils
from fovvideovdp_tpu_torch.display_model import (fvvdp_display_geometry,
                                                 fvvdp_display_photometry)
from fovvideovdp_tpu_torch.parallel import make_mesh
from fovvideovdp_tpu_torch.video_source_file import fvvdp_video_source_file

# slots of the CPU mesh that --all-devices builds with --device cpu
CPU_MESH_SLOTS = 2


def expand_wildcards(filestrs):
    if not isinstance(filestrs, list):
        return [filestrs]
    files = []
    for filestr in filestrs:
        if "*" in filestr:
            files += sorted(glob.glob(filestr))
        else:
            files.append(filestr)
    return files


def np2img(np_srgb, imgfile):
    """Save (N, H, W, C) float sRGB in [0, 1] as an 8-bit image."""
    N, H, W, C = np_srgb.shape
    if C == 1:
        np_srgb = np.concatenate([np_srgb] * 3, -1)
    if N > 1:
        sys.exit("Expecting an image, found video")
    img8 = (np.clip(np_srgb, 0.0, 1.0)[0] * 255.0).astype(np.uint8)
    try:
        import cv2
        cv2.imwrite(imgfile, img8[:, :, ::-1])
    except ImportError:
        from PIL import Image
        Image.fromarray(img8).save(imgfile)


def _np2vid_cv2(np_srgb, vidfile, fps):
    """Encode through OpenCV's bundled FFMPEG when the binary is absent."""
    import cv2
    N, H, W, _ = np_srgb.shape
    vw = cv2.VideoWriter(vidfile, cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (W, H))
    if not vw.isOpened():
        raise RuntimeError(f"OpenCV could not open '{vidfile}' for encoding")
    try:
        for fid in range(N):
            frame8 = (np.clip(np_srgb[fid], 0.0, 1.0) * 255.0).astype(np.uint8)
            vw.write(frame8[:, :, ::-1])  # RGB -> BGR
    finally:
        vw.release()


def np2vid(np_srgb, vidfile, fps, verbose=False):
    """Save (N, H, W, C) float sRGB in [0, 1] as a video: H.264 through the
    ffmpeg binary, or OpenCV's encoder when the binary is absent."""
    N, H, W, C = np_srgb.shape
    if C == 1:
        np_srgb = np.concatenate([np_srgb] * 3, -1)
    if shutil.which("ffmpeg") is None:
        try:
            return _np2vid_cv2(np_srgb, vidfile, fps)
        except ImportError as e:
            raise RuntimeError(
                "Writing video heatmaps needs the ffmpeg binary or the "
                "opencv-python package; neither is available.") from e
    cmd = ["ffmpeg", "-y", "-hide_banner", "-loglevel", "info" if verbose else "quiet",
           "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{W}x{H}",
           "-r", str(fps), "-i", "pipe:", "-pix_fmt", "yuv420p", "-crf", "10", vidfile]
    # stderr is captured only when quiet (error lines only); verbose streams
    # to the terminal, since a full PIPE would deadlock against stdin
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stderr=None if verbose else subprocess.PIPE)
    try:
        for fid in range(N):
            # clip before the uint8 cast: raw heatmaps exceed [0, 1]
            frame8 = (np.clip(np_srgb[fid], 0.0, 1.0) * 255.0).astype(np.uint8)
            proc.stdin.write(frame8.tobytes())
        proc.stdin.close()
    except BrokenPipeError:
        pass  # the encoder died early; its return code says so below
    err = b"" if verbose else proc.stderr.read()
    if proc.wait() != 0:
        raise RuntimeError(f"ffmpeg failed to encode '{vidfile}' (rc={proc.returncode}): "
                           f"{err.decode(errors='replace')[-500:]}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate FovVideoVDP on a set of videos/images (PyTorch/CUDA)")
    parser.add_argument("--test", type=str, nargs="+", required=False,
                        help="list of test images/videos")
    parser.add_argument("--ref", type=str, nargs="+", required=False,
                        help="list of reference images/videos")
    parser.add_argument("--gpu", type=int, default=0,
                        help="index of the CUDA card to run on")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cpu runs the plain PyTorch versions of the kernels")
    parser.add_argument("--heatmap", type=str, default="none",
                        help="type of difference map (none, raw, threshold, supra-threshold)")
    parser.add_argument("--heatmap-dtype", choices=["float16", "uint8"], default="float16",
                        help="uint8 quantises colormapped heatmaps on the device "
                             "(half the bytes of float16)")
    parser.add_argument("--features", action="store_true", default=False,
                        help="generate JSON files with extracted features")
    parser.add_argument("--output-dir", type=str, default=None,
                        help="directory for heatmaps and feature files")
    parser.add_argument("--foveated", action="store_true", default=False,
                        help="run in foveated mode (non-foveated is default)")
    parser.add_argument("--display", type=str, default="standard_4k",
                        help="display name, or ? to list available models")
    parser.add_argument("--config-dir", type=str, default=None,
                        help="path to configuration files (display_models.json etc.)")
    parser.add_argument("--nframes", type=int, default=-1,
                        help="number of video frames to compare")
    parser.add_argument("--full-screen-resize",
                        choices=["bilinear", "bicubic", "nearest", "area"], default=None,
                        help="resize content to the full display resolution")
    parser.add_argument("--metrics", choices=["fvvdp", "pu-psnr"], nargs="+",
                        default=["fvvdp"], help="which metric(s) to run")
    parser.add_argument("--temp-padding", choices=["replicate", "circular", "pingpong"],
                        default="replicate", help="temporal padding mode")
    parser.add_argument("--quiet", action="store_true", default=False,
                        help="print only the final quality value")
    parser.add_argument("--verbose", action="store_true", default=False,
                        help="print extra information")
    parser.add_argument("--ffmpeg-cc", action="store_true", default=False,
                        help="let ffmpeg do colour conversion (on the device is default)")
    parser.add_argument("--block-frames", type=int, default=None,
                        help="frames per block (default: from the card's free memory)")
    parser.add_argument("--all-devices", action="store_true", default=False,
                        help="shard video frames over every visible card (with "
                             f"--device cpu: {CPU_MESH_SLOTS} slots of the CPU)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="path for streaming-state checkpoints; a killed "
                             "long-video job resumes where it stopped")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    log_level = logging.WARNING if args.quiet else (
        logging.DEBUG if args.verbose else logging.INFO)
    logging.basicConfig(format="[%(levelname)s] %(message)s", level=log_level)

    if args.config_dir is not None:
        utils.config_files.set_config_dir(args.config_dir)

    if args.display == "?":
        fvvdp_display_photometry.list_displays()
        return 0

    if args.test is None or args.ref is None:
        logging.error("Paths to both test and reference content needs to be specified.")
        return 1

    heatmap = None if args.heatmap == "none" else args.heatmap
    if heatmap and heatmap not in ("raw", "threshold", "supra-threshold"):
        logging.error('The recognized heatmap types are: "none", "raw", '
                      '"threshold" and "supra-threshold"')
        return 1

    args.test = expand_wildcards(args.test)
    args.ref = expand_wildcards(args.ref)
    N_test, N_ref = len(args.test), len(args.ref)
    if N_test == 0 or N_ref == 0:
        logging.error("No test or reference images/videos found.")
        return 1
    if N_test != N_ref and N_test != 1 and N_ref != 1:
        logging.error(
            "Pass the same number of reference and test sources, or a single "
            "reference (to be used with all test sources), or a single test.")
        return 1

    device = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    display_photometry = fvvdp_display_photometry.load(args.display)
    display_geometry = fvvdp_display_geometry.load(args.display)
    if args.verbose:
        display_photometry.print()
        display_geometry.print()

    metrics = []
    for mm in args.metrics:
        if mm == "fvvdp":
            metrics.append(pkg.fvvdp(display_photometry=display_photometry,
                                     display_geometry=display_geometry,
                                     foveated=args.foveated, heatmap=heatmap,
                                     heatmap_dtype=args.heatmap_dtype,
                                     temp_padding=args.temp_padding,
                                     block_frames=args.block_frames, device=device))
        elif mm == "pu-psnr":
            if heatmap:
                logging.warning(f"Skipping heatmap as it is not supported by {mm}")
            if args.foveated:
                logging.warning(f"Foveated mode is not supported by {mm}")
            m = pkg.pu_psnr(device=device)
            m.display_photometry = display_photometry
            m.color_space = "sRGB"
            metrics.append(m)
        info_str = metrics[-1].get_info_string()
        if info_str is not None:
            logging.info("When reporting metric results, please include the "
                         "following information:")
            logging.info(info_str)

    out_dir = args.output_dir or "."
    os.makedirs(out_dir, exist_ok=True)

    mesh = None
    if args.all_devices:
        mesh = make_mesh() if args.device == "cuda" else make_mesh(["cpu"] * CPU_MESH_SLOTS)
        logging.info(f"Sharding over {mesh.devices.size} device(s)")

    for kk in range(max(N_test, N_ref)):
        test_file = args.test[min(kk, N_test - 1)]
        ref_file = args.ref[min(kk, N_ref - 1)]
        logging.info(f"Predicting the quality of '{test_file}' compared to '{ref_file}'")
        for mm in metrics:
            # non-replicate padding and checkpoint/resume both need random
            # access to the decoded frames
            vs = fvvdp_video_source_file(
                test_file, ref_file, display_photometry=display_photometry,
                full_screen_resize=args.full_screen_resize,
                resize_resolution=display_geometry.resolution, frames=args.nframes,
                preload=args.temp_padding != "replicate" or args.checkpoint is not None,
                ffmpeg_cc=args.ffmpeg_cc, verbose=args.verbose, device=device)
            if isinstance(mm, pkg.fvvdp):
                ckpt = args.checkpoint
                if ckpt and max(N_test, N_ref) > 1:
                    ckpt = f"{ckpt}.{kk}"  # one state file per pair
                Q_pred, stats = mm.predict_video_source(vs, mesh=mesh, checkpoint_path=ckpt)
            else:
                Q_pred, stats = mm.predict_video_source(vs)
            if args.quiet:
                print("{Q:0.4f}".format(Q=Q_pred))
            else:
                print("{name}={Q:0.4f} [{units}]".format(
                    name=mm.short_name(), Q=Q_pred, units=mm.quality_unit()))

            base = os.path.splitext(os.path.basename(test_file))[0]
            if args.features and stats is not None:
                dest = os.path.join(out_dir, base + "_fmap.json")
                logging.info(f"Writing feature map '{dest}' ...")
                mm.write_features_to_json(stats, dest)

            if heatmap and stats is not None and "heatmap" in stats:
                hm = stats["heatmap"]  # (1, C, F, H, W) float16 or uint8
                hm_np = np.transpose(hm[0], (1, 2, 3, 0)).astype(np.float32)
                if np.dtype(hm.dtype) == np.uint8:
                    hm_np /= 255.0  # the writers expect [0, 1] floats
                if hm.shape[2] > 1:
                    dest = os.path.join(out_dir, base + "_heatmap.mp4")
                    logging.info(f"Writing heat map '{dest}' ...")
                    np2vid(hm_np, dest, vs.get_frames_per_second(), args.verbose)
                else:
                    dest = os.path.join(out_dir, base + "_heatmap.png")
                    logging.info(f"Writing heat map '{dest}' ...")
                    np2img(hm_np, dest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
