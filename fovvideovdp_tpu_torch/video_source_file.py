"""File-based video and image sources.

Counterpart of ``fovvideovdp_tpu/video_source_file.py:38-693``:

* images (png/jpg/exr/hdr/...) -> the array source, any bit depth;
* videos (mp4/...) -> the ffmpeg binary on a rawvideo pipe, either decoding
  to RGB (ffmpeg converts colour, ``ffmpeg_cc=True``) or piping the raw YUV
  planes, which are upsampled and converted on the device (the default);
  without the ffmpeg/ffprobe binaries, OpenCV's bundled FFMPEG decodes
  (8-bit SDR only);
* ``.yuv`` raw files -> ``video_source_yuv``.

The pipe is drained by the native prefetching reader (``native``), which
reads each block's frames straight into a pinned staging buffer; the block
goes up to the card on a side stream (``video_source._HostBlocks``), the next
block's read and transfer starting while this one is scored.
``reader="python"`` reads the pipe with blocking reads instead; nothing
falls back to it.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from fovvideovdp_tpu_torch.io import RESIZE_METHODS, resize as resize_planes
from fovvideovdp_tpu_torch.io import yuv as yuv_io
from fovvideovdp_tpu_torch.io.images import load_image_as_array
from fovvideovdp_tpu_torch.ops.cuda.luminance import channels_to_luminance
from fovvideovdp_tpu_torch.video_source import (_HostBlocks, convert_frames,
                                                fvvdp_video_source, fvvdp_video_source_array,
                                                fvvdp_video_source_dm, host_tensor, is_run,
                                                resolve_device)
from fovvideovdp_tpu_torch.video_source_yuv import (READERS, fvvdp_video_source_yuv_file,
                                                    split_planes, yuv_block_to_luminance)

IMAGE_EXTENSIONS = [".png", ".jpg", ".gif", ".bmp", ".jpeg", ".ppm", ".tiff",
                    ".dds", ".exr", ".hdr"]


def _require_ffmpeg():
    path = shutil.which("ffmpeg")
    if path is None:
        raise RuntimeError(
            "The ffmpeg binary is required to decode video files but was not "
            "found on PATH. Use image inputs, raw .yuv files, or array sources.")
    return path


def _ffprobe(vidfile: str) -> dict:
    probe_bin = shutil.which("ffprobe")
    if probe_bin is None:
        raise RuntimeError("ffprobe not found — cannot inspect video files.")
    out = subprocess.run(
        [probe_bin, "-v", "quiet", "-print_format", "json", "-show_streams",
         "-show_format", vidfile], capture_output=True)
    if out.returncode != 0:
        raise RuntimeError(f'ffmpeg failed to open file "{vidfile}"')
    return json.loads(out.stdout)


def _stream_frame_count(stream: dict, probe: dict, fps: float) -> int:
    """Frame count with fallbacks: many containers lack nb_frames."""
    if "nb_frames" in stream:
        return int(stream["nb_frames"])
    for src in (stream, probe.get("format", {})):
        dur = src.get("duration")
        if dur is not None:
            # floor, not round: over-estimating by one makes the final block
            # read fail after the whole video has been scored
            return int(float(dur) * fps)
    raise RuntimeError(
        "Cannot determine the video frame count (no nb_frames/duration "
        "metadata); pass frames=N explicitly.")


def _byte_view(out) -> np.ndarray:
    """A flat uint8 numpy view of a contiguous host tensor or array."""
    arr = out.numpy() if isinstance(out, torch.Tensor) else out
    return arr.reshape(-1).view(np.uint8)


def _torch_dtype(dtype) -> torch.dtype:
    """The type raw frames of a numpy dtype travel in (uint16 as int16)."""
    return torch.int16 if np.dtype(dtype) == np.uint16 else torch.uint8


def _rgb_to_luminance(x: torch.Tensor, max_value: float, dm, rgb2y, resize=None,
                      out_hw=None) -> torch.Tensor:
    """(n, H, W, 3) raw RGB -> (n, H', W') luminance, a chunk of frames and
    one channel at a time: channel / max_value, then (when ``resize``) the
    resize to ``out_hw`` and a clip to [0, 1]."""
    n, H, W, _ = x.shape
    resized = resize is not None and tuple(out_hw) != (H, W)
    hw = tuple(out_hw) if resized else (H, W)

    def chunk(i, j):
        def channel(c):
            ch = yuv_io.as_float(x[i:j, ..., c]) / max_value
            if resized:
                ch = torch.clamp(resize_planes(ch, hw, RESIZE_METHODS[resize]), 0.0, 1.0)
            return ch
        return channels_to_luminance(channel, dm, rgb2y)
    return convert_frames(n, hw, max(H * W, hw[0] * hw[1]), x.device, chunk)


class video_reader:
    """Decode a video through an ffmpeg rawvideo pipe (RGB output)."""

    def __init__(self, vidfile, frames=-1, resize_fn=None, resize_height=-1,
                 resize_width=-1, verbose=False, reader="native"):
        if reader not in READERS:
            raise ValueError(f"reader must be one of {READERS}, got {reader!r}")
        self.reader = reader
        probe = _ffprobe(vidfile)
        stream = next(s for s in probe["streams"] if s["codec_type"] == "video")

        self.src_width = self.width = int(stream["width"])
        self.src_height = self.height = int(stream["height"])
        self.color_space = stream.get("color_space", "unknown")
        self.color_transfer = stream.get("color_transfer", "unknown")
        self.in_pix_fmt = stream["pix_fmt"]
        # avg_frame_rate = frames/duration; r_frame_rate is the container's
        # base tick rate, which over-reports for VFR/telecined streams
        rate = stream.get("avg_frame_rate", "0/0")
        num, den = (float(x) for x in rate.split("/"))
        if num <= 0 or den <= 0:
            num, den = (float(x) for x in stream["r_frame_rate"].split("/"))
        self.avg_fps = num / den
        if frames != -1 and "nb_frames" not in stream:
            num_frames = frames  # caller-specified count, metadata optional
        else:
            num_frames = _stream_frame_count(stream, probe, self.avg_fps)
        self.frames = num_frames if frames == -1 else min(num_frames, frames)

        self._setup_ffmpeg(vidfile, resize_fn, resize_height, resize_width, verbose)
        self.curr_frame = -1

    # host memory for the native prefetch ring, per stream
    _PIPE_RING_BYTES = 128 << 20

    def _spawn(self, args):
        self.process = subprocess.Popen(args, stdout=subprocess.PIPE,
                                        bufsize=max(self.frame_bytes * 4, 1 << 20))
        self._pipe = None  # native prefetcher, created on the first read

    def _pipe_reader(self):
        """The native prefetching pipe drain (created on the first read,
        once frame_bytes is final), or False with ``reader="python"``."""
        if self._pipe is None:
            if self.reader == "native":
                from fovvideovdp_tpu_torch.native import NativePipeReader
                ring = max(2, min(16, self._PIPE_RING_BYTES // self.frame_bytes))
                self._pipe = NativePipeReader(self.process.stdout.fileno(),
                                              self.frame_bytes, ring)
            else:
                self._pipe = False
        return self._pipe

    def _setup_ffmpeg(self, vidfile, resize_fn, resize_height, resize_width, verbose):
        if any(f"p{bd}" in self.in_pix_fmt for bd in (10, 12, 14, 16)):
            out_pix_fmt, self.bpp, self.dtype = "rgb48le", 6, np.uint16
        else:
            out_pix_fmt, self.bpp, self.dtype = "rgb24", 3, np.uint8

        ffmpeg_bin = _require_ffmpeg()
        vf = []
        if resize_fn is not None and (resize_width != self.width
                                      or resize_height != self.height):
            mode = "neighbor" if resize_fn == "nearest" else resize_fn
            vf = ["-vf", f"scale={resize_width}:{resize_height}:flags={mode}"]
            self.width, self.height = resize_width, resize_height

        self.frame_bytes = self.width * self.height * self.bpp
        self._spawn([ffmpeg_bin, "-nostdin", "-loglevel",
                     "info" if verbose else "quiet", "-i", vidfile, *vf,
                     "-f", "rawvideo", "-pix_fmt", out_pix_fmt, "pipe:"])

    def get_frame(self) -> Optional[np.ndarray]:
        block = self.get_frames_block(1)
        return None if block is None else block[0]

    def get_frames_block(self, count: int, out=None):
        """Read up to ``count`` frames from the pipe in one go.  Without
        ``out``: (n, frame_elems) raw values, None at EOF.  With ``out`` (a
        host buffer of count frames' bytes): the frames are written there and
        n is returned, 0 at EOF."""
        want = min(count, self.frames - 1 - self.curr_frame)
        if out is None:
            block = np.empty((max(want, 0), self.frame_bytes // np.dtype(self.dtype).itemsize),
                             dtype=self.dtype)
            n = self.get_frames_block(count, out=block)
            return block[:n] if n else None
        if want <= 0:
            return 0
        pipe = self._pipe_reader()
        if pipe:
            n = pipe.read_block(want, out=out)
        else:
            view = memoryview(_byte_view(out)[:want * self.frame_bytes])
            got = 0
            while got < len(view):
                k = self.process.stdout.readinto(view[got:])
                if not k:
                    break
                got += k
            n = got // self.frame_bytes
        self.curr_frame += n
        return n

    def unpack(self, frame: torch.Tensor) -> torch.Tensor:
        """One frame's raw values -> (H, W, 3) display-encoded RGB in [0, 1]."""
        return self.unpack_block(frame.reshape(1, -1))[0]

    def unpack_block(self, x: torch.Tensor) -> torch.Tensor:
        """(n, frame_elems) raw values -> (n, H, W, 3) RGB in [0, 1] on x's device."""
        max_value = 255.0 if self.dtype == np.uint8 else 65535.0
        return yuv_io.as_float(x.reshape(-1, self.height, self.width, 3)) / max_value

    def to_luminance(self, x: torch.Tensor, dm, rgb2y) -> torch.Tensor:
        """(n, frame_elems) raw values -> (n, H, W) absolute luminance."""
        max_value = 255.0 if self.dtype == np.uint8 else 65535.0
        return _rgb_to_luminance(x.reshape(-1, self.height, self.width, 3), max_value,
                                 dm, rgb2y)

    def close(self):
        if getattr(self, "process", None) is not None:
            proc, self.process = self.process, None
            # end the decoder FIRST: its death closes the pipe's write end,
            # which unblocks the native drain thread if it is mid-read; only
            # then is joining that thread safe
            proc.kill()
            pipe = getattr(self, "_pipe", None)
            if pipe:
                pipe.close()
                self._pipe = False
            proc.stdout.close()
            proc.wait()

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, type, value, tb):
        self.close()


class cv2_video_reader:
    """Decode a video through OpenCV's bundled FFMPEG, without external
    binaries: the fallback when ``ffmpeg``/``ffprobe`` are not on PATH.
    OpenCV converts every stream to 8-bit BGR, so this path is 8-bit SDR
    only.  Interface of :class:`video_reader`."""

    def __init__(self, vidfile, frames=-1, resize_fn=None, resize_height=-1,
                 resize_width=-1, verbose=False, reader="native"):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "Decoding video files needs either the ffmpeg binary on PATH "
                "or the opencv-python package; neither is available.") from e
        self._cap = cv2.VideoCapture(vidfile)
        if not self._cap.isOpened():
            raise RuntimeError(f'OpenCV failed to open file "{vidfile}"')
        self.src_width = self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.src_height = self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        # OpenCV exposes no colour metadata; sources treat unknown as sRGB
        self.color_space = "unknown"
        self.color_transfer = "unknown"
        self.in_pix_fmt = "unknown"
        self.dtype = np.uint8
        self.frame_bytes = self.width * self.height * 3
        self.avg_fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        if self.avg_fps <= 0:
            raise RuntimeError(f'Cannot determine the frame rate of "{vidfile}"')
        num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if num_frames <= 0:
            if frames == -1:
                raise RuntimeError(f'Cannot determine the frame count of "{vidfile}"; '
                                   f"pass frames=N explicitly.")
            num_frames = frames
        self.frames = num_frames if frames == -1 else min(num_frames, frames)

        if resize_fn is not None and (resize_width != self.width
                                      or resize_height != self.height):
            # resized on the device, like the YUV pipe
            self.resize_fn = resize_fn
            self.resize_height = resize_height
            self.resize_width = resize_width
        self.curr_frame = -1
        self._last_row = None
        self._eof_pad_left = self._EOF_PAD_MAX

    # CAP_PROP_FRAME_COUNT is an estimate for containers without an index and
    # can over-report: a few phantom tail frames repeat the last decoded frame
    _EOF_PAD_MAX = 4

    def get_frame(self) -> Optional[np.ndarray]:
        block = self.get_frames_block(1)
        return None if block is None else block[0]

    def get_frames_block(self, count: int, out=None):
        """Read up to ``count`` frames as (n, H*W*3) uint8 RGB rows (None at
        EOF), or into ``out`` as :meth:`video_reader.get_frames_block`."""
        want = min(count, self.frames - 1 - self.curr_frame)
        if want <= 0:
            return None if out is None else 0
        rows = []
        while len(rows) < want:
            ok, bgr = self._cap.read()
            if not ok:
                last = rows[-1] if rows else self._last_row
                missing = self.frames - 1 - self.curr_frame - len(rows)
                if last is None or missing > self._eof_pad_left:
                    break  # too short to paper over: surface the hard error
                n_pad = want - len(rows)
                logging.warning("video ended short of its metadata frame count; "
                                "repeating the last decoded frame %d time(s)", n_pad)
                self._eof_pad_left -= n_pad
                rows.extend([last] * n_pad)
                break
            rows.append(np.ascontiguousarray(bgr[:, :, ::-1]).reshape(-1))
        if not rows:
            return None if out is None else 0
        self._last_row = rows[-1]
        self.curr_frame += len(rows)
        if out is None:
            return np.stack(rows)
        view = _byte_view(out)[:len(rows) * self.frame_bytes].reshape(len(rows), -1)
        for k, row in enumerate(rows):
            view[k] = row
        return len(rows)

    def unpack(self, frame: torch.Tensor) -> torch.Tensor:
        return self.unpack_block(frame.reshape(1, -1))[0]

    def unpack_block(self, x: torch.Tensor) -> torch.Tensor:
        """(n, H*W*3) uint8 RGB -> (n, H', W', 3) in [0, 1] on x's device,
        with the optional full-screen resize."""
        RGB = x.reshape(-1, self.height, self.width, 3).to(torch.float32) / 255.0
        if getattr(self, "resize_fn", None) is not None:
            RGB = torch.clamp(resize_planes(
                RGB.permute(0, 3, 1, 2), (self.resize_height, self.resize_width),
                RESIZE_METHODS[self.resize_fn]), 0.0, 1.0).permute(0, 2, 3, 1)
        return RGB

    def to_luminance(self, x: torch.Tensor, dm, rgb2y) -> torch.Tensor:
        resize = getattr(self, "resize_fn", None)
        return _rgb_to_luminance(
            x.reshape(-1, self.height, self.width, 3), 255.0, dm, rgb2y, resize,
            (self.resize_height, self.resize_width) if resize else None)

    def close(self):
        cap, self._cap = getattr(self, "_cap", None), None
        if cap is not None:
            cap.release()

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, type, value, tb):
        self.close()


class video_reader_yuv_device(video_reader):
    """Pipe the raw YUV planes; chroma upsampling and YCbCr -> RGB run on
    the device."""

    def __init__(self, vidfile, frames=-1, resize_fn=None, resize_height=-1,
                 resize_width=-1, verbose=False, reader="native"):
        super().__init__(vidfile, frames, resize_fn, resize_height,
                         resize_width, verbose, reader)
        self.y_pixels = self.width * self.height
        self.y_shape = (self.height, self.width)
        if self.chroma_ss == "444":
            self.frame_bytes = self.y_pixels * 3
            self.uv_pixels = self.y_pixels
            self.uv_shape = self.y_shape
        elif self.chroma_ss == "420":
            self.frame_bytes = self.y_pixels * 3 // 2
            self.uv_pixels = self.y_pixels // 4
            self.uv_shape = (self.height // 2, self.width // 2)
        else:
            raise RuntimeError("Unrecognized chroma subsampling.")
        if self.bit_depth > 8:
            self.frame_bytes *= 2

    def _setup_ffmpeg(self, vidfile, resize_fn, resize_height, resize_width, verbose):
        m = re.search(r"p(\d+)", self.in_pix_fmt)
        self.bit_depth = 8 if m is None else int(m.group(1))
        # search, not a fixed slice: full-range 'yuvj420p' and alpha
        # 'yuva420p' formats put the subsampling digits at varying offsets
        m_ss = re.search(r"(444|422|420)", self.in_pix_fmt)
        self.chroma_ss = m_ss.group(1) if m_ss else self.in_pix_fmt
        if self.chroma_ss not in ("444", "420"):
            raise RuntimeError(
                f"Unsupported chroma subsampling in pix_fmt "
                f"'{self.in_pix_fmt}' (device path handles 420/444; pass "
                f"ffmpeg_cc=True / --ffmpeg-cc to convert in ffmpeg)")

        if self.bit_depth > 8:
            self.dtype = np.uint16
            out_pix_fmt = f"yuv{self.chroma_ss}p{self.bit_depth}le"
        else:
            self.dtype = np.uint8
            out_pix_fmt = f"yuv{self.chroma_ss}p"

        if resize_fn is not None:  # resized later on the device
            self.resize_fn = resize_fn
            self.resize_height = resize_height
            self.resize_width = resize_width

        self.frame_bytes = self.width * self.height * 3  # set in __init__
        ffmpeg_bin = _require_ffmpeg()
        self._spawn([ffmpeg_bin, "-nostdin", "-loglevel",
                     "info" if verbose else "quiet", "-i", vidfile,
                     "-f", "rawvideo", "-pix_fmt", out_pix_fmt, "pipe:"])

    def _resize_args(self):
        resize = getattr(self, "resize_fn", None)
        if resize is None:
            return dict(resize=None, rh=self.height, rw=self.width)
        return dict(resize=resize, rh=self.resize_height, rw=self.resize_width)

    def unpack_block(self, x: torch.Tensor) -> torch.Tensor:
        """(n, frame_elems) planar YUV -> (n, H', W', 3) RGB on x's device:
        chroma upsampling, colour conversion, the optional full-screen resize
        and a clip to [0, 1]."""
        Y, u, v = split_planes(x, self.width, self.height, self.chroma_ss)
        RGB = yuv_io.yuv_to_rgb(Y, u, v, self.bit_depth, self.chroma_ss,
                                bt2020=(self.color_space == "bt2020nc"))
        r = self._resize_args()
        if r["resize"] is not None and (self.height, self.width) != (r["rh"], r["rw"]):
            RGB = resize_planes(RGB.permute(0, 3, 1, 2), (r["rh"], r["rw"]),
                                RESIZE_METHODS[r["resize"]]).permute(0, 2, 3, 1)
        return torch.clamp(RGB, 0.0, 1.0)

    def to_luminance(self, x: torch.Tensor, dm, rgb2y) -> torch.Tensor:
        return yuv_block_to_luminance(
            x, self.width, self.height, self.bit_depth, self.chroma_ss,
            self.color_space == "bt2020nc", dm=dm, rgb2y=rgb2y,
            clip_before_resize=False, **self._resize_args())


class fvvdp_video_source_video_file(fvvdp_video_source_dm):
    """Frames streamed from two video files through ffmpeg pipes (or
    OpenCV), converted on ``device``."""

    def __init__(self, test_fname, reference_fname, display_photometry="sdr_4k_30",
                 color_space_name="auto", frames=-1, full_screen_resize=None,
                 resize_resolution=None, ffmpeg_cc=False, verbose=False,
                 device="cuda", reader="native"):
        fs_width = -1 if full_screen_resize is None else resize_resolution[0]
        fs_height = -1 if full_screen_resize is None else resize_resolution[1]
        if shutil.which("ffmpeg") is None or shutil.which("ffprobe") is None:
            logging.info("ffmpeg/ffprobe not found on PATH; decoding video "
                         "files through OpenCV (8-bit)")
            reader_cls = cv2_video_reader
        else:
            reader_cls = video_reader if ffmpeg_cc else video_reader_yuv_device
        kw = dict(resize_fn=full_screen_resize, resize_width=fs_width,
                  resize_height=fs_height, verbose=verbose, reader=reader)
        self.reference_vidr = reader_cls(reference_fname, frames, **kw)
        self.test_vidr = reader_cls(test_fname, frames, **kw)
        self.frames = self.test_vidr.frames if frames == -1 \
            else min(frames, self.test_vidr.frames)
        self.device = resolve_device(device)

        if color_space_name == "auto":
            color_space_name = "BT.2020" \
                if self.test_vidr.color_space == "bt2020nc" else "sRGB"
        super().__init__(display_photometry=display_photometry,
                         color_space_name=color_space_name)

        if isinstance(self.test_vidr, cv2_video_reader) \
                and getattr(self.dm_photometry, "EOTF", None) == "PQ":
            # OpenCV decodes to 8-bit SDR with no colour metadata: an HDR clip
            # would be tone-crushed and scored as sRGB
            raise RuntimeError(
                "The OpenCV decode fallback is 8-bit SDR only and cannot "
                "feed a PQ/HDR display model; install the ffmpeg binary or "
                "use raw .yuv input for HDR video files.")
        if self.test_vidr.color_transfer == "smpte2084" \
                and getattr(self.dm_photometry, "EOTF", None) != "PQ":
            logging.warning(
                f"Video color transfer function ({self.test_vidr.color_transfer}) "
                f"inconsistent with EOTF of the display model")
        self._cached_frame0 = None
        self._blocks = None
        if self.device.type == "cuda":
            self._blocks = _HostBlocks(self._fill, self._pair_bytes, self.device)

    def get_video_size(self):
        vr = self.test_vidr
        if getattr(vr, "resize_fn", None) is not None:
            return (vr.resize_height, vr.resize_width, self.frames)
        return (vr.height, vr.width, self.frames)

    def get_frames_per_second(self):
        return self.test_vidr.avg_fps

    def supports_random_access(self):
        return False  # strictly sequential pipes (the preload class overrides)

    # -- raw frames -----------------------------------------------------------
    def _pair_bytes(self, n: int) -> int:
        return n * (self.test_vidr.frame_bytes + self.reference_vidr.frame_bytes)

    def _read_next(self, vr, idx: np.ndarray, out) -> None:
        start, count = int(idx[0]), len(idx)
        if not is_run(idx) or start != vr.curr_frame + 1:
            raise RuntimeError(
                "Video can be currently only read frame-by-frame. "
                "Random access not implemented (use preload).")
        got = vr.get_frames_block(count, out=out)
        if got < count:
            raise RuntimeError(f"Could not read frames {start}..{start + count - 1} "
                               f"(got {got})")

    def _fill(self, idx: np.ndarray, buf) -> None:
        """Both streams' frames at idx into a flat host byte buffer, test first."""
        n_t = len(idx) * self.test_vidr.frame_bytes
        self._read_next(self.test_vidr, idx, buf[:n_t])
        self._read_next(self.reference_vidr, idx, buf[n_t:])

    def _luminance_pair(self, idx: np.ndarray):
        n = len(idx)
        if self._blocks is not None:
            flat = self._blocks.block(int(idx[0]), n) if is_run(idx) \
                else self._blocks.indexed(idx)
        else:
            flat = torch.empty(self._pair_bytes(n), dtype=torch.uint8)
            self._fill(idx, flat)
            flat = flat.to(self.device)
        n_t = n * self.test_vidr.frame_bytes
        return tuple(
            vr.to_luminance(part.view(_torch_dtype(vr.dtype)).view(n, -1),
                            self.dm_photometry, self.color_to_luminance)
            for part, vr in ((flat[:n_t], self.test_vidr), (flat[n_t:], self.reference_vidr)))

    def _frame_luminance(self, vr, frame_np: Optional[np.ndarray], frame: int) -> torch.Tensor:
        if frame_np is None:
            raise RuntimeError(f"Could not read frame {frame}")
        raw = host_tensor(frame_np.reshape(1, -1)).to(self.device)
        return vr.to_luminance(raw, self.dm_photometry, self.color_to_luminance)

    def _next_frame(self, vr, frame: int) -> torch.Tensor:
        if frame != vr.curr_frame + 1:
            raise RuntimeError(
                "Video can be currently only read frame-by-frame. "
                "Random access not implemented (use preload).")
        return self._frame_luminance(vr, vr.get_frame(), frame)

    def get_test_frame(self, frame, device=None):
        return self._next_frame(self.test_vidr, frame)[None, None]

    def get_reference_frame(self, frame, device=None):
        return self._next_frame(self.reference_vidr, frame)[None, None]

    def get_luminance_block(self, start, count):
        cached = self._cached_frame0
        if start == 0 and cached is not None:
            # frame 0 was already read for the replicate warm-up; splice the
            # cached copy in front of the live stream
            self._cached_frame0 = None
            if count == 1:
                out = cached
            else:
                t, r = self._luminance_pair(np.arange(1, count))
                out = torch.cat([cached[0], t]), torch.cat([cached[1], r])
        else:
            out = self._luminance_pair(np.arange(start, start + count))
        nxt = start + count
        if self._blocks is not None and nxt < self.frames:
            self._blocks.prefetch(nxt, min(count, self.frames - nxt))
        return out

    def get_indexed_luminance_block(self, indices):
        idx = [int(i) for i in indices]
        if not idx:
            H, W, _ = self.get_video_size()
            empty = torch.zeros((0, H, W), dtype=torch.float32, device=self.device)
            return empty, empty
        if set(idx) == {0} and self.test_vidr.curr_frame == -1:
            # 'replicate' temporal warm-up: fl-1 copies of the first frame.
            # Read it once, serve the copies, and keep it for the first
            # streaming block (which starts at frame 0 again).
            t0, r0 = self._luminance_pair(np.arange(1))
            self._cached_frame0 = (t0, r0)
            n = len(idx)
            return t0.repeat(n, 1, 1), r0.repeat(n, 1, 1)
        raise RuntimeError(
            "circular/pingpong temporal padding requires random access — "
            "use preload=True (fvvdp_video_source_video_file_preload)")


class fvvdp_video_source_video_file_preload(fvvdp_video_source_video_file):
    """Decodes every frame into host memory first, for random access."""

    def supports_random_access(self):
        return True

    def _ensure_loaded(self):
        if hasattr(self, "frame_array_tst"):
            return
        self.frame_array_tst = [self.test_vidr.get_frame() for _ in range(self.frames)]
        self.frame_array_ref = [self.reference_vidr.get_frame() for _ in range(self.frames)]
        mb = sum(f.nbytes for f in self.frame_array_tst if f is not None) * 2 / 1e6
        logging.debug(f"Preloaded {self.frames} frames (~{mb:.0f}MB host RAM)")

    def _fill(self, idx: np.ndarray, buf) -> None:
        self._ensure_loaded()
        view = _byte_view(buf)
        off = 0
        for arr in (self.frame_array_tst, self.frame_array_ref):
            for i in idx:
                if arr[i] is None:
                    raise RuntimeError(f"Could not read frame {i}")
                row = arr[i].reshape(-1).view(np.uint8)
                view[off:off + row.size] = row
                off += row.size

    def get_test_frame(self, frame, device=None):
        self._ensure_loaded()
        return self._frame_luminance(self.test_vidr, self.frame_array_tst[frame],
                                     frame)[None, None]

    def get_reference_frame(self, frame, device=None):
        self._ensure_loaded()
        return self._frame_luminance(self.reference_vidr, self.frame_array_ref[frame],
                                     frame)[None, None]

    def get_indexed_luminance_block(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        if len(idx) == 0:
            H, W, _ = self.get_video_size()
            empty = torch.zeros((0, H, W), dtype=torch.float32, device=self.device)
            return empty, empty
        return self._luminance_pair(idx)


class fvvdp_video_source_file(fvvdp_video_source):
    """Dispatch by extension: image pair, .yuv pair, or a decoded video."""

    def __init__(self, test_fname, reference_fname, display_photometry="sdr_4k_30",
                 color_space_name="auto", frames=-1, full_screen_resize=None,
                 resize_resolution=None, preload=False, ffmpeg_cc=False,
                 verbose=False, device="cuda", reader="native"):
        for fname in (test_fname, reference_fname):
            if not os.path.isfile(fname):
                raise FileNotFoundError(f'File does not exists: "{fname}"')

        test_ext = os.path.splitext(test_fname)[1].lower()
        ref_ext = os.path.splitext(reference_fname)[1].lower()

        if test_ext in IMAGE_EXTENSIONS:
            if ref_ext not in IMAGE_EXTENSIONS:
                raise RuntimeError("Test is an image, but reference is a video")
            if color_space_name == "auto":
                color_space_name = "sRGB"
            img_test = load_image_as_array(test_fname)
            img_reference = load_image_as_array(reference_fname)
            if full_screen_resize is not None:
                logging.error("full-screen-resize not implemented for images.")
            self.vs = fvvdp_video_source_array(
                img_test, img_reference, 0, dim_order="HWC",
                display_photometry=display_photometry,
                color_space_name=color_space_name, device=device)
        elif test_ext == ".yuv":
            self.vs = fvvdp_video_source_yuv_file(
                test_fname, reference_fname, display_photometry=display_photometry,
                color_space_name=color_space_name, frames=frames,
                full_screen_resize=full_screen_resize,
                resize_resolution=resize_resolution, verbose=verbose,
                device=device, reader=reader)
        else:
            if ref_ext in IMAGE_EXTENSIONS:
                raise RuntimeError("Test is a video, but reference is an image")
            cls = fvvdp_video_source_video_file_preload if preload \
                else fvvdp_video_source_video_file
            self.vs = cls(test_fname, reference_fname,
                          display_photometry=display_photometry,
                          color_space_name=color_space_name, frames=frames,
                          full_screen_resize=full_screen_resize,
                          resize_resolution=resize_resolution,
                          ffmpeg_cc=ffmpeg_cc, verbose=verbose, device=device,
                          reader=reader)

    def get_video_size(self):
        return self.vs.get_video_size()

    def get_frames_per_second(self):
        return self.vs.get_frames_per_second()

    def supports_random_access(self):
        return self.vs.supports_random_access()

    def get_test_frame(self, frame, device=None):
        return self.vs.get_test_frame(frame, device)

    def get_reference_frame(self, frame, device=None):
        return self.vs.get_reference_frame(frame, device)

    def get_luminance_block(self, start, count):
        return self.vs.get_luminance_block(start, count)

    def get_indexed_luminance_block(self, indices):
        return self.vs.get_indexed_luminance_block(indices)
