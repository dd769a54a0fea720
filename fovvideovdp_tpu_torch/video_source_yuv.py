"""Raw ``.yuv`` video source.

Counterpart of ``fovvideovdp_tpu/video_source_yuv.py:25-279``.  Video
properties come from the file name (``name_1920x1080_10b_420_2020_24fps.yuv``).
A block's raw planes are read by the native prefetching reader straight into
a pinned staging buffer and go up to the card on a side stream
(``video_source._HostBlocks``), the next block's read and transfer starting
while this block is scored; chroma upsampling, YCbCr -> RGB, the optional
full-screen resize, the EOTF and RGB -> Y then run on the device: on a
CUDA card without a resize as one kernel (``ops/cuda/yuv_luminance.py``),
else in PyTorch, one channel and a chunk of frames at a time.
``reader="python"`` reads through ``np.memmap`` instead of the native
reader; nothing falls back to it.
``fvvdp_video_source_yuv_array`` takes the same raw frames already in
memory (on the card, as a decoder leaves them) and converts them the same
way.
"""
from __future__ import annotations

import logging
import os
import re
from typing import NamedTuple

import numpy as np
import torch

from fovvideovdp_tpu_torch.io import RESIZE_METHODS, resize as resize_planes
from fovvideovdp_tpu_torch.io import yuv as yuv_io
from fovvideovdp_tpu_torch.ops.cuda import yuv_luminance as yuv_kernel
from fovvideovdp_tpu_torch.ops.cuda.luminance import channels_to_luminance
from fovvideovdp_tpu_torch.tracing import span
from fovvideovdp_tpu_torch.video_source import (_HostBlocks, convert_frames,
                                                fvvdp_video_source_dm, host_tensor, is_run,
                                                resolve_device)

READERS = ("native", "python")


def decode_video_props(fname: str) -> dict:
    """Parse video properties from a .yuv file name."""
    vprops = dict(width=1920, height=1080, fps=24, bit_depth=8,
                  color_space="2020", chroma_ss="420")
    bname = os.path.splitext(os.path.basename(fname))[0]
    res_match = re.compile(r"(\d+)x(\d+)p?")

    for field in bname.split("_"):
        m = res_match.fullmatch(field)
        if m:  # use the groups: '1920x1080p' must parse, not int('1080p')
            vprops["width"], vprops["height"] = int(m.group(1)), int(m.group(2))
            continue
        if field.endswith("fps"):
            vprops["fps"] = float(field[:-3])
        if field in ("444", "420"):
            vprops["chroma_ss"] = field
        if field in ("10", "10b"):
            vprops["bit_depth"] = 10
        if field in ("8", "8b"):
            vprops["bit_depth"] = 8
        if field in ("12", "12b"):
            vprops["bit_depth"] = 12
        if field in ("2020", "709"):
            vprops["color_space"] = field
        if field == "bt709":
            vprops["color_space"] = "709"
        if field in ("ct2020", "pq2020"):
            vprops["color_space"] = "2020"
    return vprops


def create_yuv_fname(basename: str, vprops: dict) -> str:
    """Build a property-encoding .yuv file name (inverse of
    decode_video_props)."""
    fps = vprops["fps"]
    fps = round(fps, 3) if round(fps) != fps else int(fps)
    return (f"{basename}_{vprops['width']}x{vprops['height']}_"
            f"{vprops['bit_depth']}b_{vprops['chroma_ss']}_"
            f"{vprops['color_space']}_{fps}fps.yuv")


def split_planes(raw: torch.Tensor, w: int, h: int, chroma_ss: str):
    """(n, frame_samples) raw frames -> (Y, u, v) views of (n, h, w) and
    the chroma planes' shape."""
    n = raw.shape[0]
    uv_h, uv_w = (h // 2, w // 2) if chroma_ss == "420" else (h, w)
    y_px, uv_px = w * h, uv_h * uv_w
    return (raw[:, :y_px].reshape(n, h, w),
            raw[:, y_px:y_px + uv_px].reshape(n, uv_h, uv_w),
            raw[:, y_px + uv_px:y_px + 2 * uv_px].reshape(n, uv_h, uv_w))


def yuv_block_to_luminance(raw: torch.Tensor, w: int, h: int, bd: int, ss: str,
                           bt2020: bool, resize, rh: int, rw: int, dm, rgb2y,
                           clip_before_resize: bool = True) -> torch.Tensor:
    """(n, frame_samples) raw fixed-point YUV -> (n, H', W') float32
    luminance on raw's device.  Frames on a CUDA card, with no full-screen
    resize that changes the size, 4:2:0 only at even luma sizes, and under
    one of ``display_model``'s photometries, are one launch of the
    ``yuv_luminance`` kernel, equal to the plain version bit for bit
    (``ops/cuda/yuv_luminance.uses_kernel``); anything else takes the plain
    version.
    Each call is one ``fvvdp.yuv`` span."""
    with span("fvvdp.yuv"):
        resized = resize is not None and (h != rh or w != rw)
        if yuv_kernel.uses_kernel(raw, w, h, ss, dm, resized):
            return yuv_kernel.yuv_luminance(raw, w, h, bd, ss, bt2020, dm, rgb2y)
        return yuv_block_to_luminance_plain(raw, w, h, bd, ss, bt2020, resize, rh, rw, dm,
                                            rgb2y, clip_before_resize)


def yuv_block_to_luminance_plain(raw: torch.Tensor, w: int, h: int, bd: int, ss: str,
                                 bt2020: bool, resize, rh: int, rw: int, dm, rgb2y,
                                 clip_before_resize: bool = True) -> torch.Tensor:
    """The conversion in PyTorch: per chunk of frames, the planes decoded
    and upsampled once, then each colour channel converted, clipped,
    resized, clipped and taken through the EOTF in turn.
    ``clip_before_resize`` is the .yuv source's order; the ffmpeg pipe
    clips after the resize only."""
    Y, u, v = split_planes(raw, w, h, ss)
    M = yuv_io.conversion_matrix(bt2020)
    resized = resize is not None and (h != rh or w != rw)
    out_hw = (rh, rw) if resized else (h, w)

    def chunk(i, j):
        planes = yuv_io.decoded_planes(Y[i:j], u[i:j], v[i:j], bd, ss)

        def channel(c):
            x = yuv_io.rgb_channel(planes, M, c)
            if clip_before_resize or not resized:
                x = torch.clamp(x, 0.0, 1.0)
            if resized:
                x = torch.clamp(resize_planes(x, out_hw, RESIZE_METHODS[resize]), 0.0, 1.0)
            return x
        return channels_to_luminance(channel, dm, rgb2y)
    return convert_frames(raw.shape[0], out_hw, max(h * w, rh * rw), raw.device, chunk)


class YUVReader:
    """Frame access to a raw .yuv file: the native prefetching reader, or
    ``np.memmap`` with ``reader="python"``."""

    def __init__(self, file_name: str, reader: str = "native"):
        if not os.path.isfile(file_name):
            raise FileNotFoundError(f"File {file_name} not found")
        if reader not in READERS:
            raise ValueError(f"reader must be one of {READERS}, got {reader!r}")
        self.file_name = file_name
        vprops = decode_video_props(file_name)

        self.width = vprops["width"]
        self.height = vprops["height"]
        self.fps = vprops["fps"]
        self.color_space = vprops["color_space"]
        self.chroma_ss = vprops["chroma_ss"]
        self.bit_depth = vprops["bit_depth"]

        self.y_pixels = self.width * self.height
        self.y_shape = (self.height, self.width)
        if self.chroma_ss == "444":
            self.frame_pixels = self.y_pixels * 3
            self.uv_pixels = self.y_pixels
            self.uv_shape = self.y_shape
        else:
            self.frame_pixels = self.y_pixels * 3 // 2
            self.uv_pixels = self.y_pixels // 4
            self.uv_shape = (self.height // 2, self.width // 2)

        self.frame_bytes = self.frame_pixels * (2 if self.bit_depth > 8 else 1)
        self.dtype = np.uint16 if self.bit_depth > 8 else np.uint8
        self.frame_count = int(os.stat(file_name).st_size // self.frame_bytes)
        self.mm = None
        self.native = None
        if reader == "native":
            from fovvideovdp_tpu_torch.native import NativeYuvReader
            self.native = NativeYuvReader(file_name, self.width, self.height,
                                          self.bit_depth, self.chroma_ss)

    def _memmap(self) -> np.ndarray:
        if self.mm is None:
            self.mm = np.memmap(self.file_name, self.dtype, mode="r")
        return self.mm

    def read_raw_indices(self, indices, out=None):
        """The frames at ``indices`` as (n, frame_samples) samples, or
        written into ``out`` (a host buffer of their bytes)."""
        idx = np.asarray(indices, dtype=np.int64)
        if self.native is not None:
            if is_run(idx):
                return self.native.read_block(int(idx[0]), len(idx), out=out)
            return self.native.read_indices(idx, out=out)
        if len(idx) and (idx.min() < 0 or idx.max() >= self.frame_count):
            raise RuntimeError(f"short read: frames {idx.tolist()} of {self.frame_count}")
        shape = (len(idx), self.frame_pixels)
        if out is None:
            dst = np.empty(shape, dtype=self.dtype)
        else:
            arr = out.numpy() if isinstance(out, torch.Tensor) else out
            nbytes = len(idx) * self.frame_bytes
            dst = arr.reshape(-1).view(np.uint8)[:nbytes].view(self.dtype).reshape(shape)
        mm = self._memmap()
        for k, i in enumerate(idx):
            off = int(i) * self.frame_pixels
            dst[k] = mm[off:off + self.frame_pixels]
        return out if out is not None else dst

    def read_raw_block(self, start: int, count: int, out=None):
        return self.read_raw_indices(np.arange(start, start + count), out=out)

    def get_frame_count(self) -> int:
        return self.frame_count

    def _planes(self, frame_index: int):
        if frame_index < 0 or frame_index >= self.frame_count:
            raise RuntimeError("The frame index is outside the range of available frames")
        mm = self._memmap()
        off = frame_index * self.frame_pixels
        Y = mm[off:off + self.y_pixels].reshape(self.y_shape)
        u = mm[off + self.y_pixels: off + self.y_pixels + self.uv_pixels].reshape(self.uv_shape)
        v = mm[off + self.y_pixels + self.uv_pixels: off + self.y_pixels
               + 2 * self.uv_pixels].reshape(self.uv_shape)
        return Y, u, v

    def get_frame_yuv(self, frame_index: int):
        return self._planes(frame_index)

    def get_frame_rgb(self, frame_index: int, device="cuda") -> torch.Tensor:
        """(H, W, 3) display-encoded RGB on ``device``."""
        Y, u, v = (host_tensor(p).to(device) for p in self._planes(frame_index))
        RGB = yuv_io.yuv_to_rgb(Y, u, v, self.bit_depth, self.chroma_ss,
                                bt2020=(self.color_space == "2020"))
        return torch.clamp(RGB, 0.0, 1.0)

    def close(self):
        self.mm = None
        if self.native is not None:
            self.native.close()

    def __enter__(self):
        return self

    def __exit__(self, type, value, tb):
        self.close()


class _yuv_pair_source(fvvdp_video_source_dm):
    """What the .yuv sources share: a raw (n, frame_samples) block of each
    side, wherever it comes from (``_raw_pair``, ``_raw_frame``), decoded
    by ``yuv_block_to_luminance`` under that side's format (an object with
    ``width``, ``height``, ``bit_depth``, ``chroma_ss`` and
    ``color_space``, ``self._formats``)."""

    full_screen_resize = None
    resize_resolution = None

    def _block_args(self, fmt):
        resize = self.full_screen_resize
        rh = self.resize_resolution[1] if resize is not None else fmt.height
        rw = self.resize_resolution[0] if resize is not None else fmt.width
        return dict(w=fmt.width, h=fmt.height, bd=fmt.bit_depth, ss=fmt.chroma_ss,
                    bt2020=(fmt.color_space == "2020"), resize=resize,
                    rh=rh, rw=rw, dm=self.dm_photometry, rgb2y=self.color_to_luminance)

    def _luminance_pair(self, idx: np.ndarray):
        raws = self._raw_pair(idx)
        return tuple(yuv_block_to_luminance(raw, **self._block_args(fmt))
                     for raw, fmt in zip(raws, self._formats))

    def get_luminance_block(self, start, count):
        out = self._luminance_pair(np.arange(start, start + count))
        nxt = start + count
        if self._blocks is not None and nxt < self.frames:
            self._blocks.prefetch(nxt, min(count, self.frames - nxt))
        return out

    def get_indexed_luminance_block(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        if len(idx) == 0:
            h, w, _ = self.get_video_size()
            empty = torch.zeros((0, h, w), dtype=torch.float32, device=self.device)
            return empty, empty
        # each distinct frame is read and converted once: the replicate
        # warm-up asks for fl-1 copies of frame 0
        frames, where = np.unique(idx, return_inverse=True)
        pair = self._luminance_pair(frames)
        if len(frames) == len(idx) and np.array_equal(frames, idx):
            return pair
        where = torch.as_tensor(where, device=self.device)
        return tuple(x.index_select(0, where) for x in pair)

    def _frame_lum(self, side: int, frame: int) -> torch.Tensor:
        raw = self._raw_frame(side, frame)
        return yuv_block_to_luminance(raw, **self._block_args(self._formats[side]))[None, None]

    def get_test_frame(self, frame, device=None):
        return self._frame_lum(0, frame)

    def get_reference_frame(self, frame, device=None):
        return self._frame_lum(1, frame)


class fvvdp_video_source_yuv_file(_yuv_pair_source):
    """Test/reference pair of raw .yuv files, converted on ``device``."""

    def __init__(self, test_fname, reference_fname, display_photometry="standard_4k",
                 color_space_name="auto", frames=-1, full_screen_resize=None,
                 resize_resolution=None, verbose=False, device="cuda", reader="native"):
        self.reference_vidr = YUVReader(reference_fname, reader)
        self.test_vidr = YUVReader(test_fname, reader)
        self._formats = (self.test_vidr, self.reference_vidr)
        self.frames = self.test_vidr.frame_count if frames == -1 \
            else min(self.test_vidr.frame_count, frames)
        self.full_screen_resize = full_screen_resize
        self.resize_resolution = resize_resolution
        self.device = resolve_device(device)

        if color_space_name == "auto":
            color_space_name = "BT.2020" if self.test_vidr.color_space == "2020" else "sRGB"
        super().__init__(display_photometry=display_photometry,
                         color_space_name=color_space_name)

        for vr, name in ((self.test_vidr, test_fname), (self.reference_vidr, reference_fname)):
            logging.debug(
                f"  '{name}': [{vr.width}x{vr.height}], colorspace: "
                f"{vr.color_space}, bit depth: {vr.bit_depth}, fps: {vr.fps}, "
                f"chroma: {vr.chroma_ss}, frames: {self.frames}")
        self._blocks = None
        if self.device.type == "cuda":
            self._blocks = _HostBlocks(self._fill, self._pair_bytes, self.device)

    def get_video_size(self):
        if self.full_screen_resize is not None:
            return (self.resize_resolution[1], self.resize_resolution[0], self.frames)
        return (self.test_vidr.height, self.test_vidr.width, self.frames)

    def get_frames_per_second(self):
        return self.test_vidr.fps

    def _pair_bytes(self, n: int) -> int:
        return n * (self.test_vidr.frame_bytes + self.reference_vidr.frame_bytes)

    def _fill(self, idx: np.ndarray, buf: torch.Tensor) -> None:
        """Both files' frames at idx into a flat host byte buffer, test first."""
        n_t = len(idx) * self.test_vidr.frame_bytes
        self.test_vidr.read_raw_indices(idx, out=buf[:n_t])
        self.reference_vidr.read_raw_indices(idx, out=buf[n_t:])

    def _split(self, flat: torch.Tensor, n: int):
        """A flat byte block -> the (n, frame_samples) test and reference frames."""
        n_t = n * self.test_vidr.frame_bytes
        return tuple(part.view(torch.int16 if vr.bit_depth > 8 else torch.uint8).view(n, -1)
                     for part, vr in ((flat[:n_t], self.test_vidr),
                                      (flat[n_t:], self.reference_vidr)))

    def _raw_pair(self, idx: np.ndarray):
        if self._blocks is not None:
            if is_run(idx):
                flat = self._blocks.block(int(idx[0]), len(idx))
            else:
                flat = self._blocks.indexed(idx)
        else:
            flat = torch.empty(self._pair_bytes(len(idx)), dtype=torch.uint8)
            self._fill(idx, flat)
            flat = flat.to(self.device)
        return self._split(flat, len(idx))

    def _raw_frame(self, side: int, frame: int) -> torch.Tensor:
        return host_tensor(self._formats[side].read_raw_block(frame, 1)).to(self.device)


class YUVFormat(NamedTuple):
    """The layout of raw Y'CbCr frames: planar Y, then Cb, then Cr, each
    sample in one byte (8 bits) or one 16-bit word (10 and 12 bits),
    narrow range; ``chroma_ss`` "420" or "444", ``color_space`` "2020" or
    "709" (the Y'CbCr -> R'G'B' matrix)."""
    width: int
    height: int
    bit_depth: int
    chroma_ss: str
    color_space: str

    @property
    def frame_samples(self) -> int:
        y = self.width * self.height
        return y * 3 // 2 if self.chroma_ss == "420" else y * 3

    @property
    def sample_dtype(self) -> torch.dtype:
        return torch.int16 if self.bit_depth > 8 else torch.uint8


def _stored_yuv(x, fmt: YUVFormat, device: torch.device) -> torch.Tensor:
    """Raw frames (a tensor or an array) -> the (F, frame_samples) tensor of
    their stored samples on ``device`` (uint16 as int16)."""
    t = x if isinstance(x, torch.Tensor) else host_tensor(np.asarray(x))
    if t.dtype == getattr(torch, "uint16", None):
        t = t.view(torch.int16)
    if t.dtype != fmt.sample_dtype:
        raise RuntimeError(f"{fmt.bit_depth}-bit samples are stored as {fmt.sample_dtype} "
                           f"(uint16 as int16), got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != fmt.frame_samples:
        raise RuntimeError(f"raw frames must be (F, {fmt.frame_samples}) for {fmt.width}x"
                           f"{fmt.height} {fmt.chroma_ss}, got {tuple(t.shape)}")
    return t.to(device)


class fvvdp_video_source_yuv_array(_yuv_pair_source):
    """Test/reference pair of raw Y'CbCr frames held in memory, as a
    decoder writes them: each clip an (F, frame_samples) tensor of stored
    samples in the .yuv layout (``YUVFormat``), 16-bit words as int16 (or
    uint16) and 8-bit samples as uint8.  Clips on the card stay there and
    each block is a slice of them; others are copied to ``device`` once.
    The conversion is the .yuv file source's."""

    def __init__(self, test, reference, fps, width, height, bit_depth=10, chroma_ss="420",
                 color_space="2020", display_photometry="standard_4k",
                 color_space_name="auto", device="cuda"):
        if chroma_ss not in ("420", "444"):
            raise ValueError(f'chroma_ss must be "420" or "444", got {chroma_ss!r}')
        if color_space not in ("2020", "709"):
            raise ValueError(f'color_space must be "2020" or "709", got {color_space!r}')
        fmt = YUVFormat(int(width), int(height), int(bit_depth), chroma_ss, color_space)
        self._formats = (fmt, fmt)
        self.device = resolve_device(device)
        self._t = _stored_yuv(test, fmt, self.device)
        self._r = _stored_yuv(reference, fmt, self.device)
        if self._t.shape != self._r.shape:
            raise RuntimeError("Test and reference clips must have the same number of frames")
        self.frames = self._t.shape[0]
        self.fps = fps
        if color_space_name == "auto":
            color_space_name = "BT.2020" if color_space == "2020" else "sRGB"
        super().__init__(display_photometry=display_photometry,
                         color_space_name=color_space_name)

    def get_video_size(self):
        fmt = self._formats[0]
        return (fmt.height, fmt.width, self.frames)

    def get_frames_per_second(self):
        return self.fps

    def _raw_pair(self, idx: np.ndarray):
        if is_run(idx):
            sl = slice(int(idx[0]), int(idx[-1]) + 1)
            return self._t[sl], self._r[sl]
        i = torch.as_tensor(idx, device=self.device)
        return self._t.index_select(0, i), self._r.index_select(0, i)

    def _raw_frame(self, side: int, frame: int) -> torch.Tensor:
        return (self._t, self._r)[side][frame:frame + 1]
