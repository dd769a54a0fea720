"""Raw Y'CbCr frames -> absolute luminance: wrapper of
``csrc/yuv_luminance.cu``, its float32 constants and its tap tables.

Replaces no TPU kernel: the JAX package jits the conversion and XLA fuses
it (``fovvideovdp_tpu/video_source_yuv.py:_yuv_block_to_luminance``).  The
plain version is ``video_source_yuv.yuv_block_to_luminance_plain``.  No
table of codes can stand in for it, as ``ops/cuda/luminance.py``'s do for
RGB: the three planes mix through the Y'CbCr -> R'G'B' matrix before the
EOTF, and 4:2:0 chroma is interpolated.  So the kernel computes the plain
version's operations for each pixel, in its order, with the float32
constants ATen makes of the plain version's Python scalars on the card
(:func:`photometry_params`, :func:`kernel_params`), and the weights of
``io._taps``' 4:2:0 taps (:func:`tap_tables`); it equals the plain version
on the card bit for bit.

Which conversions take the kernel (:func:`uses_kernel`) depends on the
input alone: raw frames on a CUDA card, no full-screen resize that changes
the size, 4:2:0 chroma only at even luma sizes (an even 2x upscale), and a
photometry of one of ``display_model``'s three classes whose power, if it
has one, ATen takes through powf.  Anything else keeps the plain version.
"""
from __future__ import annotations

import collections
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fovvideovdp_tpu_torch import display_model as dmod
from fovvideovdp_tpu_torch.io import _taps
from fovvideovdp_tpu_torch.io import yuv as yuv_io
from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.ops.pyramid import ceildiv

# csrc/yuv_luminance.cu: threads a block, and a thread's tile of output pixels
THREADS = 256
TILE_ROWS, TILE_COLS = 2, 4
# the kernel's photometry kinds (its enum Kind)
KINDS = {"sRGB": 0, "gamma": 1, "PQ": 2, "clamp": 3}
# tap tables kept (8 B an output row or column: 48 KB at 4K)
MAX_TAPS = 32

_f32 = np.float32


class Photometry(NamedTuple):
    """What the kernel needs of a photometry: its kind, the Python scalars
    of its ``forward`` (as Python numbers; made float32 by
    :func:`kernel_params`) and a flag.  ``forward``'s clamp of V to [0, 1]
    has no counterpart: the channels it gets are clamped to [0, 1]
    already."""
    kind: str
    scale: float            # Y_peak - Y_black, the factor of sRGB and gamma
    black: float            # Y_black, added last
    lo: float               # the final clamp (PQ, clamp)
    hi: float
    gamma: float
    add_black: bool         # clamp: Y_black added after it


def photometry_params(dm) -> Optional[Photometry]:
    """The kernel's view of ``dm.forward``, or None for a photometry it
    does not compute: a class other than ``display_model``'s three (a
    subclass included, which may override ``forward``), an unknown EOTF
    (the plain version raises for it), or a power that ATen does not take
    through powf (:func:`takes_powf`)."""
    cls = type(dm)
    if cls is dmod.fvvdp_display_photo_eotf:
        kind = {"sRGB": "sRGB", "gamma": "gamma", "PQ": "PQ", "linear": "clamp"}.get(dm.EOTF)
        black = dm.get_black_level()
        ph = None if kind is None else Photometry(kind, dm.Y_peak - black, black, 0.005,
                                                  dm.Y_peak, dm.gamma, add_black=True)
    elif cls is dmod.fvvdp_display_photo_gog:
        black = dm.get_black_level()
        ph = Photometry("sRGB" if dm.gamma == -1 else "gamma", dm.Y_peak - black, black,
                        0.0, 0.0, dm.gamma, add_black=True)
    elif cls is dmod.fvvdp_display_photo_absolute:
        ph = Photometry("clamp", 0.0, 0.0, dm.L_min, dm.L_max, 0.0, add_black=False)
    else:
        ph = None
    if ph is not None and ph.kind == "gamma" and not takes_powf(ph.gamma):
        return None
    return ph


def takes_powf(e) -> bool:
    """Whether ``torch.pow(tensor, e)`` on the card is powf, the kernel's
    only power: ATen fills, copies, takes sqrt, rsqrt or the reciprocal
    for e = 0, 1, 0.5, -0.5, -1, and then, with e made float32, squares,
    cubes or takes 1 / (x * x) in double for 2, 3, -2."""
    e = float(e)
    return e not in (0.0, 1.0, 0.5, -0.5, -1.0) and float(_f32(e)) not in (2.0, 3.0, -2.0)


def _decode(bit_depth: int):
    """fixed2float_y's and fixed2float_uv's weights and offsets."""
    scale = 2 ** (bit_depth - 8)
    return [1.0 / (scale * 219.0), 16.0 / 219.0, 1.0 / (scale * 224.0), 128.0 / 224.0]


def kernel_params(bit_depth: int, bt2020: bool, ph: Photometry, rgb2y) -> np.ndarray:
    """The kernel's 32 float32 constants, in its struct Params' order.  A
    Python scalar becomes float32 as ATen makes it on the card; a division
    by one (srgb2lin's) is, as ATen computes it there, a product with its
    reciprocal, taken in double and made float32."""
    k = dmod._PQ
    floats = (_decode(bit_depth) + [float(m) for m in yuv_io.conversion_matrix(bt2020).ravel()]
              + [float(w) for w in rgb2y]
              + [ph.scale, ph.black, ph.lo, ph.hi, ph.gamma])
    params = np.array(floats, dtype=np.float32)
    # srgb2lin: V > 0.04045, (V + 0.055) / 1.055, ** 2.4, V / 12.92
    srgb = [_f32(0.04045), _f32(0.055), _f32(1.0 / 1.055), _f32(1.0 / 12.92), _f32(2.4)]
    # pq2lin: ** (1 / m), c1, c2, c3, ** (1 / n), Lmax
    pq = [_f32(1.0 / k["m"]), _f32(k["c1"]), _f32(k["c2"]), _f32(k["c3"]),
          _f32(1.0 / k["n"]), _f32(k["Lmax"])]
    return np.concatenate([params, np.array(srgb + pq, dtype=np.float32)])


def uses_kernel(raw: torch.Tensor, w: int, h: int, chroma_ss: str, dm, resized: bool) -> bool:
    """Whether the kernel converts these raw frames: on a CUDA card, with
    no full-screen resize that changes the size, 4:2:0 only at an even
    width and height, under a photometry it computes.  CPU tensors take the
    plain version; so do odd 4:2:0 luma sizes, whose chroma is no 2x
    upscale and whose frame rows the sources make ``w * h * 3 // 2`` long."""
    return (raw.device.type == "cuda" and not resized
            and (chroma_ss != "420" or (w % 2 == 0 and h % 2 == 0))
            and photometry_params(dm) is not None)


def frame_samples(w: int, h: int, chroma_ss: str) -> int:
    cw, ch = chroma_shape(w, h, chroma_ss)
    return w * h + 2 * cw * ch


def chroma_shape(w: int, h: int, chroma_ss: str) -> Tuple[int, int]:
    """(width, height) of a chroma plane, as ``split_planes`` cuts it."""
    return (w // 2, h // 2) if chroma_ss == "420" else (w, h)


def check_raw(raw: torch.Tensor, w: int, h: int, bit_depth: int, chroma_ss: str) -> None:
    """Raise on raw frames the kernel does not take: 4:2:0 at an odd luma
    size, other than (n, frame_samples), a sample type other than the bit
    depth's (uint8 up to 8 bits, int16 holding uint16 above), frame rows
    whose samples are not contiguous."""
    if chroma_ss not in ("420", "444"):
        raise ValueError(f'chroma_ss must be "420" or "444", got {chroma_ss!r}')
    if chroma_ss == "420" and (w % 2 or h % 2):
        raise RuntimeError(f"4:2:0 frames of {w}x{h}: the kernel takes even luma sizes only")
    want = torch.int16 if bit_depth > 8 else torch.uint8
    if raw.dtype != want:
        raise RuntimeError(f"{bit_depth}-bit samples are stored as {want} (uint16 as int16), "
                           f"got {raw.dtype}")
    fs = frame_samples(w, h, chroma_ss)
    if raw.dim() != 2 or raw.shape[1] != fs:
        raise RuntimeError(f"raw frames must be (n, {fs}) for {w}x{h} {chroma_ss}, "
                           f"got {tuple(raw.shape)}")
    if raw.shape[1] > 1 and raw.stride(1) != 1:
        raise RuntimeError(f"a frame's samples must be contiguous, got strides {raw.stride()}")


# ---------------------------------------------------------------------------
# Tap tables
# ---------------------------------------------------------------------------

class _Entry(NamedTuple):
    weights: torch.Tensor
    stream: Optional[torch.cuda.Stream]     # the stream that copied them (None on the CPU)
    ready: Optional[torch.cuda.Event]


_taps_cache: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
_taps_lock = threading.Lock()


def _two_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """``io._taps``' linear taps, a one-tap axis padded with index 0,
    weight 0."""
    idx, w = _taps(in_size, out_size, "linear")
    if idx.shape[1] == 1:
        idx = np.concatenate([idx, np.zeros_like(idx)], axis=1)
        w = np.concatenate([w, np.zeros_like(w)], axis=1)
    return idx, w


def regular_taps(idx: np.ndarray, w: np.ndarray, in_size: int, out_size: int) -> bool:
    """Whether one axis' (out_size, 2) taps are those of the kernel's
    window (csrc/yuv_luminance.cu:chroma_tile_2x): an even 2x upscale,
    output 2a reading inputs (a - 1, a) and output 2a + 1 reading (a, a + 1),
    each clamped to the plane, wherever the tap's weight is not 0."""
    if out_size != 2 * in_size or idx.shape[1] != 2:
        return False
    first = (np.arange(out_size) + 1) // 2 - 1
    want = np.clip(np.stack([first, first + 1], axis=1), 0, in_size - 1)
    return bool(np.all((idx == want) | (w == 0)))


def build_taps(h: int, w: int, device) -> torch.Tensor:
    """The weights of the bilinear taps of an (h / 2, w / 2) chroma plane
    upsampled to (h, w), float32: the (h, 2) rows' then the (w, 2)
    columns', copied to ``device`` once.  Raises where ``io._taps`` does
    not follow the kernel's window."""
    weights = []
    for out_size in (h, w):
        idx, wt = _two_taps(out_size // 2, out_size)
        if out_size % 2 or not regular_taps(idx, wt, out_size // 2, out_size):
            raise ValueError(f"the chroma taps of {out_size // 2} -> {out_size} are not the "
                             f"kernel's 2x window")
        weights.append(wt.ravel())
    return torch.from_numpy(np.concatenate(weights).astype(np.float32)).to(device)


def tap_tables(h: int, w: int, device) -> torch.Tensor:
    """The weights of :func:`build_taps`, cached by shape and device;
    weights copied on another stream are waited for on the current one."""
    device = torch.device(device)
    key = (h, w, device)
    with _taps_lock:
        entry = _taps_cache.get(key)
        if entry is not None:
            _taps_cache.move_to_end(key)
    current = torch.cuda.current_stream(device) if device.type == "cuda" else None
    if entry is None:
        entry = _Entry(build_taps(h, w, device), current,
                       None if current is None else current.record_event())
        with _taps_lock:
            _taps_cache[key] = entry
            while len(_taps_cache) > MAX_TAPS:
                _taps_cache.popitem(last=False)
    elif entry.stream != current:
        current.wait_event(entry.ready)
        entry.weights.record_stream(current)
    return entry.weights


# ---------------------------------------------------------------------------
# Launch plan and launch
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    """How one launch runs: the samples between frames, the arm (vector
    loads and float4 stores on whole tiles, or the masked arm everywhere)
    and the grid of one thread a tile: ``blocks`` of a frame's tiles along
    x, the frames along y."""
    frame_stride: int
    vec: bool
    frame_tiles: int
    blocks: int


def launch_plan(raw: torch.Tensor, out: torch.Tensor, w: int, h: int) -> LaunchPlan:
    """The plan for raw (n, frame_samples) into the contiguous (n, h, w)
    out; reads shapes, strides and addresses only, on any device.  The
    vector arm needs rows a multiple of 4 pixels long, frames a multiple of
    4 samples apart, raw on a boundary of 4 samples and out on a 16-byte
    one."""
    n = raw.shape[0]
    frame_stride = raw.stride(0) if n > 1 else raw.shape[1]
    vec = (w % TILE_COLS == 0 and frame_stride % TILE_COLS == 0
           and raw.data_ptr() % (TILE_COLS * raw.element_size()) == 0
           and out.data_ptr() % 16 == 0)
    frame_tiles = ceildiv(h, TILE_ROWS) * ceildiv(w, TILE_COLS)
    return LaunchPlan(frame_stride, vec, frame_tiles, ceildiv(frame_tiles, THREADS))


def yuv_luminance(raw: torch.Tensor, w: int, h: int, bit_depth: int, chroma_ss: str,
                  bt2020: bool, dm, rgb2y) -> torch.Tensor:
    """(n, frame_samples) raw Y'CbCr frames on a CUDA card -> (n, h, w)
    float32 absolute luminance: one launch of the kernel, reading the
    samples in place (n up to 65,535, the grid's y)."""
    check_raw(raw, w, h, bit_depth, chroma_ss)
    ph = photometry_params(dm)
    if ph is None:
        raise ValueError(f"the kernel does not compute the photometry {type(dm).__name__}")
    out = torch.empty((raw.shape[0], h, w), dtype=torch.float32, device=raw.device)
    if out.numel() == 0:
        return out
    taps = tap_tables(h, w, raw.device) if chroma_ss == "420" else None
    plan = launch_plan(raw, out, w, h)
    params = kernel_params(bit_depth, bt2020, ph, rgb2y)
    fn = _lib.kernel_fn("yuv_luminance")
    with torch.cuda.device(raw.device):
        rc = fn(raw.data_ptr(), out.data_ptr(), None if taps is None else taps.data_ptr(),
                raw.shape[0], plan.frame_stride, w, h, raw.element_size(),
                int(chroma_ss == "420"), KINDS[ph.kind], int(plan.vec), params.ctypes.data,
                int(ph.add_black), _lib.stream_ptr(raw))
    _lib.check(rc, "yuv_luminance")
    _lib.count_launch("yuv_luminance")
    return out
