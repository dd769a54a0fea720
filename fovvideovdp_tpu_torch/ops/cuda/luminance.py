"""Display-encoded colour frames -> absolute luminance: wrapper of
``csrc/luminance.cu``, its per-code tables and its plain version.

Replaces no TPU kernel: the JAX package's decode, EOTF and RGB -> Y
(``fovvideovdp_tpu/video_source.py:_luminance_cfirst``) are fused by XLA.
The plain version is that arithmetic in PyTorch, one channel's float32
temporaries live at a time.  For integer codes (uint8, and 16-bit values
stored as int16) it is a function of the stored code alone, so on the card
:func:`tables` evaluates it once per code with the plain version's own
calls and the kernel reads each code once, looks it up and writes float32
once; it equals the plain version bit for bit.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.ops.pyramid import ceildiv

# stored code types the kernel takes, and their number of codes
N_CODES = {torch.uint8: 256, torch.int16: 65536}
# csrc/luminance.cu: threads a block, groups of 4 pixels a thread in flight
THREADS = 256
GROUPS_PER_THREAD = 4
# two waves of 4 blocks on each of the 132 SMs
FILL_BLOCKS = 1056
# tables kept (3 KB for uint8 RGB, 768 KB for 16-bit)
MAX_TABLES = 32


def decode_raw(x: torch.Tensor) -> torch.Tensor:
    """Raw stored pixel values -> display-encoded float32 in [0, 1]."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    if x.dtype == torch.int16:
        # 16-bit input travels as int16 (uint16 reinterpreted bit for bit)
        return (x.to(torch.int32) & 0xFFFF).to(torch.float32) / 65535.0
    return x.to(torch.float32)


def channels_to_luminance(channel: Callable[[int], torch.Tensor], dm, rgb2y) -> torch.Tensor:
    """Absolute luminance from the display-encoded colour channels that
    ``channel(c)`` gives, c = 0, 1, 2: one channel's float32 intermediate
    live at a time."""
    L = dm.forward(channel(0)) * rgb2y[0]
    L = L + dm.forward(channel(1)) * rgb2y[1]
    return L + dm.forward(channel(2)) * rgb2y[2]


def luminance_plain(blk: torch.Tensor, dm, rgb2y) -> torch.Tensor:
    """(C, n, ...) raw frames -> (n, ...) absolute luminance, in PyTorch."""
    if blk.shape[0] == 3:
        return channels_to_luminance(lambda c: decode_raw(blk[c]), dm, rgb2y)
    return dm.forward(decode_raw(blk[0]))


def uses_kernel(blk: torch.Tensor) -> bool:
    """Whether the kernel converts these frames: integer codes on a CUDA
    card.  Float frames cannot be tabulated (and may carry a gradient);
    CPU tensors take the plain version."""
    return blk.device.type == "cuda" and blk.dtype in N_CODES


def luminance(blk: torch.Tensor, dm, rgb2y) -> torch.Tensor:
    """(C, n, ...) raw frames, C = 1 or 3 -> (n, ...) float32 absolute
    luminance under the photometry ``dm`` and the RGB -> Y weights
    ``rgb2y``.  Integer codes on a CUDA card launch the kernel, in place
    through the view's strides; anything else takes the plain version."""
    if not uses_kernel(blk):
        return luminance_plain(blk, dm, rgb2y)
    if blk.shape[0] not in (1, 3):
        raise ValueError(f"luminance takes 1 or 3 colour channels, got {blk.shape[0]}")
    return launch(blk, tables(dm, rgb2y, blk.dtype, blk.shape[0], blk.device))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

class _Entry(NamedTuple):
    tables: torch.Tensor
    stream: torch.cuda.Stream       # the stream that computed them
    ready: torch.cuda.Event         # recorded on it after the computation


_tables: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
_tables_lock = threading.Lock()


def table_key(dm, rgb2y, dtype: torch.dtype, channels: int, device) -> tuple:
    """What a table depends on, by value: the photometry's class and
    parameters, the weights (none for grey), the code type and the device."""
    params = tuple(sorted((k, repr(v)) for k, v in vars(dm).items()))
    weights = tuple(float(w) for w in rgb2y) if channels == 3 else None
    return (type(dm), params, weights, dtype, torch.device(device))


def build_tables(dm, rgb2y, dtype: torch.dtype, channels: int, device) -> torch.Tensor:
    """(channels, codes) float32: every code through the plain version's
    decode, ``dm.forward`` and weight, with the same torch calls on
    ``device``, so each entry is what the plain version computes for that
    code there.  No host copy, no synchronisation."""
    codes = torch.arange(N_CODES[dtype], dtype=torch.int32, device=device).to(dtype)
    Y = dm.forward(decode_raw(codes))
    if channels == 1:
        return Y[None].contiguous()
    return torch.stack([Y * rgb2y[c] for c in range(3)])


def tables(dm, rgb2y, dtype: torch.dtype, channels: int, device) -> torch.Tensor:
    """The tables of :func:`build_tables`, cached by :func:`table_key`.
    Tables computed on another stream are waited for on the current one."""
    key = table_key(dm, rgb2y, dtype, channels, device)
    with _tables_lock:
        entry = _tables.get(key)
        if entry is not None:
            _tables.move_to_end(key)
    current = torch.cuda.current_stream(device)
    if entry is None:
        t = build_tables(dm, rgb2y, dtype, channels, device)
        entry = _Entry(t, current, current.record_event())
        with _tables_lock:
            _tables[key] = entry
            while len(_tables) > MAX_TABLES:
                _tables.popitem(last=False)
    elif entry.stream != current:
        current.wait_event(entry.ready)
        entry.tables.record_stream(current)
    return entry.tables


# ---------------------------------------------------------------------------
# Launch plan and launch
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    """How one conversion is launched: pixel p = r * row_len + j of the
    output reads element r * row_stride + j * pixel_stride + c *
    channel_stride of channel c; the arm (word loads, or one code at a
    time); and the grid."""
    rows: int
    row_len: int
    row_stride: int
    pixel_stride: int
    channel_stride: int
    interleaved: bool
    vec: bool
    blocks: int


def pixel_rows(blk: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """(rows, row_len, row_stride, pixel_stride) of the pixels of the (C,
    ...) view blk, its dims after the first merged where the strides
    allow; None where they leave more than two."""
    merged = []
    for n, s in zip(blk.shape[1:], blk.stride()[1:]):
        if n == 1:
            continue
        if merged and merged[-1][1] == n * s:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    if not merged:
        return 1, 1, 0, 1
    if len(merged) == 1:
        return 1, merged[0][0], 0, merged[0][1]
    if len(merged) == 2:
        (rows, row_stride), (row_len, pixel_stride) = merged
        return rows, row_len, row_stride, pixel_stride
    return None


def launch_plan(blk: torch.Tensor, out: torch.Tensor) -> LaunchPlan:
    """The plan for the (C, ...) view blk (two rows' dims at most, see
    :func:`pixel_rows`) into the contiguous out; reads shapes, strides and
    addresses only, on any device.  The vector arm needs the groups of 4
    pixels inside one row (a single row, or rows a multiple of 4 long whose
    starts keep the alignment), each plane's words, or the interleaved
    pixels' words, on a 4-byte boundary, and out on a 16-byte one."""
    rows, row_len, row_stride, pixel_stride = pixel_rows(blk)
    C, eb, x = blk.shape[0], blk.element_size(), blk.data_ptr()
    channel_stride = blk.stride(0) if C > 1 else 0
    interleaved = C == 3 and pixel_stride == 3 and channel_stride == 1
    rows_ok = rows == 1 or (row_len % 4 == 0 and row_stride * eb % 4 == 0)
    if interleaved:
        words_ok = x % 4 == 0
    else:
        words_ok = pixel_stride == 1 and all((x + c * channel_stride * eb) % 4 == 0
                                             for c in range(C))
    vec = rows_ok and words_ok and out.data_ptr() % 16 == 0
    groups = ceildiv(rows * row_len, 4)
    blocks = max(1, min(FILL_BLOCKS, ceildiv(groups, THREADS * GROUPS_PER_THREAD)))
    return LaunchPlan(rows, row_len, row_stride, pixel_stride, channel_stride, interleaved,
                      vec, blocks)


def launch(blk: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """The kernel on the CUDA view blk (C, ...) with the (C, codes) tables."""
    if pixel_rows(blk) is None:
        blk = blk.contiguous()
    out = torch.empty(blk.shape[1:], dtype=torch.float32, device=blk.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(blk, out)
    fn = _lib.kernel_fn("luminance")
    with torch.cuda.device(blk.device):
        rc = fn(blk.data_ptr(), tabs.data_ptr(), out.data_ptr(), out.numel(), *plan[:5],
                blk.shape[0], blk.element_size(), int(plan.interleaved), int(plan.vec),
                plan.blocks, _lib.stream_ptr(blk))
    _lib.check(rc, "luminance")
    _lib.count_launch("luminance")
    return out
