"""Video/image sources: test and reference frames as absolute-luminance
blocks on the device.

Counterpart of ``fovvideovdp_tpu/video_source.py:29-72,74-83,106-230,
266-518``.  The base class takes the reference's per-frame API
(``get_test_frame``/``get_reference_frame``) and builds blocks from it; the
array source overrides the block methods.  :class:`PairBatch` holds the N
pairs of a batch (``fvvdp.predict_batch``) and converts a chunk of pairs at
a time.  It keeps the raw (C, F, H, W)
pair on the device while it fits a share of the card's free memory, uploaded
in chunks through pinned staging buffers; above that the pair stays on the
host and each block's raw frames go up when the block is needed, on a side
stream, the next block's copy overlapping this block's scoring
(:class:`_HostBlocks`, which the file sources share).  Either way the
decode, the EOTF and RGB -> Y run on the device.  The packed-array source
converts one frame at a time through the per-frame methods.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from fovvideovdp_tpu_torch import utils
from fovvideovdp_tpu_torch.display_model import fvvdp_display_photometry


def reshuffle_dims(arr: torch.Tensor, in_dims: str, out_dims: str) -> torch.Tensor:
    """Permute/insert singleton dims, e.g. "HWC" -> "BCFHW"."""
    in_dims = in_dims.upper()
    out_dims = out_dims.upper()

    inter_dims = "".join(d for d in out_dims if d in in_dims)
    for d in in_dims:
        if d not in out_dims:
            raise RuntimeError(
                f'Dimension "{d}" missing in the target dimensions: "{out_dims}"')

    perm = [in_dims.find(d) for d in inter_dims]
    arr_p = arr.permute(perm) if perm else arr

    out_sh = []
    k = 0
    for d in out_dims:
        if d in inter_dims:
            out_sh.append(arr_p.shape[k])
            k += 1
        else:
            out_sh.append(1)
    return arr_p.reshape(out_sh)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    passes ``device="cpu"``.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fovvideovdp_tpu_torch runs on a CUDA card by default and none "
            "is available; pass device=\"cpu\" to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev


def _decode_raw(x: torch.Tensor) -> torch.Tensor:
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


def rgb_to_y(color_space_name: str) -> Tuple[float, float, float]:
    """The colour space's RGB -> Y weights (``color_spaces.json``)."""
    colorspaces = utils.json2dict(utils.config_files.find("color_spaces.json"))
    if color_space_name not in colorspaces:
        raise RuntimeError(f'Unknown color space: "{color_space_name}"')
    return tuple(float(c) for c in colorspaces[color_space_name]["RGB2Y"])


def _luminance_cfirst(blk: torch.Tensor, dm, rgb2y) -> torch.Tensor:
    """(C, n, ...) raw frames -> (n, ...) absolute luminance."""
    if blk.shape[0] == 3:
        return channels_to_luminance(lambda c: _decode_raw(blk[c]), dm, rgb2y)
    return dm.forward(_decode_raw(blk[0]))


# pixels of one conversion chunk of a file source: the decode's float32
# temporaries (a few tens of bytes a pixel) are live for this many at once
CONVERT_CHUNK_PIXELS = 1 << 25


def convert_frames(n: int, out_hw, pixels_per_frame: int, device,
                   fn: Callable[[int, int], torch.Tensor]) -> torch.Tensor:
    """(n, H, W) float32 luminance whose frames i..j-1 are ``fn(i, j)``,
    computed a chunk of whole frames at a time, so that the decode's
    temporaries stay bounded whatever the block size."""
    out = torch.empty((n,) + tuple(out_hw), dtype=torch.float32, device=device)
    step = max(1, CONVERT_CHUNK_PIXELS // max(1, pixels_per_frame))
    for i in range(0, n, step):
        j = min(n, i + step)
        out[i:j] = fn(i, j)
    return out


def is_run(idx: np.ndarray) -> bool:
    """Whether the frame indices are consecutive and increasing."""
    return len(idx) > 0 and bool(np.all(np.diff(idx) == 1))


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor of its stored bytes (uint16 as int16); a
    read-only array (a memory map) is copied first."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags["WRITEABLE"]:
        arr = arr.copy()
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return torch.from_numpy(arr)


class fvvdp_video_source(ABC):
    """Abstract source of test/reference frames in absolute cd/m^2.

    A subclass implements the per-frame methods (the reference's API); the
    block methods concatenate them unless a subclass overrides them with a
    batched conversion."""

    # the staging and prefetch of a source whose raw frames stay off the card
    _blocks: Optional["_HostBlocks"] = None
    # luminance_at(indices, device): the frames at indices converted on any
    # device, safe from several threads at once (the slots of a mesh); None
    # where the source reads its blocks in order on its own device
    luminance_at: Optional[Callable] = None

    @abstractmethod
    def get_video_size(self) -> Tuple[int, int, int]:
        """(height, width, n_frames)"""

    @abstractmethod
    def get_frames_per_second(self) -> float:
        ...

    @abstractmethod
    def get_test_frame(self, frame: int, device=None) -> torch.Tensor:
        """Single frame as (1, 1, 1, H, W) float32 absolute luminance."""

    @abstractmethod
    def get_reference_frame(self, frame: int, device=None) -> torch.Tensor:
        ...

    def supports_random_access(self) -> bool:
        """Whether frames can be fetched at arbitrary positions; circular
        and pingpong padding need it.  A streaming source returns False."""
        return True

    def host_block_bytes(self, count: int) -> int:
        """Bytes of ``count`` frames' raw pair that the source stages in each
        of its two pinned buffers and keeps on the device for its prefetched
        next block; 0 when its frames are on the device or come one at a
        time through the per-frame methods."""
        return 0 if self._blocks is None else self._blocks.nbytes(count)

    def get_luminance_block(self, start: int, count: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(test, reference) luminance blocks of shape (count, H, W)."""
        return self.get_indexed_luminance_block(np.arange(start, start + count))

    def get_indexed_luminance_block(self, indices: np.ndarray
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Like get_luminance_block for an arbitrary frame index list
        (the circular/pingpong temporal warm-up)."""
        if len(indices) == 0:
            H, W, _ = self.get_video_size()
            empty = torch.zeros((0, H, W), dtype=torch.float32)
            return empty, empty
        return (torch.cat([self.get_test_frame(int(i))[0, 0] for i in indices]),
                torch.cat([self.get_reference_frame(int(i))[0, 0] for i in indices]))


class fvvdp_video_source_dm(fvvdp_video_source):
    """Source that applies a photometric display model + RGB->Y conversion."""

    def __init__(self, display_photometry="sdr_4k_30", color_space_name="sRGB"):
        self.color_to_luminance = rgb_to_y(color_space_name)

        if isinstance(display_photometry, str):
            self.dm_photometry = fvvdp_display_photometry.load(display_photometry)
        elif isinstance(display_photometry, fvvdp_display_photometry):
            self.dm_photometry = display_photometry
        else:
            raise RuntimeError(
                "display_photometry must be a string or fvvdp_display_photometry subclass")


# types that go to the device as they are stored (uint16 travels as int16);
# others become float32 on the host
_STORED_TYPES = (torch.uint8, torch.int16, torch.float16, torch.float32)
# the resident upload's chunk: large enough that a chunk's launch and event
# cost nothing beside its copy, small enough that two chunks' host copies
# overlap the transfer from the first chunk on
UPLOAD_CHUNK_BYTES = 32 << 20
# share of the card's free memory the raw pair may take and stay resident
DEVICE_PRELOAD_SHARE = 0.25


def _as_stored(raw) -> torch.Tensor:
    """Array or tensor -> tensor in the type it goes to the device in."""
    if isinstance(raw, torch.Tensor):
        t = raw
    else:
        t = torch.from_numpy(np.ascontiguousarray(raw))
    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    elif t.dtype not in _STORED_TYPES:
        t = t.to(torch.float32)
    return t


def _staged_copy(dst: torch.Tensor, src: torch.Tensor,
                 chunk_bytes: int = UPLOAD_CHUNK_BYTES) -> None:
    """Contiguous host src -> contiguous CUDA dst of the same type and size,
    in chunks through two pinned staging buffers on a side stream: the host
    copy of chunk k+1 into one buffer overlaps the transfer of chunk k from
    the other.  The host waits for a buffer's last transfer before it writes
    the buffer again.  The current stream waits for the side stream, so
    whatever is queued on it after this call sees the whole of dst."""
    src_f, dst_f = src.reshape(-1), dst.view(-1)
    n = src_f.numel()
    chunk = max(1, chunk_bytes // src.element_size())
    side = torch.cuda.Stream(dst.device)
    compute = torch.cuda.current_stream(dst.device)
    side.wait_stream(compute)          # dst may be memory the compute stream just freed
    staging = [torch.empty(min(chunk, n), dtype=src.dtype, pin_memory=True)
               for _ in range(2 if n > chunk else 1)]
    done = [None] * len(staging)
    for k, off in enumerate(range(0, n, chunk)):
        m = min(chunk, n - off)
        s = k % len(staging)
        if done[s] is not None:
            done[s].synchronize()
        staging[s][:m].copy_(src_f[off:off + m])
        with torch.cuda.stream(side):
            dst_f[off:off + m].copy_(staging[s][:m], non_blocking=True)
        done[s] = side.record_event()
    compute.wait_stream(side)
    dst.record_stream(side)


def _upload_bcfhw(raw, dim_order: str, device: torch.device) -> torch.Tensor:
    """Raw array or tensor in any dim order -> contiguous (B, C, F, H, W) on
    the device.  The bytes go up as stored (:func:`_staged_copy` from the
    host) and the dim shuffle runs on the device."""
    t = _as_stored(raw)
    if t.device.type == "cpu" and device.type == "cuda":
        up = torch.empty(t.shape, dtype=t.dtype, device=device)
        _staged_copy(up, t.contiguous())
        t = up
    else:
        t = t.to(device)
    return reshuffle_dims(t, dim_order, "BCFHW").contiguous()


def _upload_cfhw(raw, dim_order: str, device: torch.device) -> torch.Tensor:
    """The same for one pair: contiguous (C, F, H, W) on the device."""
    return _upload_bcfhw(raw, dim_order, device)[0]


class _HostBlocks:
    """Raw frames kept off the card (host tensors, a file, a pipe) and sent
    up a block at a time.  ``fill(indices, buf)`` writes the test and
    reference frames at ``indices`` into ``buf``, a flat uint8 slice of one
    of two pinned staging buffers, ``nbytes(n)`` long; the transfer runs on
    a side stream, and the compute stream waits on its event before it reads
    the block.  :meth:`prefetch` starts the next block's read and transfer,
    so that the transfer overlaps the scoring of this one."""

    def __init__(self, fill: Callable[[np.ndarray, torch.Tensor], None],
                 nbytes: Callable[[int], int], device: torch.device):
        self._fill = fill
        self.nbytes = nbytes
        self.device = device
        self._side = torch.cuda.Stream(device)
        self._staging = [None, None]     # pinned flat uint8 buffers, grown on demand
        self._done = [None, None]        # the transfer that last read each buffer
        self._slot = 0
        self._pending = None             # ((start, count), staged block)

    def _stage(self, idx: np.ndarray):
        """Frames at idx -> (flat uint8 device block, the event of its
        transfer on the side stream)."""
        n = self.nbytes(len(idx))
        s = self._slot
        self._slot ^= 1
        if self._done[s] is not None:
            self._done[s].synchronize()  # its last transfer has read it
        if self._staging[s] is None or self._staging[s].numel() < n:
            self._staging[s] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        stg = self._staging[s][:n]
        self._fill(idx, stg)
        dev = torch.empty(n, dtype=torch.uint8, device=self.device)
        # dev may reuse memory that work queued on the compute stream still reads
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            dev.copy_(stg, non_blocking=True)
        self._done[s] = self._side.record_event()
        dev.record_stream(self._side)    # freed unread, it still waits for its transfer
        return dev, self._done[s]

    def _ready(self, staged) -> torch.Tensor:
        """The compute stream waits for the block's transfer before it reads it."""
        dev, event = staged
        torch.cuda.current_stream(self.device).wait_event(event)
        return dev

    def block(self, start: int, count: int) -> torch.Tensor:
        """Frames start..start+count-1 as a flat uint8 device block, from
        the prefetch when it is that block."""
        pending, self._pending = self._pending, None
        if pending is not None and pending[0] == (start, count):
            return self._ready(pending[1])
        return self._ready(self._stage(np.arange(start, start + count)))

    def indexed(self, idx: np.ndarray) -> torch.Tensor:
        return self._ready(self._stage(np.asarray(idx, dtype=np.int64)))

    def prefetch(self, start: int, count: int) -> None:
        self._pending = ((start, count), self._stage(np.arange(start, start + count)))


class fvvdp_video_source_array(fvvdp_video_source_dm):
    """Frames from numpy arrays (or tensors), any dim order,
    uint8/uint16/int16/float.  The raw pair is held on ``device`` while it
    takes at most ``DEVICE_PRELOAD_LIMIT_BYTES``, else on the host."""

    # bytes of the raw pair above which it stays on the host; None: a quarter
    # of the card's free memory (no limit on the CPU)
    DEVICE_PRELOAD_LIMIT_BYTES: Optional[int] = None

    def __init__(self, test_video, reference_video, fps, dim_order="BCFHW",
                 display_photometry="sdr_4k_30", color_space_name="sRGB",
                 device="cuda"):
        super().__init__(display_photometry=display_photometry,
                         color_space_name=color_space_name)
        if not isinstance(test_video, torch.Tensor):
            test_video = np.asarray(test_video)
            reference_video = np.asarray(reference_video)
        if tuple(test_video.shape) != tuple(reference_video.shape):
            raise RuntimeError(
                "Test and reference image/video tensors must be exactly the same shape")
        if len(dim_order) != test_video.ndim:
            raise RuntimeError(
                'Input tensor must have exactly as many dimensions as there are '
                'characters in the "dims" parameter')

        dim_sizes = dict(zip(dim_order.upper(), test_video.shape))
        B, C, F = (dim_sizes.get(d, 1) for d in "BCF")
        H, W = dim_sizes["H"], dim_sizes["W"]
        if B != 1:
            raise RuntimeError(
                f"fvvdp_video_source_array expects batch size 1, got B={B}; "
                "loop over batch items")
        if fps == 0 and F > 1:
            raise RuntimeError(
                "When passing video sequences, you must set 'frames_per_second' parameter")
        if C not in (1, 3):
            raise RuntimeError("The content must have either 1 or 3 colour channels.")

        self.fps = fps
        self.is_video = fps > 0
        self.is_color = C == 3
        self._size = (H, W, F)
        self.device = resolve_device(device)
        on_card = isinstance(test_video, torch.Tensor) and test_video.device.type == "cuda"
        t, r = _as_stored(test_video), _as_stored(reference_video)
        self.resident = on_card or \
            2 * t.numel() * t.element_size() <= self._preload_limit()
        self._blocks = None
        if self.resident:
            self._t = _upload_cfhw(t, dim_order, self.device)
            self._r = _upload_cfhw(r, dim_order, self.device)
        else:
            # one contiguous host (C, F, H, W) copy of each (a byte-strided
            # transpose for frames-last input); a block is then a slice
            self._t = reshuffle_dims(t, dim_order, "BCFHW")[0].contiguous()
            self._r = reshuffle_dims(r, dim_order, "BCFHW")[0].contiguous()
            if self.device.type == "cuda":
                self._blocks = _HostBlocks(self._fill, self._pair_bytes, self.device)

    def _preload_limit(self) -> float:
        return self.preload_limit(self.device)

    @classmethod
    def preload_limit(cls, device: torch.device) -> float:
        """Bytes of raw frames above which they stay on the host."""
        if cls.DEVICE_PRELOAD_LIMIT_BYTES is not None:
            return cls.DEVICE_PRELOAD_LIMIT_BYTES
        if device.type != "cuda":
            return float("inf")
        return DEVICE_PRELOAD_SHARE * torch.cuda.mem_get_info(device)[0]

    def get_frames_per_second(self):
        return self.fps

    def get_video_size(self):
        return self._size

    def _lum(self, blk: torch.Tensor) -> torch.Tensor:
        return _luminance_cfirst(blk, self.dm_photometry, self.color_to_luminance)

    def _pair_bytes(self, n: int) -> int:
        C, _, H, W = self._t.shape
        return 2 * C * n * H * W * self._t.element_size()

    def _pair(self, flat: torch.Tensor, n: int) -> torch.Tensor:
        """A flat uint8 block -> the (2, C, n, H, W) pair in its stored type."""
        C, _, H, W = self._t.shape
        return flat.view(self._t.dtype).view(2, C, n, H, W)

    def _fill(self, idx: np.ndarray, buf: torch.Tensor) -> None:
        pair = self._pair(buf, len(idx))
        if is_run(idx):
            sl = slice(int(idx[0]), int(idx[-1]) + 1)
            pair[0].copy_(self._t[:, sl])
            pair[1].copy_(self._r[:, sl])
        else:
            i = torch.from_numpy(idx)
            pair[0].copy_(self._t.index_select(1, i))
            pair[1].copy_(self._r.index_select(1, i))

    def _raw(self, start: int, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw (C, count, H, W) test and reference frames on the device."""
        if self._blocks is None:
            sl = slice(start, start + count)
            return self._t[:, sl], self._r[:, sl]
        pair = self._pair(self._blocks.block(start, count), count)
        return pair[0], pair[1]

    def get_luminance_block(self, start, count):
        t, r = self._raw(start, count)
        out = self._lum(t), self._lum(r)
        del t, r
        nxt = start + count
        if self._blocks is not None and nxt < self._size[2]:
            self._blocks.prefetch(nxt, min(count, self._size[2] - nxt))
        return out

    def get_indexed_luminance_block(self, indices):
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64))
        if self._blocks is not None:
            pair = self._pair(self._blocks.indexed(idx.numpy()), len(idx))
            return self._lum(pair[0]), self._lum(pair[1])
        idx = idx.to(self._t.device)
        return (self._lum(self._t.index_select(1, idx)),
                self._lum(self._r.index_select(1, idx)))

    def get_test_frame(self, frame, device=None):
        return self._lum(self._raw(frame, 1)[0])[None, None]

    def get_reference_frame(self, frame, device=None):
        return self._lum(self._raw(frame, 1)[1])[None, None]

    def luminance_at(self, indices, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(test, reference) luminance of the frames at ``indices``, their
        raw frames copied to ``device`` and converted there.  It reads the
        raw pair and changes nothing (the host-resident staging is not
        used), so the slots of a mesh call it from their threads at once,
        each converting its own frames on its own card."""
        idx = np.asarray(indices, dtype=np.int64)
        out = []
        for x in (self._t, self._r):
            if is_run(idx):
                raw = x[:, int(idx[0]):int(idx[-1]) + 1]
            else:
                raw = x.index_select(1, torch.as_tensor(idx, device=x.device))
            out.append(self._lum(raw.to(device)))
        return out[0], out[1]


class fvvdp_video_source_packed_array(fvvdp_video_source_dm):
    """Flat-packed YUV or RGB frames behind a 7-int header, for batch and
    IPC use (``fovvideovdp_tpu/video_source.py:446-518``).

    Header: [n_frames, h, w, bit_depth, chroma_ss, resize_h, resize_w].
    Frames are converted one at a time on ``device`` through the per-frame
    methods (the base class builds blocks from them).  As in the JAX
    package, :meth:`get_video_size` gives the resize target, not the stored
    size, and the BT.2020 matrix is chosen by ``color_space_name ==
    "bt2020nc"``."""

    def __init__(self, test_video, reference_video, fps,
                 display_photometry="sdr_4k_30", color_space_name="sRGB",
                 yuv=True, resize_mode="bilinear", device="cuda"):
        super().__init__(display_photometry, color_space_name)
        self.fps = fps
        self.is_video = fps > 0
        self.test_video = np.asarray(test_video)
        self.reference_video = np.asarray(reference_video)
        self.yuv = yuv
        self.color_space = color_space_name
        self.resize_mode = resize_mode
        self.device = resolve_device(device)

    def get_frames_per_second(self):
        return self.fps

    def get_video_size(self):
        n, h, w = map(int, (self.test_video[0], self.test_video[5], self.test_video[6]))
        return h, w, n

    def get_test_frame(self, frame, device=None):
        return self._get_frame(self.test_video, frame)

    def get_reference_frame(self, frame, device=None):
        return self._get_frame(self.reference_video, frame)

    def _get_frame(self, from_array: np.ndarray, idx: int) -> torch.Tensor:
        from fovvideovdp_tpu_torch.io import resize
        from fovvideovdp_tpu_torch.io import yuv as yuv_io

        n, h, w, bit_depth, chroma_ss, resize_h, resize_w = map(int, from_array[:7])
        up = lambda a: host_tensor(a).to(self.device)  # noqa: E731
        if self.yuv:
            y_pixels = h * w
            uv_shape = (h // 2, w // 2) if str(chroma_ss) == "420" else (h, w)
            uv_pixels = uv_shape[0] * uv_shape[1]
            fp = y_pixels + 2 * uv_pixels
            base = 7 + idx * fp
            Y = up(from_array[base: base + y_pixels].reshape(h, w))
            u = up(from_array[base + y_pixels: base + y_pixels + uv_pixels].reshape(uv_shape))
            v = up(from_array[base + y_pixels + uv_pixels: base + fp].reshape(uv_shape))
            RGB = torch.clamp(yuv_io.yuv_to_rgb(Y, u, v, bit_depth, str(chroma_ss),
                                                bt2020=(self.color_space == "bt2020nc")),
                              0.0, 1.0).permute(2, 0, 1)
            if (resize_h != h) or (resize_w != w):
                RGB = resize(RGB, (resize_h, resize_w), self.resize_mode)
        else:
            fp = resize_h * resize_w * 3
            raw = from_array[7 + idx * fp: 7 + (idx + 1) * fp].reshape(resize_h, resize_w, 3)
            # packed RGB is full-range in its container type (the header's
            # bit_depth applies to the YUV layout only)
            max_value = 255.0 if from_array.dtype == np.uint8 else 65535.0
            RGB = (up(raw.astype(np.float32)) / max_value).permute(2, 0, 1)
        L = channels_to_luminance(lambda c: RGB[c], self.dm_photometry,
                                  self.color_to_luminance)
        return L[None, None, None]      # (1, 1, 1, H, W)


class PairBatch:
    """N test/reference pairs from arrays or tensors with a batch axis, as
    luminance on the device a chunk of pairs at a time: the counterpart of
    ``_batch_to_luminance`` (``fovvideovdp_tpu/video_source.py:93-103``),
    which converts the whole batch at once.

    A batch on the host goes to the device whole when the pair takes at most
    the array source's residency limit
    (:meth:`fvvdp_video_source_array.preload_limit`); else it stays on the
    host and each chunk goes up when it is asked for, through the staged
    pinned copy.  A batch on the card is read where it is.  The checks and
    their words are ``fvvdp.predict_batch``'s in the JAX package.
    ``encode``, where given, maps each chunk's luminance to what the metric
    scores (log10 luminance under log contrast)."""

    def __init__(self, test, reference, dim_order: str, fps, dm, rgb2y, device,
                 encode=None):
        t, r = _as_stored(test), _as_stored(reference)
        dims = dim_order.upper()
        self.shape = self.batch_shape(t, r, dims, fps)
        self.fps = fps
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" is the current card, the device its tensors report
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._dm, self._rgb2y = dm, rgb2y
        self._encode = encode or (lambda L: L)
        self._dims = dims
        if t.device.type == "cpu" and \
                2 * t.numel() * t.element_size() <= fvvdp_video_source_array.preload_limit(
                    self.device):
            t, r = _upload_bcfhw(t, dims, self.device), _upload_bcfhw(r, dims, self.device)
            self._dims = "BCFHW"
        self._t, self._r = t, r

    @staticmethod
    def batch_shape(test, reference, dim_order: str, fps) -> Tuple[int, ...]:
        """(N, C, F, H, W) of a batch, checked as ``predict_batch`` checks it."""
        shape, shape_r = (tuple(reshuffle_dims(torch.empty(tuple(np.shape(x)), device="meta"),
                                               dim_order, "BCFHW").shape)
                          for x in (test, reference))
        if shape != shape_r:
            raise RuntimeError("Test and reference batches must have the same shape")
        N, C, F, H, W = shape
        if F > 1 and fps <= 0:
            raise RuntimeError(
                "When passing video sequences, you must set 'frames_per_second' parameter")
        if C not in (1, 3):
            raise RuntimeError("The content must have either 1 or 3 colour channels.")
        return shape

    @staticmethod
    def rows(x, dim_order: str, start: int, stop: int):
        """Pairs start..stop-1 of a batch (array or tensor) in its own dim
        order, a view where the input allows one."""
        ax = dim_order.upper().index("B")
        if isinstance(x, torch.Tensor):
            return x.narrow(ax, start, stop - start)
        return np.asarray(x)[(slice(None),) * ax + (slice(start, stop),)]

    def _raw(self, x: torch.Tensor, start: int, count: int, frames) -> torch.Tensor:
        """Raw pairs start..start+count-1 of x, at ``frames``, as (count, C,
        n, H, W) on the device.  The selection is made in x's own dim
        order, so that a host chunk goes up as its stored bytes."""
        x = x.narrow(self._dims.index("B"), start, count)
        if frames is not None and "F" in self._dims:
            f = self._dims.index("F")
            if isinstance(frames, slice):
                x = x.narrow(f, frames.start, frames.stop - frames.start)
            else:
                x = x.index_select(f, torch.as_tensor(np.asarray(frames, dtype=np.int64),
                                                      device=x.device))
        if x.device != self.device:
            return _upload_bcfhw(x, self._dims, self.device)
        return reshuffle_dims(x, self._dims, "BCFHW")

    def luminance(self, start: int, count: int,
                  frames: Union[None, slice, np.ndarray] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(count, n, H, W) float32 test and reference luminance of pairs
        start..start+count-1 on the device: all F frames, or those at
        ``frames`` (a slice, or an index array for the temporal padding)."""
        return tuple(
            self._encode(_luminance_cfirst(self._raw(x, start, count, frames).transpose(0, 1),
                                           self._dm, self._rgb2y))
            for x in (self._t, self._r))
