"""The card's memory budget: how much of a card each stage of the port may take.

:func:`usable_bytes` is the port's one query of a card's memory; every other
function turns a share of it (or of the card's total) into a size, with its
own value off CUDA.  The one state is :func:`usable_bytes`'s last driver
reading of each card, kept for the life of the process: one entry per card,
replaced whole under a lock (a mesh's slots call these functions from their
threads) whenever that card's reserved bytes no longer equal the entry's."""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from fovvideovdp_tpu_torch.tracing import span

# share of the usable memory a streamed block or a chunk of independent
# frames may take
BLOCK_MEM_SHARE = 0.5
# Past this, a longer block only holds more memory: the fl-1 carried frames
# each block re-reads are already under a fifth of the temporal kernel's
# input at 30 fps (7 of 39 frames), and the per-block launches are ~25.
MAX_BLOCK_FRAMES = 32
# Independent frames (the images of a batch, the frames of the ablation,
# whole clips of a batch) carry nothing between chunks, so a chunk is capped
# by memory and by the launch plans alone: expand_contrast puts the frames
# on grid.z, which takes at most 65535.
MAX_CHUNK_FRAMES = 65535
# share of the usable memory a whole video's device heatmap may take
HEATMAP_MEM_SHARE = 0.5
# share of the usable memory the raw pair may take and stay resident
PRELOAD_SHARE = 0.25
# The (chunk, n, n) float32 intermediate of csf.reduce_lut_to_pixel_tables
# takes 4 n^2 bytes per pixel (4 KB at n = 32): a chunk may take an eighth
# of the usable memory, 64 MB on the CPU, between 1024 and 2^22 pixels.
PIXEL_TABLE_SHARE = 1 / 8
PIXEL_TABLE_CPU_BYTES = 64 << 20
PIXEL_CHUNK_MIN = 1024
PIXEL_CHUNK_MAX = 1 << 22
# share of the usable memory one chunk of a backward's recompute may take
# (ops/cuda/_autograd.py), and what it may take on the CPU
RECOMPUTE_MEM_SHARE = 0.5
CPU_RECOMPUTE_BYTES = 1 << 30
# Fixed-gaze table sets a core keeps: as many as fit a quarter of the card's
# total memory, between 1 and 8 (one 4K set is 1.68 GB, so an 80 GB card
# keeps 8; block sizing reads the usable memory after they are built).  On
# the CPU, 2.
FOV_CACHE_SHARE = 0.25
FOV_CACHE_MAX = 8
FOV_CACHE_CPU = 2


# card index: (usable, reserved, allocated), the last driver reading of the
# card and the allocator's two counters it was taken at
_readings: Dict[int, Tuple[int, int, int]] = {}
_readings_lock = threading.Lock()


def usable_bytes(device) -> Optional[int]:
    """The driver's free bytes of ``device``'s card plus what the caching
    allocator holds but no tensor uses, which it hands out before it asks
    the driver; None off CUDA.

    The driver is queried (one ``fvvdp.mem_query`` span) when the card has
    no kept reading or when the allocator's reserved bytes differ from the
    reading's: it then took memory from the driver or gave some back (a new
    segment, ``empty_cache``, the release before an out-of-memory retry).
    While they are equal, nothing this process allocates through the
    allocator moves the driver's free bytes, so the kept reading less what
    the allocator handed out since is what a query would return (one empty
    ``fvvdp.mem_reuse`` span, no driver call).  Memory that something
    outside this process's caching allocator takes or gives back on the card
    meanwhile (another process, a library's own ``cudaMalloc``) shows only at
    the next query, as it showed in a single query only up to the moment it
    was made."""
    if device.type != "cuda":
        return None
    card = torch.cuda.current_device() if device.index is None else device.index
    kept = _readings.get(card)
    if kept is not None and torch.cuda.memory_reserved(device) == kept[1]:
        with span("fvvdp.mem_reuse"):
            pass
        return kept[0] - (torch.cuda.memory_allocated(device) - kept[2])
    with span("fvvdp.mem_query"):
        free = torch.cuda.mem_get_info(device)[0]
    reserved = torch.cuda.memory_reserved(device)
    allocated = torch.cuda.memory_allocated(device)
    reading = (free + reserved - allocated, reserved, allocated)
    with _readings_lock:
        _readings[card] = reading
    return reading[0]


def block_size(h: int, w: int, n_frames: int, per_px: int, device, slots: int = 1,
               block_frames: Optional[int] = None) -> int:
    """Frames per streamed block at ``per_px`` bytes per pixel-frame: the
    user's ``block_frames``, else what ``BLOCK_MEM_SHARE`` of the usable
    memory, shared by ``slots`` slots, holds.  Call it after the fixed-gaze
    tables are built, so that the usable memory excludes them."""
    if block_frames is not None:
        return max(1, min(int(block_frames), n_frames))
    free = usable_bytes(device)
    if free is None:
        return min(MAX_BLOCK_FRAMES, n_frames)
    by_mem = int(BLOCK_MEM_SHARE * (free / slots) // (per_px * h * w))
    return max(1, min(by_mem, MAX_BLOCK_FRAMES, n_frames))


def mesh_block_size(h: int, w: int, n_frames: int, per_px: int, mesh,
                    block_frames: Optional[int] = None) -> int:
    """Frames per block of a stream split over a mesh's slots: the user's
    ``block_frames`` rounded up to a multiple of the slot count (as the JAX
    package rounds it, ``fovvideovdp_tpu/fvvdp.py:441-443``), else the
    smallest slot's :func:`block_size` times the slot count."""
    n = mesh.size
    if block_frames is not None:
        B = max(1, min(int(block_frames), n_frames))
        return -(-B // n) * n
    return n * min(block_size(h, w, n_frames, per_px, dev, mesh.slots_on(dev))
                   for dev in set(mesh.slots))


def chunk_items(h: int, w: int, n_items: int, item_frames: int, per_px: int, device,
                slots: int = 1, block_frames: Optional[int] = None) -> int:
    """Independent items per chunk: images, or whole clips whose padded
    windows hold ``item_frames`` frames; the frames ``block_frames`` or
    :func:`block_size`'s share hold, up to ``MAX_CHUNK_FRAMES``.  0 when one
    clip's window does not fit: each clip then streams.  Raises when not
    even one frame fits.  Call it after the fixed-gaze tables are built."""
    if block_frames is not None:
        frames = max(1, int(block_frames))
    elif (free := usable_bytes(device)) is None:
        frames = MAX_CHUNK_FRAMES
    else:
        free /= slots
        frames = int(BLOCK_MEM_SHARE * free // (per_px * h * w))
        if frames < 1:
            raise RuntimeError(
                f"one {w}x{h} frame pair needs {per_px * h * w / 2**30:.2f} GiB ({per_px} B "
                f"per pixel-frame), over half of the card's free memory ({free / 2**30:.2f} GiB)")
    return min(n_items, min(frames, MAX_CHUNK_FRAMES) // item_frames)


def heatmap_budget(device) -> Optional[int]:
    """Bytes a whole video's device heatmap may take; None (no limit) off CUDA."""
    free = usable_bytes(device)
    return None if free is None else int(HEATMAP_MEM_SHARE * free)


def check_heatmap_budget(device, n_frames: int, channels: int, h: int, w: int,
                         dtype: str) -> None:
    """Whole-video device heatmaps accumulate in device memory: refuse,
    before any scoring, a job that would exhaust it mid-video."""
    budget = heatmap_budget(device)
    est = n_frames * channels * h * w * (1 if dtype == "uint8" else 2)
    if budget is not None and est > budget:
        raise RuntimeError(
            f"device_heatmap=True would accumulate ~{est / 2**30:.1f} GiB of heatmap in "
            f"device memory ({n_frames} frames x {channels} x {h}x{w} {dtype}), over half "
            f"of the card's free memory ({budget / 2**30:.1f} GiB). Use device_heatmap=False "
            f"to copy heatmap frames to the host block by block instead")


def preload_limit(device, override: Optional[int] = None) -> float:
    """Bytes of raw frames above which they stay on the host: ``override``
    when set, else ``PRELOAD_SHARE`` of the usable memory (no limit off
    CUDA)."""
    if override is not None:
        return override
    free = usable_bytes(device)
    return float("inf") if free is None else PRELOAD_SHARE * free


def pixel_table_chunk(n: int, device) -> int:
    """Pixels per chunk of ``csf.reduce_lut_to_pixel_tables`` on a LUT of
    ``n`` luminance knots (see ``PIXEL_TABLE_SHARE``)."""
    per_px = 4 * n * n + 16 * n
    free = usable_bytes(device)
    budget = PIXEL_TABLE_CPU_BYTES if free is None else int(PIXEL_TABLE_SHARE * free)
    return int(max(PIXEL_CHUNK_MIN, min(budget // per_px, PIXEL_CHUNK_MAX)))


def recompute_budget(device) -> float:
    """Bytes one chunk of a backward's recompute may take on ``device``."""
    free = usable_bytes(device)
    return CPU_RECOMPUTE_BYTES if free is None else RECOMPUTE_MEM_SHARE * free


def fov_cache_entries(device, table_bytes: int) -> int:
    """Fixed-gaze table sets of ``table_bytes`` each that a core on
    ``device`` keeps (see ``FOV_CACHE_SHARE``)."""
    if device.type != "cuda":
        return FOV_CACHE_CPU
    total = torch.cuda.get_device_properties(device).total_memory
    fit = int(FOV_CACHE_SHARE * total // max(table_bytes, 1))
    return max(1, min(FOV_CACHE_MAX, fit))
