"""ctypes bindings to the native host-I/O runtime (``fvvdp_io.cpp``).

Counterpart of ``fovvideovdp_tpu/native/__init__.py:24-168``.  The library
is built with ``g++`` at first use (never at import) into
``fovvideovdp_tpu_torch/_build/``, under a name carrying a hash of the
source, the flags and the machine, so an edited source is rebuilt and an
unchanged one reused; the build writes a temporary name and renames it, so
processes building at once never load a half-written library.  A missing
``g++`` or a failed build raises: the readers here have no silent fallback,
and the sources use a pure-Python reader only when the caller asks for it.

``read_block`` writes into a caller-given buffer when ``out`` is passed (a
pinned staging tensor, for instance), so a block needs no further host copy
on its way to the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "fvvdp_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _tag() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(platform.machine().encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile ``fvvdp_io.cpp`` unless this hash of it is already built;
    returns the library's path.  Raises when g++ is missing or fails."""
    path = os.path.join(BUILD_DIR, f"libfvvdp_io-{_tag()}.so")
    if os.path.isfile(path):
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the native I/O reader of fovvideovdp_tpu_torch "
            "(native/fvvdp_io.cpp) is compiled at first use and needs a C++ "
            "compiler; pass reader=\"python\" to a file source to read without it")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        res = subprocess.run([gxx, *CXX_FLAGS, "-o", tmp, SRC, "-lpthread"],
                             capture_output=True, timeout=240)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError("building native/fvvdp_io.cpp with g++ timed out") from e
    if res.returncode != 0:
        raise RuntimeError(f"building native/fvvdp_io.cpp with g++ failed (exit "
                           f"{res.returncode}):\n{res.stderr.decode(errors='replace')[-2000:]}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The native library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.fvvdp_yuv_open.restype = ctypes.c_void_p
        lib.fvvdp_yuv_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
        lib.fvvdp_yuv_frame_count.restype = ctypes.c_long
        lib.fvvdp_yuv_frame_count.argtypes = [ctypes.c_void_p]
        lib.fvvdp_yuv_read_block.restype = ctypes.c_long
        lib.fvvdp_yuv_read_block.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p]
        lib.fvvdp_yuv_read_indices.restype = ctypes.c_long
        lib.fvvdp_yuv_read_indices.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.c_void_p]
        lib.fvvdp_yuv_close.restype = None
        lib.fvvdp_yuv_close.argtypes = [ctypes.c_void_p]
        lib.fvvdp_pipe_open.restype = ctypes.c_void_p
        lib.fvvdp_pipe_open.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_long]
        lib.fvvdp_pipe_read_block.restype = ctypes.c_long
        lib.fvvdp_pipe_read_block.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        lib.fvvdp_pipe_close.restype = None
        lib.fvvdp_pipe_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def buffer_address(out, nbytes: int) -> int:
    """Address of a contiguous host buffer (a CPU tensor or a numpy array)
    that holds at least ``nbytes``."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("out must be a contiguous tensor in host memory")
        have, ptr = out.numel() * out.element_size(), out.data_ptr()
    elif isinstance(out, np.ndarray):
        if not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]:
            raise ValueError("out must be a contiguous, writeable array")
        have, ptr = out.nbytes, out.ctypes.data
    else:
        raise TypeError(f"out must be a torch.Tensor or numpy array, got {type(out)}")
    if have < nbytes:
        raise ValueError(f"out holds {have} bytes, {nbytes} are needed")
    return ptr


class NativePipeReader:
    """Prefetching drain for a rawvideo pipe (ffmpeg stdout): a background
    thread reads frames into a ring of host buffers so the decoder keeps
    working ahead of the consumer.

    The caller keeps ownership of the fd and of the producing process, and
    must end the producer BEFORE calling :meth:`close`: EOF is what unblocks
    the worker thread if it is mid-read."""

    def __init__(self, fd: int, frame_bytes: int, ring_frames: int = 4):
        self._lib = load()
        self.frame_bytes = int(frame_bytes)
        self._h = self._lib.fvvdp_pipe_open(int(fd), self.frame_bytes, int(ring_frames))
        if not self._h:
            raise RuntimeError("cannot start the native pipe reader")

    def read_block(self, count: int, dtype=None, out=None):
        """Read up to ``count`` frames (fewer only at the end of the stream,
        none at EOF).  Without ``out``: a (n, frame_bytes / itemsize) array.
        With ``out`` (a host buffer of at least count frames): the frames are
        written there and n is returned."""
        if out is None:
            dtype = np.dtype(dtype or np.uint8)
            arr = np.empty((count, self.frame_bytes // dtype.itemsize), dtype=dtype)
            n = self._lib.fvvdp_pipe_read_block(self._h, count, arr.ctypes.data)
            return arr[:n]
        ptr = buffer_address(out, count * self.frame_bytes)
        return int(self._lib.fvvdp_pipe_read_block(self._h, count, ptr))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fvvdp_pipe_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeYuvReader:
    """Prefetching raw-YUV reader."""

    def __init__(self, path: str, width: int, height: int, bit_depth: int,
                 chroma_ss: str, ring_size: int = 4):
        self._lib = load()
        self._h = self._lib.fvvdp_yuv_open(path.encode(), width, height, bit_depth,
                                           int(chroma_ss), ring_size)
        if not self._h:
            raise RuntimeError(f"cannot open {path}")
        self.frame_count = int(self._lib.fvvdp_yuv_frame_count(self._h))
        self.dtype = np.dtype(np.uint16 if bit_depth > 8 else np.uint8)
        y = width * height
        uv = y // 4 if chroma_ss == "420" else y
        self.frame_samples = y + 2 * uv
        self.frame_bytes = self.frame_samples * self.dtype.itemsize

    def _target(self, count: int, out):
        if out is None:
            arr = np.empty((count, self.frame_samples), dtype=self.dtype)
            return arr, arr.ctypes.data
        return out, buffer_address(out, count * self.frame_bytes)

    def read_block(self, start: int, count: int, out=None):
        """Frames start..start+count-1 as a (count, frame_samples) array, or
        written into ``out`` (a host buffer), which is then returned."""
        if start < 0 or count < 0:
            raise ValueError(f"bad frame range start={start} count={count}")
        dst, ptr = self._target(count, out)
        n = self._lib.fvvdp_yuv_read_block(self._h, start, count, ptr)
        if n != count:
            raise RuntimeError(f"short read: {n}/{count} frames at {start}")
        return dst

    def read_indices(self, indices, out=None):
        """The frames at ``indices``, in that order, as :meth:`read_block`."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        dst, ptr = self._target(len(idx), out)
        n = self._lib.fvvdp_yuv_read_indices(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(idx), ptr)
        if n != len(idx):
            raise RuntimeError(f"short read: {n}/{len(idx)} frames")
        return dst

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fvvdp_yuv_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
