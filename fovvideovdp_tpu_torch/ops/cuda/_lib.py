"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<stem>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (``extern "C"``), loaded with ``ctypes``.  Builds
happen at first use, never at import: all sources are compiled in parallel
(one ``nvcc`` each) into ``fovvideovdp_tpu_torch/_build/``, under a name
carrying a hash of ``csrc/*``, so an edited source is rebuilt and an
unchanged one is reused.  ``nvcc`` runs with ``-Xptxas -v``; what it prints
(registers, shared memory and spills of every kernel) is kept beside each
library (:func:`build_log`).  A missing ``nvcc``, a failed build or a
non-zero return from a kernel's C function raises; nothing falls back.

Every wrapper adds one to its launch counter when it launches its kernel
(and nowhere else), so a run can show that it went through the kernels.
The counters are shared by every thread and guarded by a lock: the slots
of a mesh (``parallel.sharding.Mesh``) launch from threads of their own.
A launch made under :func:`launch_scope` is also counted under that
scope's key, so a mesh run can show each slot's launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("gausspyr_reduce", "expand_score2", "temporal_pair", "expand_contrast",
           "band_score", "band_score2", "band_score2_fov", "mov_score", "luminance",
           "yuv_luminance")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# y0, 1/dy, Ymin, Ymax, p, then the masking exponents and log2 scalars up to beta
# (band_score._kernel_scalars)
_SCORE1 = [_F] * 9      # ..., q, lc10, lcorr, beta
_SCORE2 = [_F] * 10     # ..., q_s, q_t, lc10, lcorr, beta
# C signature of each library's entry point: (library stem, symbol, argtypes)
_SIGNATURES = {
    # x, y, N, H, W, vec, warps_per_block, strip_rows, col_blocks, strips
    # (the wrapper's launch plan), stream
    "gausspyr_reduce": ("reduce", "fvvdp_gausspyr_reduce",
                        [_P, _P, *[_I] * 8, _P]),
    # fine, coarse, tables, partials, out (or null), F, H, W, h2, w2, n_grid,
    # r_lo, r_hi, bkg_ch, vec, tiles_x, tiles_y, frames_per_group, groups (the
    # wrapper's launch plan), scalars, stream
    "expand_score2": ("band_pipeline", "fvvdp_expand_score2",
                      [_P, _P, _P, _P, _P, *[_I] * 14, *_SCORE2, _P]),
    # expand_score2's second pass on gathered partials: partials, out, F,
    # n_parts, stream (not a kernel of its own: no launch counter)
    "sum_partials": ("band_pipeline", "fvvdp_sum_partials", [_P, _P, _I, _I, _P]),
    # carry_t, new_t, carry_r, new_r, taps, out, ncarry, nnew, fl, HW, stream
    "temporal_pair": ("temporal", "fvvdp_temporal_pair",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # fine, coarse, contrast, lbkg, F, C, H, W, h2, w2, bkg_ch, stream
    "expand_contrast": ("expand_contrast", "fvvdp_expand_contrast",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    # T, R, L, table, partials, out, F, hw, fs_T, fs_R, fs_L, n_grid, vec,
    # block_pixels, n_blocks, frames_per_group, groups (the wrapper's launch
    # plan), scalars, stream
    "band_score": ("band_score", "fvvdp_band_score",
                   [_P] * 6 + [_I, _I, _L, _L, _L] + [_I] * 6 + [*_SCORE1, _P]),
    # band, L, tables, partials, out, F, hw, fs_L, n_grid, launch plan, scalars, stream
    "band_score2": ("band_score", "fvvdp_band_score2",
                    [_P] * 5 + [_I, _I, _L] + [_I] * 6 + [*_SCORE2, _P]),
    # band, L, tabs_s, tabs_t, partials, out, F, hw, fs_L, n_grid, launch plan,
    # scalars, stream
    "band_score2_fov": ("band_score", "fvvdp_band_score2_fov",
                        [_P] * 6 + [_I, _I, _L] + [_I] * 6 + [*_SCORE2, _P]),
    # band, L, vd, t_r, gaze, V2s, V2t, partials, out, F, hw, fs_L, n_e, ny, nr,
    # vec, lut_shared, n_blocks, frames_per_group, groups (the wrapper's launch
    # plan), es0, 1/des, emin, emax, off5, scalars, stream
    "mov_score": ("mov_score", "fvvdp_mov_score",
                  [_P] * 9 + [_I, _I, _L, _I, _I, _I] + [_I] * 5 + [_F] * 5
                  + [*_SCORE2, _P]),
    # x, tables, out, n, rows, row_len, row_stride, pixel_stride,
    # channel_stride, channels, element bytes, interleaved, vec, blocks (the
    # wrapper's launch plan), stream
    "luminance": ("luminance", "fvvdp_luminance", [_P, _P, _P] + [_L] * 6 + [_I] * 5 + [_P]),
    # raw, out, tap weights, frames, frame_stride, W, H, element bytes,
    # chroma420, kind, vec (the wrapper's launch plan), a host pointer to the
    # float32 constants, add_black, stream
    "yuv_luminance": ("yuv_luminance", "fvvdp_yuv_luminance",
                      [_P] * 3 + [_L] * 2 + [_I] * 6 + [_P, _I, _P]),
}

_counts: Dict[str, int] = {k: 0 for k in KERNELS}
_scoped: Dict[object, Dict[str, int]] = {}
_count_lock = threading.Lock()
_scope = threading.local()
_fns: Dict[str, ctypes._CFuncPtr] = {}
_fns_lock = threading.Lock()
_build_lock = threading.Lock()
build_seconds: Optional[float] = None


def launch_counts(scope=None) -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset: all of them, or
    those made under ``launch_scope(scope)``."""
    with _count_lock:
        if scope is None:
            return dict(_counts)
        return dict(_scoped.get(scope, {k: 0 for k in KERNELS}))


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _counts:
            _counts[k] = 0
        _scoped.clear()


@contextlib.contextmanager
def launch_scope(key):
    """Count the launches this thread makes inside the block under ``key``
    too (besides the totals)."""
    outer = getattr(_scope, "key", None)
    _scope.key = key
    try:
        yield
    finally:
        _scope.key = outer


def count_launch(name: str) -> None:
    key = getattr(_scope, "key", None)
    with _count_lock:
        _counts[name] += 1
        if key is not None:
            _scoped.setdefault(key, {k: 0 for k in KERNELS})[name] += 1


def _sources_hash() -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(SRC_DIR)):
        if fn.endswith((".cu", ".cuh")):
            h.update(fn.encode())
            with open(os.path.join(SRC_DIR, fn), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = os.path.join(cuda_home, "bin", "nvcc")
        nvcc = cand if os.access(cand, os.X_OK) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under $CUDA_HOME/bin or "
            "/usr/local/cuda/bin): the CUDA kernels of fovvideovdp_tpu_torch "
            "are compiled from csrc/ at first use and need the CUDA toolkit")
    return nvcc


def _lib_path(stem: str, tag: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{stem}-{tag}.so")


def build_log(stem: str) -> str:
    """What ``nvcc -Xptxas -v`` printed when ``csrc/<stem>.cu`` was built."""
    with open(build()[stem] + ".log", encoding="utf-8", errors="replace") as f:
        return f.read()


def build() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` (in parallel) unless this hash of the
    sources is already built.  Returns {stem: library path}."""
    global build_seconds
    with _build_lock:
        tag = _sources_hash()
        stems = sorted(fn[:-3] for fn in os.listdir(SRC_DIR) if fn.endswith(".cu"))
        paths = {s: _lib_path(s, tag) for s in stems}
        todo = [s for s in stems if not os.path.isfile(paths[s])]
        if not todo:
            return paths
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for s in todo:
            tmp = f"{paths[s]}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", SRC_DIR, "-o", tmp,
                   os.path.join(SRC_DIR, s + ".cu")]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for s, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- {s}.cu (nvcc exit {proc.returncode}):\n"
                              + out.decode(errors="replace"))
            else:
                with open(paths[s] + ".log", "wb") as f:
                    f.write(out)
                os.replace(tmp, paths[s])
        build_seconds = time.perf_counter() - t0
        if errors:
            raise RuntimeError("building the CUDA kernels failed:\n"
                               + "\n".join(errors))
        return paths


def kernel_fn(name: str):
    """The ctypes entry point of one kernel, building the libraries first."""
    fn = _fns.get(name)
    if fn is None:
        paths = build()
        with _fns_lock:
            fn = _fns.get(name)
            if fn is None:
                stem, symbol, argtypes = _SIGNATURES[name]
                fn = getattr(ctypes.CDLL(paths[stem]), symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
