"""Host-side I/O: image loading, raw YUV conversion, and the resize that
the file sources share.

Counterpart of ``fovvideovdp_tpu/io/__init__.py``.  The JAX package resizes
with ``jax.image.resize``, which ``torch.nn.functional.interpolate`` does not
match: its cubic is Keys' with a = -0.5 (torch's bicubic uses -0.75), it
widens the kernel when it downscales (antialiasing), its "nearest" samples
at half-pixel centres, and it drops the taps that fall outside the input and
renormalises the rest.  :func:`resize` builds the same weight matrices, in
float32 as JAX builds them, and applies each as the few taps per output that
carry weight (a gather and a multiply-add per tap) instead of a dense
product: at 4K a dense product of the 4:2:0 chroma upscale would be ~2 TFLOP
per 32-frame block, its taps are two per axis.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# CLI --full-screen-resize choice -> jax.image.resize method.  jax.image has
# no area filter; 'area' degrades to linear, as in the JAX package.
RESIZE_METHODS = {"nearest": "nearest", "bilinear": "bilinear",
                  "bicubic": "cubic", "area": "linear"}

# the method names jax.image.resize accepts, by kernel
_KERNELS = {"linear": "linear", "bilinear": "linear", "trilinear": "linear",
            "triangle": "linear", "cubic": "cubic", "bicubic": "cubic",
            "tricubic": "cubic", "nearest": "nearest"}


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    # Keys' cubic convolution kernel, a = -0.5, in jax.image's operation order
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


def weight_matrix(in_size: int, out_size: int, kernel: str) -> np.ndarray:
    """(in_size, out_size) float32 weights of one axis, as
    ``jax.image.resize`` builds them (``compute_weight_mat`` with
    antialiasing on, no translation, and the scale a Python float: its
    inverse is taken in double precision, then rounded to float32)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = (_triangle if kernel == "linear" else _keys_cubic)(x.astype(f32))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int, kernel: str) -> Tuple[np.ndarray, np.ndarray]:
    """(out_size, K) input indices and weights of the taps that carry weight:
    the band of nonzero rows of :func:`weight_matrix`'s column for each
    output, padded with zero-weight taps to the widest band.  For "nearest"
    the one tap jax.image.resize samples, weight 1."""
    if kernel == "nearest":
        pos = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * in_size / out_size
        idx = np.floor(pos.astype(np.float32)).astype(np.int64)[:, None]
        return idx, np.ones((out_size, 1), dtype=np.float32)
    w = weight_matrix(in_size, out_size, kernel)
    nz = w != 0
    lo = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    hi = np.where(nz.any(axis=0), in_size - nz[::-1].argmax(axis=0), 0)
    k = max(1, int((hi - lo).max()))
    idx = lo[:, None] + np.arange(k)[None, :]
    valid = idx < hi[:, None]
    idx = np.where(valid, idx, 0)
    taps = np.where(valid, w[idx, np.arange(out_size)[:, None]], np.float32(0))
    return idx.astype(np.int64), taps.astype(np.float32)


def _resize_axis(x: torch.Tensor, dim: int, out_size: int, kernel: str) -> torch.Tensor:
    idx, w = _taps(x.shape[dim], out_size, kernel)
    idx_t = torch.from_numpy(idx).to(x.device)
    if kernel == "nearest":
        return x.index_select(dim, idx_t[:, 0])
    shape = [1] * x.dim()
    shape[dim] = out_size
    w_t = torch.from_numpy(w).to(x.device)
    out = x.index_select(dim, idx_t[:, 0]) * w_t[:, 0].reshape(shape)
    for k in range(1, idx.shape[1]):
        out = out + x.index_select(dim, idx_t[:, k]) * w_t[:, k].reshape(shape)
    return out


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, x.shape[:-2] + out_hw, method)`` for a float32
    tensor whose last two axes are height and width.  An axis whose size
    does not change is left alone, as JAX leaves it.  The width axis, whose
    gather is the slower one, goes first when the height grows, so that it
    runs on the smaller tensor."""
    if method not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    kernel = _KERNELS[method]
    axes = [(x.dim() - 2, out_hw[0]), (x.dim() - 1, out_hw[1])]
    if out_hw[0] > x.shape[-2]:
        axes.reverse()
    for dim, n in axes:
        if x.shape[dim] != n:
            x = _resize_axis(x, dim, int(n), kernel)
    return x
