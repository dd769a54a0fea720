"""Config-file resolution, JSON and .mat loading, the JAX-gradient clip and
the Gaussian blur.

Same three-layer precedence as ``fovvideovdp_tpu/utils/__init__.py:25-56``
(explicit dir > ``$FVVDP_PATH`` > packaged data), so one external config
directory serves both packages.  The packaged data is this package's own
copy under ``data/``.  ``load_mat_dict``, ``gaussian_kernel_2d`` and
``ImGaussFilt`` are the counterparts of ``utils/__init__.py:58-75,125-157``.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def json2dict(path: str) -> dict:
    if not os.path.isfile(path):
        raise RuntimeError(f"Error: Cannot find file {path}")
    with open(path, "r") as f:
        return json.load(f)


class config_files:
    """Three-layer config resolution: explicit dir > $FVVDP_PATH > packaged data."""

    fvvdp_config_dir: Optional[str] = None

    @classmethod
    def set_config_dir(cls, path: Optional[str]) -> None:
        cls.fvvdp_config_dir = path

    @classmethod
    def find(cls, fname: str) -> str:
        if cls.fvvdp_config_dir is not None:
            path = os.path.join(cls.fvvdp_config_dir, fname)
            if os.path.isfile(path):
                return path

        env_dir = os.getenv("FVVDP_PATH")
        if env_dir is not None:
            path = os.path.join(env_dir, fname)
            if os.path.isfile(path):
                return path

        path = os.path.join(_DATA_DIR, fname)
        if os.path.isfile(path):
            return path

        raise RuntimeError(f"The configuration file {fname} not found")


def load_mat_dict(filepath: str, data_label: str):
    """One variable of a MATLAB .mat file: a struct as a dict of numpy
    arrays, anything else as an array; None when the file or the variable
    is missing.  Reads user CSF caches in the reference's format."""
    if not os.path.isfile(filepath):
        return None
    import scipy.io as sio

    m = sio.loadmat(filepath)
    if data_label not in m:
        return None
    rec = m[data_label]
    if rec.dtype.names:  # MATLAB struct -> dict of arrays
        return {name: np.ascontiguousarray(rec[name][0, 0]) for name in rec.dtype.names}
    return np.asarray(rec)


def clip(V: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``torch.clamp(V, lo, hi)`` with the JAX package's gradient: where
    autograd reads it, min(max(V, lo), hi), as ``jnp.clip`` computes it, so
    that a value at a bound passes half of the gradient, not all of it.  The
    value is clamp's either way."""
    if not (torch.is_grad_enabled() and V.requires_grad):
        return torch.clamp(V, lo, hi)
    if lo is not None:
        V = torch.maximum(V, V.new_tensor(lo))
    return V if hi is None else torch.minimum(V, V.new_tensor(hi))


def gaussian_kernel_2d(sigma: float) -> np.ndarray:
    """2-D Gaussian kernel, normalised to sum 1, with the reference's
    support rule: 2 * ceil(2 sigma) + 1 taps per axis."""
    size = 2 * int(np.ceil(2.0 * sigma)) + 1
    half = (size - 1) // 2
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    K = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma * sigma))
    return (K / K.sum()).astype(np.float32)


def _pad_indices(n: int, h: int, mode: str) -> np.ndarray:
    """Source index of each of the n + 2h positions of an axis padded by h
    on both sides, as ``np.pad`` computes them: "edge" repeats the end
    values, "reflect" mirrors about the end values, again and again where
    h exceeds n - 1."""
    i = np.arange(-h, n + h)
    if mode == "edge" or n == 1:
        return np.clip(i, 0, n - 1)
    period = 2 * (n - 1)
    j = np.mod(i, period)
    return np.where(j < n, j, period - j)


class ImGaussFilt:
    """Gaussian blur of the last two axes: reflect padding by default, or
    ``pad_mode="edge"`` for MATLAB imgaussfilt's replicate padding.  A
    float32 ``F.conv2d`` of the 2-D kernel (TF32 off on the card), as the
    JAX package runs ``lax.conv_general_dilated`` at HIGHEST precision."""

    def __init__(self, sigma: float, pad_mode: str = "reflect"):
        if pad_mode not in ("reflect", "edge"):
            raise ValueError(f"pad_mode must be 'reflect' or 'edge', got {pad_mode!r}")
        self.K = gaussian_kernel_2d(sigma)
        self.half = (self.K.shape[0] - 1) // 2
        self.pad_mode = pad_mode

    def run(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W) or (N, 1, H, W) -> the same shape, blurred."""
        squeeze = img.dim() == 2
        x = (img[None, None] if squeeze else img).to(torch.float32)
        h = self.half
        for dim in (-2, -1):
            idx = _pad_indices(x.shape[dim], h, self.pad_mode)
            x = x.index_select(dim, torch.as_tensor(idx, device=x.device))
        K = torch.as_tensor(self.K, device=x.device)[None, None]
        was = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            y = F.conv2d(x, K)
        finally:
            torch.backends.cudnn.allow_tf32 = was
        return y[0, 0] if squeeze else y
