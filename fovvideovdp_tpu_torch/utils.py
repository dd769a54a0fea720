"""Config-file resolution, JSON and .mat loading, the JAX-gradient clip,
the Gaussian blur, the sRGB transfer functions, the PU21 encoding and the
small helpers of the reference's utils.

Same three-layer precedence as ``fovvideovdp_tpu/utils/__init__.py:25-56``
(explicit dir > ``$FVVDP_PATH`` > packaged data), so one external config
directory serves both packages.  The packaged data is this package's own
copy under ``data/``.  ``load_mat_dict``, ``gaussian_kernel_2d``,
``ImGaussFilt``, ``srgb2linear``, ``linear2srgb``, ``PU``, ``img2np``,
``l2rgb``, ``stack_horizontal``, ``stack_vertical`` and ``platform_info``
are the counterparts of ``utils/__init__.py:58-209``.
"""
from __future__ import annotations

import json
import os
import threading
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
        y = conv2d_fp32(x, torch.as_tensor(self.K, device=x.device)[None, None])
        return y[0, 0] if squeeze else y


# held while a TF32 switch is turned off around a product: the switches are
# global, and the slots of a mesh convolve from threads of their own, so one
# thread must not turn a switch back on under another's product
FP32_LOCK = threading.Lock()


def conv2d_fp32(x: torch.Tensor, K: torch.Tensor, padding=0) -> torch.Tensor:
    """``F.conv2d`` (a cross-correlation, zero padding) in float32 with TF32
    off on the card, as the JAX package convolves at HIGHEST precision."""
    with FP32_LOCK:
        was = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return F.conv2d(x, K, padding=padding)
        finally:
            torch.backends.cudnn.allow_tf32 = was


def srgb2linear(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB-encoded values in [0, 1] -> linear values (the sRGB EOTF)."""
    srgb = torch.clamp(srgb, 0.0, 1.0)
    return torch.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4, srgb / 12.92)


def linear2srgb(lin: torch.Tensor) -> torch.Tensor:
    """Linear values in [0, 1] -> sRGB-encoded values (the inverse EOTF)."""
    lin = torch.clamp(lin, 0.0, 1.0)
    return torch.where(lin > 0.0031308, 1.055 * lin ** (1 / 2.4) - 0.055, 12.92 * lin)


class PU:
    """PU21 perceptually-uniform encoding of absolute luminance (tensors):
    the published PU21 coefficients and formula, as
    ``fovvideovdp_tpu/utils/__init__.py:87-124``."""

    COEFFS = {
        "banding": [1.063020987, 0.4200327408, 0.1666005322, 0.2817030548,
                    1.029472678, 1.119265011, 502.1303377],
        "banding_glare": [234.0235618, 216.9339286, 0.0001091864237, 0.893206924,
                          0.06733984121, 1.444718567, 567.6315065],
        "peaks": [1.057454135, 0.6234292574, 0.3060331179, 0.3702234502,
                  1.116868695, 1.109926637, 391.3707005],
        "peaks_glare": [1.374063733, 0.3160810744, 0.1350497609, 0.510558148,
                        1.049265455, 1.404963498, 427.3579761],
    }

    def __init__(self, L_min=0.005, L_max=10000, type="banding_glare"):
        if type not in self.COEFFS:
            raise ValueError(f"Unknown type: {type}")
        self.L_min = L_min
        self.L_max = L_max
        self.p = self.COEFFS[type]
        p = self.p
        self.peak = p[6] * (((p[0] + p[1] * L_max ** p[3]) / (1 + p[2] * L_max ** p[3]))
                            ** p[4] - p[5])

    def encode(self, Y: torch.Tensor) -> torch.Tensor:
        """Absolute luminance (cd/m^2) -> PU21 units."""
        p = self.p
        Y = torch.clamp(Y, self.L_min, self.L_max)
        return p[6] * (((p[0] + p[1] * Y ** p[3]) / (1 + p[2] * Y ** p[3])) ** p[4] - p[5])

    def decode(self, V: torch.Tensor) -> torch.Tensor:
        """PU21 units -> absolute luminance."""
        p = self.p
        V_p = torch.clamp(V / p[6] + p[5], min=0.0) ** (1 / p[4])
        return (torch.clamp(V_p - p[0], min=0.0) / (p[1] - p[2] * V_p)) ** (1 / p[3])


def img2np(img) -> np.ndarray:
    """uint8 image -> float32 in [0, 1]."""
    return np.array(img, dtype="float32") / 255.0


def l2rgb(x: np.ndarray) -> np.ndarray:
    """A luminance plane (..., 1) replicated into RGB (..., 3)."""
    return np.concatenate([x, x, x], -1)


def stack_horizontal(nparr) -> np.ndarray:
    return np.concatenate(list(nparr), axis=-2)


def stack_vertical(nparr) -> np.ndarray:
    return np.concatenate(list(nparr), axis=-3)


def platform_info() -> str:
    """One line for benchmark printouts: the host's CPU model and core count
    from /proc/cpuinfo, and the CUDA cards torch sees."""
    cpu = "unknown CPU"
    try:
        model, cores = None, 0
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("model name"):
                    cores += 1
                    if model is None:
                        model = line.split(":", 1)[1].strip()
        if model:
            cpu = f"{model} x{cores}"
    except OSError:
        pass
    if torch.cuda.is_available():
        kinds = {}
        for i in range(torch.cuda.device_count()):
            kind = torch.cuda.get_device_name(i)
            kinds[kind] = kinds.get(kind, 0) + 1
        acc = ", ".join(f"{n}x {k}" for k, n in sorted(kinds.items()))
    else:
        acc = "no CUDA card"
    return f"{cpu} | {acc}"
