"""Fixed-point YUV -> float RGB conversion and chroma upsampling.

Counterpart of ``fovvideovdp_tpu/io/yuv.py``: limited-range fixed-point
scaling (16/219 luma, 128/224 chroma), the bilinear 4:2:0 -> 4:4:4 chroma
upscale with half-pixel centres, and the YCbCr -> RGB matrices.  10- and
12-bit planes travel as int16 (uint16 reinterpreted bit for bit) and are
read back with ``& 0xFFFF``.  The 3x3 colour conversion is three float32
multiply-adds per channel in the order k = 0, 1, 2, never a TF32 product:
the PQ EOTF amplifies its rounding.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fovvideovdp_tpu_torch.io import resize

# Numerically the BT.601 full-range coefficients: the reference uses exactly
# these values for its "BT.709" path, and its published JODs were produced
# through them, so they are the parity contract (the true BT.709 matrix would
# be [1, 0, 1.5748 / 1, -.1873, -.4681 / 1, 1.8556, 0]).
YCBCR2RGB_REC709 = np.array([[1.0, 0.0, 1.402],
                             [1.0, -0.344136, -0.714136],
                             [1.0, 1.772, 0.0]], dtype=np.float32)

YCBCR2RGB_REC2020 = np.array([[1.0, 0.0, 1.47460],
                              [1.0, -0.16455, -0.57135],
                              [1.0, 1.88140, 0.0]], dtype=np.float32)


def as_float(x: torch.Tensor) -> torch.Tensor:
    """Stored samples -> float32; int16 holds uint16 samples bit for bit."""
    if x.dtype == torch.int16:
        return (x.to(torch.int32) & 0xFFFF).to(torch.float32)
    return x.to(torch.float32)


def fixed2float_y(Y: torch.Tensor, bit_depth: int) -> torch.Tensor:
    offset = 16.0 / 219.0
    weight = 1.0 / (2 ** (bit_depth - 8) * 219.0)
    return torch.clamp(weight * as_float(Y) - offset, 0.0, 1.0)


def fixed2float_uv(uv: torch.Tensor, bit_depth: int) -> torch.Tensor:
    offset = 128.0 / 224.0
    weight = 1.0 / (2 ** (bit_depth - 8) * 224.0)
    return torch.clamp(weight * as_float(uv) - offset, -0.5, 0.5)


def upscale_chroma(uv: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear 4:2:0 -> 4:4:4 upscale with half-pixel centres, as
    ``jax.image.resize(..., method="bilinear")``."""
    return resize(uv, tuple(out_hw), "bilinear")


def conversion_matrix(bt2020: bool) -> np.ndarray:
    return YCBCR2RGB_REC2020 if bt2020 else YCBCR2RGB_REC709


def decoded_planes(Y, u, v, bit_depth: int, chroma_ss: str):
    """Luma (..., H, W) and chroma planes -> the float32 (Y, u, v) planes at
    full resolution."""
    H, W = Y.shape[-2:]
    Yf = fixed2float_y(Y, bit_depth)
    uvf = fixed2float_uv(torch.stack((u, v)), bit_depth)
    if chroma_ss == "420":
        uvf = upscale_chroma(uvf, (H, W))
    return Yf, uvf[0], uvf[1]


def rgb_channel(planes, M: np.ndarray, c: int) -> torch.Tensor:
    """Channel c of the colour conversion: three float32 multiply-adds in
    the order k = 0, 1, 2."""
    Yf, uf, vf = planes
    out = Yf * float(M[c, 0])
    out = out + uf * float(M[c, 1])
    return out + vf * float(M[c, 2])


def yuv_to_rgb(Y, u, v, bit_depth: int, chroma_ss: str, bt2020: bool) -> torch.Tensor:
    """(..., H, W) luma + subsampled chroma planes -> (..., H, W, 3)
    display-encoded RGB."""
    planes = decoded_planes(Y, u, v, bit_depth, chroma_ss)
    M = conversion_matrix(bt2020)
    return torch.stack([rgb_channel(planes, M, c) for c in range(3)], dim=-1)
