"""Gaussian pyramid: plan, plain reduce/expand and level construction.

Counterpart of ``fovvideovdp_tpu/ops/pyramid.py:29-145,148-152,192-298``.
The plain functions are written with slicing arithmetic (as the JAX
package's are) and are the CPU path and the reference the CUDA kernels are
held against.  Edge handling follows the reference bit for bit, including
its quirk of selecting the last-column correction by the ROW parity.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Burt-Adelson generating kernel, a = 0.4.
KERNEL_A = 0.4
K5 = np.array([0.25 - KERNEL_A / 2.0, 0.25, KERNEL_A, 0.25, 0.25 - KERNEL_A / 2.0],
              dtype=np.float32)
# the float32 taps as Python floats (exact), for tensor-scalar arithmetic
_K = [float(k) for k in K5]


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Separable reduce / expand (operate on the last two axes)
# ---------------------------------------------------------------------------

def _reduce_rows(x: torch.Tensor) -> torch.Tensor:
    """5-tap filter + stride 2 along axis -2, symmetric edges
    (numpy ``"symmetric"``: row -1 -> 0, row -2 -> 1)."""
    H = x.shape[-2]
    Ho = ceildiv(H, 2)
    xp = torch.cat([x[..., 1:2, :], x[..., 0:1, :], x,
                    x[..., H - 1:H, :], x[..., H - 2:H - 1, :]], dim=-2)
    y = None
    for k in range(5):
        term = _K[k] * xp[..., k:k + 2 * Ho - 1:2, :]
        y = term if y is None else y + term
    return y


def _reduce_cols(y_a: torch.Tensor, in_rows: int) -> torch.Tensor:
    """5-tap filter + stride 2 along axis -1 with zero padding plus the
    reference's boundary corrections (branch picked by the parity of the
    input ROW count)."""
    W = y_a.shape[-1]
    Wo = ceildiv(W, 2)
    yp = F.pad(y_a, (2, 2))
    y = None
    for k in range(5):
        term = _K[k] * yp[..., k:k + 2 * Wo - 1:2]
        y = term if y is None else y + term
    y[..., 0] += y_a[..., 0] * _K[1] + y_a[..., 1] * _K[0]
    if in_rows % 2 == 1:
        y[..., -1] += y_a[..., -1] * _K[3] + y_a[..., -2] * _K[4]
    else:
        y[..., -1] += y_a[..., -1] * _K[4]
    return y


def _gausspyr_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """One pyramid level, (..., H, W) -> (..., ceil(H/2), ceil(W/2))."""
    return _reduce_cols(_reduce_rows(x), x.shape[-2])


def _interleave_pad(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """Zero-interleave x along ``axis`` into a buffer of length out_size+4
    with the reference's boundary fill: x[0] at index 0 and x[-1] at
    index -2 + (out_size odd)."""
    x = torch.movedim(x, axis, -1)
    z = torch.zeros(x.shape[:-1] + (out_size + 4,), dtype=x.dtype,
                    device=x.device)
    z[..., 2:-2:2] = x
    z[..., 0] = x[..., 0]
    odd = out_size % 2
    z[..., -2 + odd] = x[..., -1]
    return torch.movedim(z, -1, axis)


def _conv5_valid(z: torch.Tensor, axis: int, gain: float) -> torch.Tensor:
    """Valid 5-tap convolution along ``axis`` with kernel gain*K5."""
    z = torch.movedim(z, axis, 0)
    n_out = z.shape[0] - 4
    y = None
    for k in range(5):
        term = float(np.float32(gain * K5[k])) * z[k:k + n_out]
        y = term if y is None else y + term
    return torch.movedim(y, 0, axis)


def gausspyr_expand(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """One level of Gaussian-pyramid expansion to (..., size[0], size[1])."""
    y = _interleave_pad(x, size[0], axis=-2)
    y = _conv5_valid(y, axis=-2, gain=2.0)
    y = _interleave_pad(y, size[1], axis=-1)
    return _conv5_valid(y, axis=-1, gain=2.0)


def _expand_contrast_plain(g_fine, g_coarse, size, bkg_channel):
    """Expanded coarse level -> Weber contrast of the fine level and the
    background luminance (clamped to >= 0.1 cd/m^2)."""
    glayer_ex = gausspyr_expand(g_coarse, size)
    L_bkg = torch.clamp(glayer_ex[..., bkg_channel:bkg_channel + 1, :, :], min=0.1)
    contrast = torch.clamp((g_fine - glayer_ex) / L_bkg, max=1000.0)
    return contrast, L_bkg


# ---------------------------------------------------------------------------
# Pyramid plan
# ---------------------------------------------------------------------------

class PyramidPlan:
    """Static description of the pyramid for a given (W, H, ppd).

    ``height`` counts the Laplacian (scored) bands; the Gaussian pyramid has
    ``height + 1`` levels.  Band peak frequencies are
    ``[1, 0.3228*2^-k] * ppd/2``, cut off below 0.5 cpd.
    """

    MIN_FREQ = 0.5

    def __init__(self, W: int, H: int, ppd: float):
        self.W = W
        self.H = H
        self.ppd = ppd

        max_levels = int(np.floor(np.log2(min(H, W)))) - 1
        bands = np.concatenate([[1.0], np.power(2.0, -np.arange(0.0, 14.0)) * 0.3228]) * ppd / 2.0
        invalid = np.nonzero(bands <= self.MIN_FREQ)[0]
        max_band = invalid[0] if invalid.size > 0 else max_levels
        self.height = int(np.clip(max_band + 1, 0, max_levels))
        self.band_freqs = np.array(
            [1.0] + [0.3228 * 2.0 ** (-f) for f in range(self.height)]) * ppd / 2.0

        self.level_shapes: List[Tuple[int, int]] = []
        cH, cW = H, W
        for _ in range(self.height + 1):
            self.level_shapes.append((cH, cW))
            cH, cW = ceildiv(cH, 2), ceildiv(cW, 2)

    def get_freqs(self) -> np.ndarray:
        return self.band_freqs

    def get_band_count(self) -> int:
        return self.height + 1

    @staticmethod
    def band_gain(band: int, n_bands: int) -> float:
        """Interior Laplacian bands carry a 2x gain."""
        return 1.0 if band == 0 or band == n_bands - 1 else 2.0

    def gaussian_pyramid(self, image: torch.Tensor) -> List[torch.Tensor]:
        """Gaussian levels of ``image`` (..., H, W) through the reduce
        wrapper: the CUDA kernel on the card, the plain version on the CPU."""
        from fovvideovdp_tpu_torch.ops.cuda.reduce import gausspyr_reduce
        levels = [image]
        for _ in range(self.height):
            levels.append(gausspyr_reduce(levels[-1]))
        return levels

    def decompose(self, image: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Plain Laplacian decomposition.  Returns (Laplacian bands + base,
        Gaussian levels)."""
        gpyr = self.gaussian_pyramid(image)
        lpyr = [gpyr[i] - gausspyr_expand(gpyr[i + 1], self.level_shapes[i])
                for i in range(len(gpyr) - 1)]
        lpyr.append(gpyr[-1])
        return lpyr, gpyr

    @staticmethod
    def _contrast_pairs(gpyr: Sequence[torch.Tensor], bkg_channel: int
                        ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """(contrast (F, C, h, w), L_bkg (F, 1, h, w)) of each scored level,
        finest first, through the expand_contrast wrapper: the CUDA kernel
        on the card, the plain version on the CPU."""
        from fovvideovdp_tpu_torch.ops.cuda.expand_contrast import expand_contrast
        for fine, coarse in zip(gpyr[:-1], gpyr[1:]):
            yield expand_contrast(fine, coarse, bkg_channel)

    def contrast_levels(self, image: torch.Tensor, bkg_channel: int = 1
                        ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """The contrast pyramid of ``image`` (F, C, H, W) one level at a
        time: each Laplacian band as Weber contrast (clamped to <= 1000)
        against the expanded next Gaussian level of channel ``bkg_channel``
        (the background luminance, clamped to >= 0.1 cd/m^2).  A caller that
        drops each pair before taking the next holds one level's contrast
        at a time, not the pyramid's."""
        return self._contrast_pairs(self.gaussian_pyramid(image), bkg_channel)

    def decompose_contrast(self, image: torch.Tensor, bkg_channel: int = 1
                           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The whole contrast pyramid at once.  Returns (contrast bands +
        the Gaussian base, L_bkg per level)."""
        gpyr = self.gaussian_pyramid(image)
        pairs = list(self._contrast_pairs(gpyr, bkg_channel))
        return [c for c, _ in pairs] + [gpyr[-1]], [lb for _, lb in pairs]

    @staticmethod
    def reconstruct(bands: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of the expanded bands, coarsest first."""
        img = bands[-1]
        for i in reversed(range(len(bands) - 1)):
            img = gausspyr_expand(img, (bands[i].shape[-2], bands[i].shape[-1]))
            img = img + bands[i]
        return img
