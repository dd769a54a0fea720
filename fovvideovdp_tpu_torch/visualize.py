"""Difference-map visualisation: histogram-equalised context tone mapping,
the threshold / supra-threshold / monochromatic colour maps, and the gaze
cross of foveated runs.

Counterpart of ``fovvideovdp_tpu/visualize.py:14-195``.  The JAX package
builds its 1024-bin histogram and its curve lookup from one-hot matrix
products because gathers are slow on a TPU; here the same integer bins go
through ``torch.bincount`` and the curve is gathered, in float32, on the
device of the input.
"""
from __future__ import annotations

import numpy as np
import torch

_COLORMAPS = {
    "threshold": (
        np.array([[0.2, 0.2, 1.0],
                  [0.2, 1.0, 1.0],
                  [0.2, 1.0, 0.2],
                  [1.0, 1.0, 0.2],
                  [1.0, 0.2, 0.2]], dtype=np.float32),
        np.array([0.00, 0.25, 0.50, 0.75, 1.00], dtype=np.float32)),
    "supra-threshold": (
        np.array([[0.2, 1.0, 1.0],
                  [1.0, 1.0, 1.0],
                  [1.0, 1.0, 0.2]], dtype=np.float32),
        np.array([0.0, 0.5, 1.0], dtype=np.float32)),
    "monochromatic": (
        np.array([[1.0, 1.0, 1.0],
                  [1.0, 1.0, 1.0]], dtype=np.float32),
        np.array([0.0, 1.0], dtype=np.float32)),
}

_N_BINS = 1024


def log_luminance(y: torch.Tensor) -> torch.Tensor:
    """log of luminance clamped to its smallest positive value."""
    pos_min = torch.min(torch.where(y > 0.0, y, torch.full_like(y, float("inf"))))
    pos_min = torch.where(torch.isfinite(pos_min), pos_min, torch.full_like(pos_min, 1e-6))
    return torch.log(torch.maximum(y, pos_min))


def vis_tonemap(b: torch.Tensor, dr: float) -> torch.Tensor:
    """Histogram-equalisation tone mapping into a dr-wide value range."""
    t = 3.0
    b_min = torch.min(b)
    b_max = torch.max(b)
    span = b_max - b_min
    if float(span) < dr:
        return (b - b_min) / (span + 1e-3) * dr + (1 - dr) / 2

    bins = torch.clamp(((b - b_min) / span * _N_BINS).to(torch.int64), 0, _N_BINS - 1)
    b_p = torch.bincount(bins.reshape(-1), minlength=_N_BINS).to(b.dtype)
    b_p = b_p / torch.sum(b_p)
    dy = torch.pow(b_p, 1.0 / t)
    dy = dy / torch.sum(dy)
    v = torch.cumsum(dy, dim=0) * dr + (1.0 - dr) / 2.0

    # linear interpolation on the uniform grid linspace(0, 1, N) * span + b_min
    dx = span / (_N_BINS - 1)
    u = torch.clamp((b - b_min) / dx, 0.0, float(_N_BINS - 1))
    i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, _N_BINS - 2)
    f = u - i0.to(b.dtype)
    return v[i0] * (1.0 - f) + v[i0 + 1] * f


def _interp1_static_knots(x_np: np.ndarray, v_np: np.ndarray, q: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation over a handful of constant knots, as a
    chain of elementwise selects (queries lie inside [x[0], x[-1]]; the
    callers clip)."""
    out = torch.full_like(q, float(v_np[0]))
    for i in range(len(x_np) - 1):
        x0, x1 = float(x_np[i]), float(x_np[i + 1])
        v0, v1 = float(v_np[i]), float(v_np[i + 1])
        f = (q - x0) / (x1 - x0 + 1e-6)
        out = torch.where((q > x0) & (q <= x1), v0 + f * (v1 - v0), out)
    return out


def visualize_diff_map(diff_map: torch.Tensor, context_image=None,
                       colormap_type: str = "supra-threshold") -> torch.Tensor:
    """Colour-mapped visual difference overlay for one frame.

    diff_map: (1, H, W) in 0..1; context_image: (1, H, W) luminance or None.
    Returns the (3, H, W) overlay."""
    if colormap_type not in _COLORMAPS:
        raise RuntimeError(f"Unknown colormap: {colormap_type}")
    color_map, color_map_in = _COLORMAPS[colormap_type]

    diff_map = torch.clamp(diff_map, 0.0, 1.0)
    if context_image is None:
        tmo_img = torch.ones_like(diff_map) * 0.5
    else:
        tmo_img = vis_tonemap(log_luminance(context_image), 0.6)

    cm_l = (color_map[:, 0] * 0.212656 + color_map[:, 1] * 0.715158
            + color_map[:, 2] * 0.072186)
    cm_ch = color_map / (cm_l[:, None] + 0.0001)

    cmap = torch.stack([_interp1_static_knots(color_map_in, cm_ch[:, c], diff_map[0])
                        for c in range(3)], dim=0)
    return torch.clamp(cmap * tmo_img, 0.0, 1.0)


def visualize_diff_map_frames(dmap: torch.Tensor, context: torch.Tensor,
                              colormap_type: str = "supra-threshold") -> torch.Tensor:
    """dmap / context (F, 1, H, W) -> (F, 3, H, W), frame by frame (each
    frame has its own tone curve)."""
    return torch.stack([visualize_diff_map(d, c, colormap_type)
                        for d, c in zip(dmap, context)], dim=0)


def add_fixation_cross(frame: torch.Tensor, fixation_point, size: int = 21,
                       value: float = 1.0) -> torch.Tensor:
    """A gaze cross drawn over ``frame`` (..., H, W) at ``fixation_point``
    (x, y) in pixels, for debugging foveated runs
    (matlab/utils/fvvdp_add_fixation_cross.m): 3 pixels wide, ``size``
    pixels long, of ``value``."""
    H, W = frame.shape[-2], frame.shape[-1]
    fx, fy = int(fixation_point[0]), int(fixation_point[1])
    half = size // 2
    yy = torch.arange(H, device=frame.device)[:, None]
    xx = torch.arange(W, device=frame.device)[None, :]
    on_v = (torch.abs(xx - fx) <= 1) & (torch.abs(yy - fy) <= half)
    on_h = (torch.abs(yy - fy) <= 1) & (torch.abs(xx - fx) <= half)
    return torch.where(on_v | on_h, value, frame)
