"""Visualisation of metric prediction maps, after MATLAB's hdrvdp_visualize.

Counterpart of ``fovvideovdp_tpu/hdrvdp_visualize.py``:

* ``visualize_pmap``: a probability-of-detection map;
* ``visualize_diff``: the contrast-normalised difference weighted by the
  probability;
* ``visualize_civdm``: the contrast-invariant distortion map (red: reversal,
  green: loss, blue: amplification);
* colormaps "trichromatic", "dichromatic" and "monochromatic"; targets
  "screen" (colour) and "print" (luma carries the error; the context keeps
  only its low-contrast high frequencies).

Inputs are (H, W) or (H, W, 3) tensors (arrays are converted to float32
tensors on the CPU); the results are tensors on the inputs' device.
"""
from __future__ import annotations

import numpy as np
import torch

from fovvideovdp_tpu_torch.ops.interp import interp1
from fovvideovdp_tpu_torch.utils import conv2d_fp32
from fovvideovdp_tpu_torch.visualize import log_luminance, vis_tonemap

_COLORMAPS = {
    "trichromatic": (
        np.array([[0.2, 0.2, 1.0], [0.2, 1.0, 1.0], [0.2, 1.0, 0.2],
                  [1.0, 1.0, 0.2], [1.0, 0.2, 0.2]], np.float32),
        np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)),
    "dichromatic": (
        np.array([[0.2, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 0.2]], np.float32),
        np.array([0.0, 0.5, 1.0], np.float32)),
    "monochromatic": (
        np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]], np.float32),
        np.array([0.0, 1.0], np.float32)),
}

_LUM_W = np.array([0.2126, 0.7152, 0.0722], np.float32)


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, dtype=np.float32))


def _luminance(img: torch.Tensor) -> torch.Tensor:
    if img.dim() == 3 and img.shape[-1] == 3:
        return img[..., 0] * 0.212656 + img[..., 1] * 0.715158 + img[..., 2] * 0.072186
    return img if img.dim() == 2 else img[..., 0]


def _log_luminance(img: torch.Tensor) -> torch.Tensor:
    """log of the luminance clamped to its smallest positive value (1e-6
    for a plane with none)."""
    return log_luminance(_luminance(img))


def _blur_gaussian(X: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) plane with zero padding, the
    output the input's size (MATLAB conv2 'same'; the kernel is symmetric,
    so correlation and convolution agree)."""
    ksize2 = int(round(sigma * 3))
    g = np.exp(-np.arange(-ksize2, ksize2 + 1) ** 2 / (2.0 * sigma ** 2))
    g = torch.as_tensor((g / g.sum()).astype(np.float32), device=X.device)
    x = X[None, None].to(torch.float32)
    x = conv2d_fp32(x, g.view(1, 1, 1, -1), padding=(0, ksize2))      # along rows
    return conv2d_fp32(x, g.view(1, 1, -1, 1), padding=(ksize2, 0))[0, 0]


def _context_tmo(context_image, target: str, P: torch.Tensor) -> torch.Tensor:
    if context_image is None:
        return torch.full_like(P, 0.5)
    context_image = _tensor(context_image)
    if target == "print":
        lg = _log_luminance(context_image)
        hp_img = lg - _blur_gaussian(lg, 2.0) + torch.mean(lg)
        return vis_tonemap(hp_img, 0.1) + 0.5
    if target == "screen":
        return vis_tonemap(_log_luminance(context_image), 0.6)
    raise RuntimeError(f"Unknown target: {target}")


def visualize_pmap(P, context_image=None, target="screen", colormap="trichromatic"):
    """Probability-of-detection map -> sRGB visualisation (H, W, 3)."""
    if colormap not in _COLORMAPS:
        raise RuntimeError(f"Unknown colormap: {colormap}")
    color_map, color_map_in = _COLORMAPS[colormap]

    P = torch.clamp(_tensor(P), 0.0, 1.0)
    tmo_img = _context_tmo(context_image, target, P)

    if target == "screen":
        cm_l = color_map @ _LUM_W
    elif colormap == "monochromatic":
        cm_l = (color_map @ _LUM_W) / np.maximum(color_map_in, 1e-4)
    else:
        # the luminance ramp starts at 0.3 so that colours stay visible in print
        cm_l = (color_map @ _LUM_W) / (color_map_in * 0.8 + 0.2)
    cm_ch = color_map / cm_l[:, None]

    cm_in = torch.as_tensor(color_map_in, device=P.device)
    chans = [interp1(cm_in, torch.as_tensor(np.ascontiguousarray(cm_ch[:, c]), device=P.device),
                     P) for c in range(3)]
    vis = torch.stack(chans, dim=-1) * tmo_img[..., None]
    return torch.clamp(vis, 0.0, 1.0)


def norm_diff_img(test, reference, sigma: float = 5.0) -> torch.Tensor:
    """Contrast-normalised difference image (hdrvdp_visualize.m:300-313)."""
    D = _luminance(_tensor(test)) - _luminance(_tensor(reference))
    ks = int(round(sigma * 4))
    half = (ks - 1) / 2.0
    xx, yy = np.meshgrid(np.arange(ks) - half, np.arange(ks) - half)
    w = np.exp(-(xx ** 2 + yy ** 2) / (2 * sigma ** 2))
    w = torch.as_tensor((w / w.sum()).astype(np.float32), device=D.device)[None, None]
    pad_t = ks // 2
    pad_b = ks - 1 - pad_t

    def filt(X):
        Xp = torch.nn.functional.pad(X[None, None], (pad_b, pad_t, pad_b, pad_t))
        return conv2d_fp32(Xp, w)[0, 0]

    mu = filt(D)
    sigma_sq = torch.clamp(filt(D * D) - mu ** 2, min=0.0)
    return torch.clamp(D / (torch.sqrt(sigma_sq) + 1.0), max=1.0)


def visualize_diff(P, test, reference, context_image=None, target="screen",
                   colormap="trichromatic") -> torch.Tensor:
    """The contrast-normalised difference weighted by the detection
    probability."""
    Pd = norm_diff_img(test, reference) * torch.clamp(_tensor(P), 0.0, 1.0)
    return visualize_pmap(Pd, context_image=context_image, target=target, colormap=colormap)


def visualize_civdm(loss, ampl, rev, context_image=None) -> torch.Tensor:
    """Contrast-invariant distortion map: red = contrast reversal, green =
    contrast loss, blue = contrast amplification (hdrvdp_visualize.m:363-381)."""
    cmap = torch.stack([_tensor(rev), _tensor(loss), _tensor(ampl)], dim=-1)
    max_v = torch.amax(cmap, dim=-1, keepdim=True)
    cmap = torch.where(cmap < max_v, torch.zeros_like(cmap), cmap)
    if context_image is not None:
        tmo = vis_tonemap(_log_luminance(_tensor(context_image)), 0.6)
        alpha = 0.5
        cmap = (1 - alpha) * cmap + alpha * (tmo ** (1 / 2.2))[..., None]
    return torch.clamp(cmap, 0.0, 1.0)
