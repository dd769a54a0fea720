"""One contrast-pyramid level written out: wrapper of
``csrc/expand_contrast.cu`` and its plain version.

Replaces the TPU kernel ``fovvideovdp_tpu/ops/pallas/expand.py``
``_expand_contrast_kernel``.  The plain version is
``ops/pyramid.py:_expand_contrast_plain`` (the JAX package's
``_expand_contrast_jnp``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from fovvideovdp_tpu_torch.ops.cuda import _autograd, _lib
from fovvideovdp_tpu_torch.ops.pyramid import _expand_contrast_plain, ceildiv


def expand_contrast_plain(g_fine, g_coarse, bkg_channel: int = 1):
    return _expand_contrast_plain(g_fine, g_coarse, tuple(g_fine.shape[-2:]), bkg_channel)


# bytes the plain version's autograd graph keeps per frame, as a multiple of
# one frame of its inputs (_autograd.KernelOp): 8 measured at 256 x 512
# with saved-tensor hooks, and room for the backward's own
GRAPH_BYTES = 12.0


@_autograd.differentiable(expand_contrast_plain, diff=(0, 1), framed=(0, 1),
                          graph_bytes=GRAPH_BYTES)
def expand_contrast(g_fine: torch.Tensor, g_coarse: torch.Tensor,
                    bkg_channel: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand the coarse Gaussian level and turn the fine one into Weber
    contrast against it.

    g_fine (F, C, H, W), g_coarse (F, C, ceil(H/2), ceil(W/2)), float32,
    C = 2 (image) or 4 (video).  Returns (contrast (F, C, H, W), clamped to
    <= 1000, and L_bkg (F, 1, H, W), the expanded channel ``bkg_channel``
    clamped to >= 0.1).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if g_fine.dim() != 4 or g_fine.shape[1] not in (2, 4):
        raise ValueError(f"expand_contrast: g_fine must be (F, 2 or 4, H, W), got "
                         f"{tuple(g_fine.shape)}")
    F, C, H, W = g_fine.shape
    if tuple(g_coarse.shape) != (F, C, ceildiv(H, 2), ceildiv(W, 2)):
        raise ValueError(f"expand_contrast: g_coarse {tuple(g_coarse.shape)} does "
                         f"not match g_fine {tuple(g_fine.shape)}")
    if not 0 <= bkg_channel < C:
        raise ValueError(f"expand_contrast: bkg_channel {bkg_channel} outside [0, {C})")
    for name, t in (("g_fine", g_fine), ("g_coarse", g_coarse)):
        if t.dtype != torch.float32:
            raise TypeError(f"expand_contrast: {name} must be float32, got {t.dtype}")
    if g_coarse.device != g_fine.device:
        raise ValueError(f"expand_contrast: g_coarse is on {g_coarse.device}, "
                         f"g_fine on {g_fine.device}")
    if g_fine.device.type == "cpu":
        return expand_contrast_plain(g_fine, g_coarse, bkg_channel)
    if g_fine.device.type != "cuda":
        raise RuntimeError(f"expand_contrast: unsupported device {g_fine.device}")
    if not (g_fine.is_contiguous() and g_coarse.is_contiguous()):
        raise ValueError("expand_contrast needs contiguous tensors")
    contrast = torch.empty_like(g_fine)
    lbkg = torch.empty((F, 1, H, W), dtype=torch.float32, device=g_fine.device)
    fn = _lib.kernel_fn("expand_contrast")
    with torch.cuda.device(g_fine.device):
        rc = fn(g_fine.data_ptr(), g_coarse.data_ptr(), contrast.data_ptr(),
                lbkg.data_ptr(), F, C, H, W, g_coarse.shape[2], g_coarse.shape[3],
                int(bkg_channel), _lib.stream_ptr(g_fine))
    _lib.check(rc, "expand_contrast")
    _lib.count_launch("expand_contrast")
    return contrast, lbkg
