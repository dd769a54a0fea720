"""Fused contrast-pyramid-level scorer: wrapper of ``csrc/band_pipeline.cu``
and its plain version.

Replaces the TPU kernel ``fovvideovdp_tpu/ops/pallas/band_pipeline.py``
``_expand_score_kernel``.  The plain version mirrors the JAX fallback
``_expand_score2_jnp``: the materialised expand + Weber contrast
(``ops/pyramid.py``) followed by the direct-form two-channel band score
(``ops/cuda/band_score.py``, the JAX package's ``_band_score2_jnp``).
"""
from __future__ import annotations

import numpy as np
import torch

from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.ops.cuda.band_score import ScoreMeta, band_score_plain
from fovvideovdp_tpu_torch.ops.pyramid import _expand_contrast_plain, ceildiv


def expand_score2_plain(g_fine, g_coarse, tables, meta: ScoreMeta,
                        bkg_channel: int = 1) -> torch.Tensor:
    size = (g_fine.shape[-2], g_fine.shape[-1])
    contrast, L_bkg = _expand_contrast_plain(g_fine, g_coarse, size, bkg_channel)
    L = L_bkg[:, 0]
    return torch.stack([
        band_score_plain(contrast[:, 0], contrast[:, 1], L, tables[0], meta, meta.q_s),
        band_score_plain(contrast[:, 2], contrast[:, 3], L, tables[1], meta, meta.q_t),
    ], dim=-1)


def expand_score2(g_fine: torch.Tensor, g_coarse: torch.Tensor,
                  tables: torch.Tensor, meta: ScoreMeta,
                  bkg_channel: int = 1) -> torch.Tensor:
    """Fused expand + Weber contrast + CSF + masking + beta-pooling for one
    level, both temporal channels.

    g_fine (F, 4, H, W) / g_coarse (F, 4, ceil(H/2), ceil(W/2)): Gaussian
    levels of [T-sust, R-sust, T-trans, R-trans]; tables (2, n) float32
    log2-sensitivity tables (sustained, transient) on the LUT's shared Y
    grid; ``meta.corr`` includes the per-band gain.  Returns (F, 2)
    per-frame sums of D^beta.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    if g_fine.dim() != 4 or g_fine.shape[1] != 4:
        raise ValueError(f"expand_score2: g_fine must be (F, 4, H, W), got {tuple(g_fine.shape)}")
    F, _, H, W = g_fine.shape
    if tuple(g_coarse.shape) != (F, 4, ceildiv(H, 2), ceildiv(W, 2)):
        raise ValueError(f"expand_score2: g_coarse {tuple(g_coarse.shape)} does "
                         f"not match g_fine {tuple(g_fine.shape)}")
    if tables.dim() != 2 or tables.shape[0] != 2:
        raise ValueError(f"expand_score2: tables must be (2, n), got {tuple(tables.shape)}")
    for name, t in (("g_fine", g_fine), ("g_coarse", g_coarse), ("tables", tables)):
        if t.dtype != torch.float32:
            raise TypeError(f"expand_score2: {name} must be float32, got {t.dtype}")
        if t.device != g_fine.device:
            raise ValueError(f"expand_score2: {name} is on {t.device}, g_fine on {g_fine.device}")
    if g_fine.device.type == "cpu":
        return expand_score2_plain(g_fine, g_coarse, tables, meta, bkg_channel)
    if g_fine.device.type != "cuda":
        raise RuntimeError(f"expand_score2: unsupported device {g_fine.device}")
    if not (g_fine.is_contiguous() and g_coarse.is_contiguous() and tables.is_contiguous()):
        raise ValueError("expand_score2 needs contiguous tensors")
    n_tiles = _lib.kernel_fn("expand_score2_n_tiles")(H, W)
    partials = torch.empty((F, n_tiles, 2), dtype=torch.float32, device=g_fine.device)
    out = torch.empty((F, 2), dtype=torch.float32, device=g_fine.device)
    fn = _lib.kernel_fn("expand_score2")
    with torch.cuda.device(g_fine.device):
        rc = fn(g_fine.data_ptr(), g_coarse.data_ptr(), tables.data_ptr(),
                partials.data_ptr(), out.data_ptr(), F, H, W,
                g_coarse.shape[2], g_coarse.shape[3], tables.shape[1],
                int(bkg_channel), meta.y0, meta.dy, meta.Ymin, meta.Ymax,
                meta.p, meta.q_s, meta.q_t, float(np.log2(meta.c10)),
                float(np.log2(meta.corr)), meta.beta, _lib.stream_ptr(g_fine))
    _lib.check(rc, "expand_score2")
    _lib.count_launch("expand_score2")
    return out
