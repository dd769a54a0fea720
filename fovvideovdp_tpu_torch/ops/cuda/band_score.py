"""Scorers of one materialised contrast band: wrappers of
``csrc/band_score.cu`` and their plain versions.

Replace the TPU kernels of ``fovvideovdp_tpu/ops/pallas/band_score.py``:
``_band_score_kernel`` (:func:`band_score`, one channel, per-channel LUTs),
``_band_score2_kernel`` (:func:`band_score2`, both channels, 1-D tables) and
``_band_score2_fov_kernel`` (:func:`band_score2_fov`, both channels,
per-pixel tables of a fixed gaze).  Each returns per-frame sums over pixels
of D^beta.  The plain versions mirror ``_band_score_jnp`` (direct form) and
``_band_score2_fov_jnp`` (telescoped table interpolation).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fovvideovdp_tpu_torch.csf import _np, two_knots
from fovvideovdp_tpu_torch.ops.cuda import _lib


class ScoreMeta(NamedTuple):
    """Scalars of the band score, as Python floats."""
    y0: float
    dy: float
    Ymin: float
    Ymax: float
    p: float
    q_s: float
    q_t: float
    c10: float
    corr: float
    beta: float


def score_meta(lut, p, q_sust, q_trans, mask_c, sens_corr, beta) -> ScoreMeta:
    Y_log = _np(lut["Y_log"])
    Y = _np(lut["Y"])
    return ScoreMeta(float(Y_log[0]),
                     float((Y_log[-1] - Y_log[0]) / (Y_log.shape[0] - 1)),
                     float(Y[0]), float(Y[-1]),
                     float(p), float(q_sust), float(q_trans),
                     float(10.0 ** mask_c), float(sens_corr), float(beta))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _d_beta_sum(T, R, Se, m: ScoreMeta, q: float) -> torch.Tensor:
    """Masking and the beta-power sum over pixels, direct form."""
    Tn = T * Se
    Rn = R * Se
    M = m.c10 * torch.minimum(torch.abs(Tn), torch.abs(Rn))
    D = torch.clamp(torch.pow(torch.abs(Tn - Rn), m.p) / (1.0 + torch.pow(M, q)),
                    max=1e4)
    return torch.sum(torch.pow(D, m.beta), dim=(-2, -1))


def _table_coord(L, m: ScoreMeta, n: int) -> torch.Tensor:
    return torch.clamp((torch.log2(torch.clamp(L, m.Ymin, m.Ymax)) - m.y0) / m.dy,
                       0.0, float(n - 1))


def band_score_plain(T, R, L, table, m: ScoreMeta, q: float) -> torch.Tensor:
    """Per-frame sum over pixels of D^beta for one channel (direct form)."""
    n = table.shape[0]
    u = _table_coord(L, m, n)
    i0, i1, f = two_knots(u, n)
    S_log = table[i0] * (1.0 - f) + table[i1] * f
    return _d_beta_sum(T, R, torch.exp2(S_log) * m.corr, m, q)


def band_score2_plain(band, L_bkg, tables, meta: ScoreMeta) -> torch.Tensor:
    return torch.stack([
        band_score_plain(band[:, 0], band[:, 1], L_bkg, tables[0], meta, meta.q_s),
        band_score_plain(band[:, 2], band[:, 3], L_bkg, tables[1], meta, meta.q_t),
    ], dim=-1)


def band_score2_fov_plain(band, L_bkg, tabs_s, tabs_t, meta: ScoreMeta) -> torch.Tensor:
    n = tabs_s.shape[0]
    u = _table_coord(L_bkg, meta, n)

    def s_of(tabs):
        s = torch.zeros_like(u) + tabs[0]
        for i in range(n - 1):
            s = s + (tabs[i + 1] - tabs[i]) * torch.clamp(u - float(i), 0.0, 1.0)
        return torch.exp2(s) * meta.corr

    return torch.stack([
        _d_beta_sum(band[:, 0], band[:, 1], s_of(tabs_s), meta, meta.q_s),
        _d_beta_sum(band[:, 2], band[:, 3], s_of(tabs_t), meta, meta.q_t),
    ], dim=-1)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name: str, ref: torch.Tensor, tensors) -> None:
    for label, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} is on {t.device}, the band on {ref.device}")


def _check_band(name: str, band, L_bkg) -> None:
    if band.dim() != 4 or band.shape[1] != 4:
        raise ValueError(f"{name}: band must be (F, 4, h, w), got {tuple(band.shape)}")
    if tuple(L_bkg.shape) != (band.shape[0],) + tuple(band.shape[2:]):
        raise ValueError(f"{name}: L_bkg {tuple(L_bkg.shape)} does not match the band "
                         f"{tuple(band.shape)}")


def _frame_stride(name: str, label: str, t: torch.Tensor) -> int:
    """Frame stride of a (F, h, w) tensor whose planes are contiguous (a
    channel of a (F, C, h, w) stack is such a view)."""
    F, h, w = t.shape
    if not t[0].is_contiguous() or (F > 1 and t.stride(0) < h * w):
        raise ValueError(f"{name}: {label} needs contiguous (h, w) planes, got strides "
                         f"{t.stride()} for shape {tuple(t.shape)}")
    return t.stride(0) if F > 1 else h * w


def _scalars(m: ScoreMeta, *q):
    return (m.y0, m.dy, m.Ymin, m.Ymax, m.p, *q, float(np.log2(m.c10)),
            float(np.log2(m.corr)), m.beta)


def _scratch(F: int, hw: int, device):
    """Partials (F, pixel blocks, 2) and output (F, 2) of a pixel scorer."""
    n_blocks = _lib.kernel_fn("band_score_n_blocks")(hw)
    return (torch.empty((F, n_blocks, 2), dtype=torch.float32, device=device),
            torch.empty((F, 2), dtype=torch.float32, device=device))


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {t.device}")
    return False


def band_score(T: torch.Tensor, R: torch.Tensor, L_bkg: torch.Tensor,
               table: torch.Tensor, meta: ScoreMeta, q: float) -> torch.Tensor:
    """One temporal channel of one band: T, R contrast and L_bkg, each
    (F, h, w) (channel views of a (F, C, h, w) stack are taken as they
    are); table (n,) log2-sensitivity on the Y grid of ``meta``; ``q`` the
    channel's masking exponent.  Returns (F,).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if T.dim() != 3 or R.shape != T.shape or L_bkg.shape != T.shape:
        raise ValueError(f"band_score: T, R, L_bkg must be equal (F, h, w), got "
                         f"{tuple(T.shape)}, {tuple(R.shape)}, {tuple(L_bkg.shape)}")
    if table.dim() != 1:
        raise ValueError(f"band_score: table must be (n,), got {tuple(table.shape)}")
    _check("band_score", T, (("T", T), ("R", R), ("L_bkg", L_bkg), ("table", table)))
    if _on_cpu("band_score", T):
        return band_score_plain(T, R, L_bkg, table, meta, q)
    strides = [_frame_stride("band_score", label, t)
               for label, t in (("T", T), ("R", R), ("L_bkg", L_bkg))]
    if not table.is_contiguous():
        raise ValueError("band_score needs a contiguous table")
    F, h, w = T.shape
    partials, out = _scratch(F, h * w, T.device)
    fn = _lib.kernel_fn("band_score")
    with torch.cuda.device(T.device):
        rc = fn(T.data_ptr(), R.data_ptr(), L_bkg.data_ptr(), table.data_ptr(),
                partials.data_ptr(), out.data_ptr(), F, h * w, *strides,
                table.shape[0], *_scalars(meta, float(q)), _lib.stream_ptr(T))
    _lib.check(rc, "band_score")
    _lib.count_launch("band_score")
    return out[:, 0]


def band_score2(band: torch.Tensor, L_bkg: torch.Tensor, tables: torch.Tensor,
                meta: ScoreMeta) -> torch.Tensor:
    """Both temporal channels of one band: band (F, 4, h, w) contrast stack
    [T-sust, R-sust, T-trans, R-trans], L_bkg (F, h, w), tables (2, n) on a
    shared Y grid.  Returns (F, 2).  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""
    _check_band("band_score2", band, L_bkg)
    if tables.dim() != 2 or tables.shape[0] != 2:
        raise ValueError(f"band_score2: tables must be (2, n), got {tuple(tables.shape)}")
    _check("band_score2", band, (("band", band), ("L_bkg", L_bkg), ("tables", tables)))
    if _on_cpu("band_score2", band):
        return band_score2_plain(band, L_bkg, tables, meta)
    if not (band.is_contiguous() and tables.is_contiguous()):
        raise ValueError("band_score2 needs a contiguous band and tables")
    fs_L = _frame_stride("band_score2", "L_bkg", L_bkg)
    F, _, h, w = band.shape
    partials, out = _scratch(F, h * w, band.device)
    fn = _lib.kernel_fn("band_score2")
    with torch.cuda.device(band.device):
        rc = fn(band.data_ptr(), L_bkg.data_ptr(), tables.data_ptr(),
                partials.data_ptr(), out.data_ptr(), F, h * w, fs_L, tables.shape[1],
                *_scalars(meta, meta.q_s, meta.q_t), _lib.stream_ptr(band))
    _lib.check(rc, "band_score2")
    _lib.count_launch("band_score2")
    return out


def band_score2_fov(band: torch.Tensor, L_bkg: torch.Tensor, tabs_s: torch.Tensor,
                    tabs_t: torch.Tensor, meta: ScoreMeta) -> torch.Tensor:
    """Both temporal channels with per-pixel CSF tables (fixed-gaze
    foveation): band (F, 4, h, w), L_bkg (F, h, w), tabs_s / tabs_t
    (n, h, w) plane-major log2-sensitivity tables on the Y grid of ``meta``.
    Returns (F, 2).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    _check_band("band_score2_fov", band, L_bkg)
    for label, t in (("tabs_s", tabs_s), ("tabs_t", tabs_t)):
        if t.dim() != 3 or tuple(t.shape[1:]) != tuple(band.shape[2:]) \
                or t.shape[0] != tabs_s.shape[0]:
            raise ValueError(f"band_score2_fov: {label} must be (n, h, w) for the band "
                             f"{tuple(band.shape)}, got {tuple(t.shape)}")
    _check("band_score2_fov", band, (("band", band), ("L_bkg", L_bkg),
                                     ("tabs_s", tabs_s), ("tabs_t", tabs_t)))
    if _on_cpu("band_score2_fov", band):
        return band_score2_fov_plain(band, L_bkg, tabs_s, tabs_t, meta)
    if not (band.is_contiguous() and tabs_s.is_contiguous() and tabs_t.is_contiguous()):
        raise ValueError("band_score2_fov needs a contiguous band and tables")
    fs_L = _frame_stride("band_score2_fov", "L_bkg", L_bkg)
    F, _, h, w = band.shape
    partials, out = _scratch(F, h * w, band.device)
    fn = _lib.kernel_fn("band_score2_fov")
    with torch.cuda.device(band.device):
        rc = fn(band.data_ptr(), L_bkg.data_ptr(), tabs_s.data_ptr(), tabs_t.data_ptr(),
                partials.data_ptr(), out.data_ptr(), F, h * w, fs_L, tabs_s.shape[0],
                *_scalars(meta, meta.q_s, meta.q_t), _lib.stream_ptr(band))
    _lib.check(rc, "band_score2_fov")
    _lib.count_launch("band_score2_fov")
    return out
