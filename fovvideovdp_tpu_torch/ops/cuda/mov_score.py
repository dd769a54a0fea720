"""Moving-gaze foveated scorer of one materialised contrast band: wrapper
of ``csrc/mov_score.cu`` and its plain version.

Replaces the TPU kernel ``_mov_kernel`` of
``fovvideovdp_tpu/ops/pallas/mov_score.py``.  Per frame the eccentricity of
every pixel follows from the static view directions and that frame's gaze;
the CSF is the trilinear interpolation of the band's LUT window at
(eccentricity, luminance, rho).  Returns per-frame sums over pixels of
D^beta for both temporal channels.  The plain version mirrors ``_mov_jnp``
(8-corner gather).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fovvideovdp_tpu_torch.csf import _np, two_knots
from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.ops.cuda import band_score as bs


class MovMeta(NamedTuple):
    """Scalars of the moving-gaze score, as Python numbers: the band score's
    (Y axis of the trimmed LUT), the sqrt-eccentricity axis, the window's
    knot counts and the omega = 5 offset (None: a second table is given)."""
    score: bs.ScoreMeta
    es0: float
    des: float
    emin: float
    emax: float
    ny: int
    nr: int
    off5: Optional[float]


def mov_meta(score: bs.ScoreMeta, ecc_lut, ny: int, nr: int,
             off5: Optional[float]) -> MovMeta:
    es = _np(ecc_lut["ecc_sqrt"])
    ec = _np(ecc_lut["ecc"])
    return MovMeta(score, float(es[0]), float((es[-1] - es[0]) / (es.shape[0] - 1)),
                   float(ec[0]), float(ec[-1]), int(ny), int(nr),
                   None if off5 is None else float(off5))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def band_score2_mov_plain(band, L_bkg, vd, t_r, gaze_dir, V2s, V2t,
                          meta: MovMeta) -> torch.Tensor:
    m = meta.score
    n_e = V2s.shape[0]
    dx = vd[0][None] - gaze_dir[:, 0, None, None]
    dv = vd[1][None] - gaze_dir[:, 1, None, None]
    ecc = torch.sqrt(dx * dx + dv * dv)
    te = torch.clamp((torch.sqrt(torch.clamp(ecc, meta.emin, meta.emax)) - meta.es0)
                     / meta.des, 0.0, float(n_e - 1))
    u = bs._table_coord(L_bkg, m, meta.ny)
    ie0, ie1, fe = two_knots(te, n_e)
    iy0, iy1, fy = two_knots(u, meta.ny)
    ir0, ir1, fr = two_knots(torch.broadcast_to(t_r[None], te.shape), meta.nr)

    def interp(V2):
        flat = V2.reshape(-1)
        s = torch.zeros_like(u)
        for ie, we in ((ie0, 1.0 - fe), (ie1, fe)):
            for iy, wy in ((iy0, 1.0 - fy), (iy1, fy)):
                for ir, wr in ((ir0, 1.0 - fr), (ir1, fr)):
                    s = s + we * wy * wr * flat[(ie * meta.ny + iy) * meta.nr + ir]
        return s

    s_s = interp(V2s)
    s_t = s_s + meta.off5 if meta.off5 is not None else interp(V2t)
    return torch.stack([
        bs._d_beta_sum(band[:, 0], band[:, 1], torch.exp2(s_s) * m.corr, m, m.q_s),
        bs._d_beta_sum(band[:, 2], band[:, 3], torch.exp2(s_t) * m.corr, m, m.q_t),
    ], dim=-1)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def lut_in_shared(n_e: int, meta: MovMeta) -> bool:
    """Whether the kernel stages a LUT window of these sizes in shared memory
    (else it reads it from global memory)."""
    return bool(_lib.kernel_fn("mov_score_lut_in_shared")(
        n_e, meta.ny, meta.nr, int(meta.off5 is None)))


def band_score2_mov(band: torch.Tensor, L_bkg: torch.Tensor, vd: torch.Tensor,
                    t_r: torch.Tensor, gaze_dir: torch.Tensor, V2s: torch.Tensor,
                    V2t: Optional[torch.Tensor], meta: MovMeta) -> torch.Tensor:
    """Both temporal channels of one band with a per-frame gaze: band
    (F, 4, h, w) contrast stack [T-sust, R-sust, T-trans, R-trans], L_bkg
    (F, h, w), vd (2, h, w) static view directions in degrees, t_r (h, w)
    rho coordinate in the band's LUT window, gaze_dir (F, 2) gaze view
    directions in degrees, V2s / V2t (n_e, ny * nr) the windowed
    log2-sensitivity LUTs of the two channels (V2t None when ``meta.off5``
    stands for it).  Returns (F, 2).  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""
    name = "band_score2_mov"
    bs._check_band(name, band, L_bkg)
    F, _, h, w = band.shape
    if tuple(vd.shape) != (2, h, w) or tuple(t_r.shape) != (h, w):
        raise ValueError(f"{name}: vd must be (2, h, w) and t_r (h, w) for the band "
                         f"{tuple(band.shape)}, got {tuple(vd.shape)}, {tuple(t_r.shape)}")
    if tuple(gaze_dir.shape) != (F, 2):
        raise ValueError(f"{name}: gaze_dir must be ({F}, 2), got {tuple(gaze_dir.shape)}")
    if (V2t is None) != (meta.off5 is not None):
        raise ValueError(f"{name}: give either the second table V2t or meta.off5")
    tables = [("V2s", V2s)] + ([] if V2t is None else [("V2t", V2t)])
    for label, t in tables:
        if t.dim() != 2 or t.shape[1] != meta.ny * meta.nr or t.shape != V2s.shape:
            raise ValueError(f"{name}: {label} must be (n_e, {meta.ny} * {meta.nr}), "
                             f"got {tuple(t.shape)}")
    bs._check(name, band, [("band", band), ("L_bkg", L_bkg), ("vd", vd), ("t_r", t_r),
                           ("gaze_dir", gaze_dir)] + tables)
    if bs._on_cpu(name, band):
        return band_score2_mov_plain(band, L_bkg, vd, t_r, gaze_dir, V2s, V2t, meta)
    for label, t in [("band", band), ("vd", vd), ("t_r", t_r), ("gaze_dir", gaze_dir)] + tables:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {label}")
    fs_L = bs._frame_stride(name, "L_bkg", L_bkg)
    partials, out = bs._scratch(F, h * w, band.device)    # the pixel scorers share it
    fn = _lib.kernel_fn("mov_score")
    with torch.cuda.device(band.device):
        rc = fn(band.data_ptr(), L_bkg.data_ptr(), vd.data_ptr(), t_r.data_ptr(),
                gaze_dir.data_ptr(), V2s.data_ptr(),
                None if V2t is None else V2t.data_ptr(),
                partials.data_ptr(), out.data_ptr(), F, h * w, fs_L,
                V2s.shape[0], meta.ny, meta.nr, meta.es0, meta.des, meta.emin, meta.emax,
                0.0 if meta.off5 is None else meta.off5,
                *bs._scalars(meta.score, meta.score.q_s, meta.score.q_t),
                _lib.stream_ptr(band))
    _lib.check(rc, "mov_score")
    _lib.count_launch("mov_score")
    return out
