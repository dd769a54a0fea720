"""Contrast sensitivity LUTs: loading, the host-side reductions of the
non-foveated path, the per-pixel reductions of the fixed-gaze path and the
per-frame trilinear lookup of the moving-gaze path.

Counterpart of ``fovvideovdp_tpu/csf.py``, with the JAX package's search
order for a LUT (``CSFCache``) and its general queries: :func:`sensitivity`
(the reference's cell search on every axis) and
:func:`sensitivity_trilinear` (dense weight rows).  A LUT is a dict
of float32 tensors (``LUT_FIELDS``) plus ``"_uniform"``, the per-axis flags
saying whether the grid is uniform in its transformed space.  The 1-D
reductions run once per metric core, on the host, in numpy, with the same
arithmetic as the JAX package, so both build identical tables.  The
per-pixel functions take and return tensors on the LUT's device.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from fovvideovdp_tpu_torch import csf_generator, memory, utils
from fovvideovdp_tpu_torch.ops.interp import interp3

LUT_FIELDS = ("Y", "rho", "ecc", "Y_log", "rho_log", "ecc_sqrt", "S_log")


def _np(v) -> np.ndarray:
    """LUT field as a host float32 array (tensors may live on the card)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def cache_key(omega: float, sigma: float, k_cm: float) -> str:
    """Key naming scheme shared with the reference cache files."""
    return ("o%g_s%g_cm%f" % (omega, sigma, k_cm)).replace("-", "n").replace(".", "_")


def lut_from_numpy(lut_np: Dict[str, np.ndarray], device) -> Dict:
    """Host arrays -> LUT dict of float32 tensors on ``device``, with the
    uniform-grid flags computed from the arrays."""
    lut: Dict = {k: torch.tensor(np.asarray(lut_np[k], dtype=np.float32),
                                 device=device) for k in LUT_FIELDS}
    lut["_uniform"] = {ax: _grid_is_uniform(np.asarray(lut_np[ax]))
                       for ax in ("Y_log", "rho_log", "ecc_sqrt")}
    return lut


class CSFCache:
    """Loads and holds CSF sensitivity LUTs on ``device``.

    Search order for a LUT, as the JAX package's
    (``fovvideovdp_tpu/csf.py:40-96``): the packaged ``.npz`` files, then
    user ``.mat`` caches in the reference's format under each of
    ``extra_dirs`` (``<key>_gpu0.mat``, then ``<key>.mat``; default
    ``["csf_cache"]``, relative to the working directory), then the
    analytic generator (``csf_generator.precompute_lut``)."""

    def __init__(self, device, extra_dirs: Optional[list] = None):
        self.device = torch.device(device)
        self.extra_dirs = extra_dirs or ["csf_cache"]
        self._cache: Dict[str, Dict] = {}

    def get(self, omega: float, sigma: float, k_cm: float) -> Dict:
        key = cache_key(omega, sigma, k_cm)
        if key not in self._cache:
            lut_np = self._load_npz(key)
            if lut_np is None:
                lut_np = self._load_mat(key)
            if lut_np is None:
                lut_np = csf_generator.precompute_lut(omega, sigma, k_cm)
            self._cache[key] = lut_from_numpy(lut_np, self.device)
        return self._cache[key]

    @staticmethod
    def _load_npz(key: str):
        path = os.path.join(utils._DATA_DIR, f"csf_lut_{key}.npz")
        if not os.path.isfile(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in LUT_FIELDS}

    def _load_mat(self, key: str):
        for d in self.extra_dirs:
            for suffix in ("_gpu0.mat", ".mat"):
                lut = utils.load_mat_dict(os.path.join(d, key + suffix), "lut")
                if lut is not None:
                    return {k: np.asarray(lut[k], dtype=np.float32)
                            if k == "S_log" else
                            np.asarray(lut[k], dtype=np.float32).squeeze()
                            for k in LUT_FIELDS}
        return None


def _grid_is_uniform(grid: np.ndarray, rtol: float = 1e-4) -> bool:
    d = np.diff(np.asarray(grid, dtype=np.float64))
    return bool(d.size == 0 or np.allclose(d, d[0], rtol=rtol, atol=1e-7))


def lut_is_uniform(lut: Dict) -> bool:
    """True when every LUT axis is uniform in its transformed space (the
    shipped calibration LUTs are; user .mat caches may not be)."""
    flags = lut.get("_uniform")
    return flags is None or all(flags.values())


def _axis_uniform(lut: Dict, axis: str) -> bool:
    flags = lut.get("_uniform")
    return True if flags is None else bool(flags[axis])


def _interpolants_np(x_q: float, x: np.ndarray):
    """Host-side scalar cell search of the reference interpolants."""
    n = x.shape[0]
    i_hi = int(np.searchsorted(x, x_q, side="left"))
    i_hi = min(i_hi, n - 1)
    i_lo = min(max(i_hi - 1, 0), n - 1)
    frac = (x_q - x[i_lo]) / (x[i_hi] - x[i_lo] + 1e-6)
    if i_hi == i_lo or frac < 0.0:
        frac = 0.0
    return i_lo, i_hi, float(frac)


def reduce_lut_to_1d(lut: Dict, rho: float, ecc: float) -> np.ndarray:
    """Collapse the 3-D LUT to an S_log(Y_log) table for fixed (rho, ecc):
    the exact two-axis slice of the trilinear interpolation."""
    rho_log = _np(lut["rho_log"])
    ecc_sqrt = _np(lut["ecc_sqrt"])
    S_log = _np(lut["S_log"])  # [Y, rho, ecc]

    rho_q = np.log2(np.clip(rho, float(_np(lut["rho"])[0]),
                            float(_np(lut["rho"])[-1])))
    ecc_q = np.sqrt(np.clip(ecc, float(_np(lut["ecc"])[0]),
                            float(_np(lut["ecc"])[-1])))

    i_lo, i_hi, fi = _interpolants_np(rho_q, rho_log)
    k_lo, k_hi, fk = _interpolants_np(ecc_q, ecc_sqrt)

    t = ((S_log[:, i_lo, k_lo] * (1 - fi) + S_log[:, i_hi, k_lo] * fi) * (1 - fk)
         + (S_log[:, i_lo, k_hi] * (1 - fi) + S_log[:, i_hi, k_hi] * fi) * fk)
    return t.astype(np.float32)


def trim_lut_bounds(lut: Dict, lbkg_min: float = 0.1,
                    lbkg_max: Optional[float] = None):
    """Y-grid knot range [lo, hi] the scorers can weight for background
    luminances in [lbkg_min, lbkg_max], plus a LUT copy with Y/Y_log sliced
    to it (one guard knot kept on each side).  Returns ``(lo, hi, lut')``,
    or ``(0, n-1, lut)`` when nothing can be trimmed."""
    Y_log = _np(lut["Y_log"]).reshape(-1)
    Y = _np(lut["Y"]).reshape(-1)
    n = Y_log.shape[0]
    if not _axis_uniform(lut, "Y_log") or n < 4:
        return 0, n - 1, lut
    y0 = float(Y_log[0])
    dy = float((Y_log[-1] - y0) / (n - 1))
    u_min = (np.log2(max(float(lbkg_min), float(Y[0]))) - y0) / dy
    lo = max(0, int(np.floor(u_min)) - 1)
    if lbkg_max is None or not np.isfinite(lbkg_max):
        hi = n - 1
    else:
        u_max = (np.log2(min(max(float(lbkg_max), float(lbkg_min)),
                             float(Y[-1]))) - y0) / dy
        hi = min(n - 1, int(np.ceil(u_max)) + 1)
    hi = max(hi, lo + 1)
    if lo == 0 and hi == n - 1:
        return lo, hi, lut
    lut2 = dict(lut)
    lut2["Y_log"] = lut["Y_log"][lo:hi + 1]
    lut2["Y"] = lut["Y"][lo:hi + 1]
    return lo, hi, lut2


def trim_lut_range(tables, lut: Dict, lbkg_min: float = 0.1,
                   lbkg_max: Optional[float] = None):
    """Slice Y-last-axis ``tables`` to the weightable knot range (see
    :func:`trim_lut_bounds`).  Returns ``(tables[..., lo:hi+1], lut')``."""
    lo, hi, lut2 = trim_lut_bounds(lut, lbkg_min, lbkg_max)
    if lut2 is lut:
        return tables, lut
    return np.asarray(tables)[..., lo:hi + 1], lut2


# ---------------------------------------------------------------------------
# Per-pixel (tensor) interpolation: fixed-gaze foveation and heatmaps
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _full_fp32_matmul():
    """Matrix products in full float32 (TF32 keeps about three digits), the
    switch held against other threads (``utils.FP32_LOCK``)."""
    with utils.FP32_LOCK:
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was


def _two_point_rows(i_lo, i_hi, f, n: int) -> torch.Tensor:
    """Dense (..., n) rows holding 1 - f at i_lo and f at i_hi."""
    w = torch.zeros(i_lo.shape + (n,), dtype=f.dtype, device=f.device)
    w.scatter_(-1, i_lo.unsqueeze(-1), (1.0 - f).unsqueeze(-1))
    w.scatter_add_(-1, i_hi.unsqueeze(-1), f.unsqueeze(-1))
    return w


def _uniform_weights(q: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """2-point interpolation weights on a uniform grid as a dense row (n,)
    per query."""
    n = grid.shape[0]
    return _two_point_rows(*two_knots(grid_index_coord(q, grid, True), n), n)


def _monotone_cell(q: torch.Tensor, grid: torch.Tensor):
    """Cell search of the reference interpolants on a monotone grid
    (searchsorted semantics, clamped ends, negative fractions zeroed).  The
    count of knots below q, as the JAX package counts them, comes from a
    binary search instead of an (..., n) comparison; a NaN query counts 0
    knots, as there."""
    n = grid.shape[0]
    below = torch.searchsorted(grid.contiguous(), q.contiguous())
    below = torch.where(torch.isnan(q), torch.zeros_like(below), below)
    i_hi = torch.clamp(below, max=n - 1)
    i_lo = torch.clamp(i_hi - 1, 0, n - 1)
    x_lo, x_hi = grid[i_lo], grid[i_hi]
    f = (q - x_lo) / (x_hi - x_lo + 1e-6)
    f = torch.where((i_hi == i_lo) | (f < 0.0), torch.zeros_like(f), f)
    return i_lo, i_hi, f


def _monotone_weights(q: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """2-point interpolation weights on an arbitrary monotone grid."""
    i_lo, i_hi, f = _monotone_cell(q, grid)
    return _two_point_rows(i_lo, i_hi, f, grid.shape[0])


def _grid_weights(q, grid, uniform: bool) -> torch.Tensor:
    return _uniform_weights(q, grid) if uniform else _monotone_weights(q, grid)


def grid_index_coord(q: torch.Tensor, grid: torch.Tensor, uniform: bool) -> torch.Tensor:
    """Query positions as fractional index coordinates of ``grid``:
    i_lo + f.  Uniform grids reduce to index arithmetic; monotone grids use
    the reference cell search."""
    n = grid.shape[0]
    if uniform:
        dx = (grid[-1] - grid[0]) / (n - 1)
        return torch.clamp((q - grid[0]) / dx, 0.0, float(n - 1))
    i_lo, _, f = _monotone_cell(q, grid)
    return i_lo.to(q.dtype) + f


def two_knots(u: torch.Tensor, n: int):
    """Knot pair and fraction of a piecewise-linear lookup at the index
    coordinate ``u`` (already clamped to [0, n-1]): ``(i0, i1, f)`` with
    ``i1 = min(i0 + 1, n-1)``, so the top knot carries weight 0 on itself.
    A NaN coordinate indexes knot 0 and keeps ``f`` NaN: a non-finite input
    gives a non-finite result, never an index out of range."""
    i0 = torch.clamp(torch.floor(torch.nan_to_num(u, nan=0.0)).to(torch.int64), 0, n - 1)
    return i0, torch.clamp(i0 + 1, max=n - 1), u - i0.to(u.dtype)


def reduce_lut_to_pixel_tables(lut: Dict, rho, ecc: torch.Tensor) -> torch.Tensor:
    """Collapse the 3-D LUT over its (rho, ecc) axes with per-pixel static
    maps -> (n, h, w) plane-major S_log(Y_log) tables.

    The fixed-gaze fast path: when the fixation point does not move, rho
    (spatial frequency x resolution magnification) and ecc (eccentricity)
    are static per band, so the two-axis interpolation runs once per
    fixation point here, and the per-frame work is the same 1-D luminance
    interpolation as on the non-foveated path.  Equal to the trilinear
    interpolation by associativity."""
    V = lut["S_log"]                       # [Y, rho, ecc]
    dev = V.device
    shape = tuple(ecc.shape)
    ecc = torch.as_tensor(ecc, dtype=torch.float32, device=dev).reshape(-1)
    rho = torch.broadcast_to(torch.as_tensor(rho, dtype=torch.float32, device=dev),
                             shape).reshape(-1)
    rho_q = torch.log2(torch.clamp(rho, lut["rho"][0], lut["rho"][-1]))
    ecc_q = torch.sqrt(torch.clamp(ecc, lut["ecc"][0], lut["ecc"][-1]))

    n = V.shape[0]
    N = rho_q.shape[0]
    chunk = memory.pixel_table_chunk(n, dev)
    u_r = _axis_uniform(lut, "rho_log")
    u_e = _axis_uniform(lut, "ecc_sqrt")
    out = torch.empty((N, n), dtype=torch.float32, device=dev)
    with _full_fp32_matmul():
        for a in range(0, N, chunk):
            w_r = _grid_weights(rho_q[a:a + chunk], lut["rho_log"], u_r)    # (c, n)
            w_e = _grid_weights(ecc_q[a:a + chunk], lut["ecc_sqrt"], u_e)   # (c, n)
            B = torch.einsum("yjk,pk->pyj", V, w_e)                         # (c, n, n)
            out[a:a + chunk] = torch.einsum("pyj,pj->py", B, w_r)
    return out.reshape(shape + (n,)).movedim(-1, 0).contiguous()


def _luminance_coord(lut: Dict, L_bkg: torch.Tensor) -> torch.Tensor:
    Yq = torch.log2(torch.clamp(L_bkg, lut["Y"][0], lut["Y"][-1]))
    return grid_index_coord(Yq, lut["Y_log"], _axis_uniform(lut, "Y_log"))


def sensitivity_pixel_tables(lut: Dict, tables: torch.Tensor,
                             L_bkg: torch.Tensor) -> torch.Tensor:
    """Per-pixel S from plane-major per-pixel S_log(Y_log) tables
    (n, h, w); L_bkg (F, h, w) or (h, w).  The two neighbouring knots are
    gathered per pixel; the JAX package's telescoped sum over all knots
    gives the same piecewise-linear value up to rounding."""
    n = tables.shape[0]
    u = _luminance_coord(lut, L_bkg)
    lead = u.dim() == 3
    if not lead:
        u = u[None]
    i0, i1, f = two_knots(u, n)
    s_log = torch.gather(tables, 0, i0) * (1.0 - f) + torch.gather(tables, 0, i1) * f
    S = torch.exp2(s_log)
    return S if lead else S[0]


def sensitivity_1d(lut: Dict, table_1d, L_bkg: torch.Tensor) -> torch.Tensor:
    """Per-pixel S from a pre-reduced 1-D S_log(Y_log) table."""
    table = torch.as_tensor(table_1d, dtype=torch.float32, device=L_bkg.device)
    n = table.shape[0]
    u = _luminance_coord(lut, L_bkg)
    i0, i1, f = two_knots(u, n)
    return torch.exp2(table[i0] * (1.0 - f) + table[i1] * f)


# ---------------------------------------------------------------------------
# Moving gaze: the rho window of a band and the per-frame trilinear lookup
# ---------------------------------------------------------------------------

def rho_window_weights(lut: Dict, rho_map):
    """The rho-axis knots a band can reach, and its pixels' weights on them.

    A band's per-pixel spatial frequencies rho_band * res_mag(pixel) span
    only a few knots of the rho grid, so the moving-gaze scorer works on a
    window of the LUT.  Returns ``(r_lo, r_hi, w_r)``: ``w_r``
    (h, w, r_hi-r_lo+1) holds the reference 2-point interpolation weights
    restricted to the window; every knot outside it has weight exactly 0.
    Host numpy in float32 throughout, as the JAX package computes it."""
    grid = np.asarray(_np(lut["rho_log"]), np.float32)
    n = grid.shape[0]
    rho = _np(lut["rho"])
    q = np.log2(np.clip(np.asarray(_np(rho_map), np.float32),
                        np.float32(rho[0]), np.float32(rho[-1])))
    shape = q.shape
    q = q.reshape(-1)
    if _axis_uniform(lut, "rho_log"):
        dx = np.float32((grid[-1] - grid[0]) / np.float32(n - 1))
        u = np.clip((q - grid[0]) / dx, np.float32(0.0), np.float32(n - 1))
        i_lo = np.floor(u).astype(np.int64)
        f = (u - i_lo).astype(np.float32)
        i_hi = np.minimum(i_lo + 1, n - 1)
    else:
        i_hi = np.minimum(np.sum(grid[None, :] < q[:, None], axis=-1), n - 1)
        i_lo = np.clip(i_hi - 1, 0, n - 1)
        x_lo, x_hi = grid[i_lo], grid[i_hi]
        f = ((q - x_lo) / (x_hi - x_lo + np.float32(1e-6))).astype(np.float32)
        f = np.where((i_hi == i_lo) | (f < 0.0), 0.0, f).astype(np.float32)
    r_lo = int(i_lo.min())
    r_hi = int(i_hi.max())
    n_r = r_hi - r_lo + 1
    w_r = np.zeros((q.shape[0], n_r), np.float32)
    np.put_along_axis(w_r, (i_lo - r_lo)[:, None], (1.0 - f)[:, None], 1)
    # i_hi == i_lo at the clamped top end: accumulate, do not overwrite
    hi_w = np.take_along_axis(w_r, (i_hi - r_lo)[:, None], 1) \
        + np.where(i_hi == i_lo, 0.0, f)[:, None]
    np.put_along_axis(w_r, (i_hi - r_lo)[:, None], hi_w, 1)
    return r_lo, r_hi, w_r.reshape(shape + (n_r,))


def ecc_weights(lut: Dict, ecc: torch.Tensor) -> torch.Tensor:
    """Per-pixel 2-point interpolation weights along the ecc axis, a dense
    row (n_e,) per query, with the reference clamp semantics."""
    ecc_q = torch.sqrt(torch.clamp(ecc, lut["ecc"][0], lut["ecc"][-1]))
    return _grid_weights(ecc_q, lut["ecc_sqrt"], _axis_uniform(lut, "ecc_sqrt"))


def _cell(q: torch.Tensor, grid: torch.Tensor, uniform: bool):
    """Knot pair and fraction of ``q`` on ``grid``: index arithmetic on a
    uniform grid, the reference cell search on a monotone one."""
    if uniform:
        return two_knots(grid_index_coord(q, grid, True), grid.shape[0])
    return _monotone_cell(q, grid)


# pixel-frames per pass of sensitivity_trilinear_block (about one 4K frame);
# a pass keeps some twenty temporaries of that many elements
_TRILINEAR_CHUNK = 1 << 23


def sensitivity_trilinear_block(lut: Dict, rho_map: torch.Tensor, L_bkg: torch.Tensor,
                                ecc: torch.Tensor) -> torch.Tensor:
    """Trilinear S(rho, L_bkg, ecc) for a block of frames sharing a static
    per-pixel rho map: the moving-gaze CSF of the composed route, and the
    oracle of the mov_score kernel.

    ``rho_map`` (h, w) does not depend on the frame; ``L_bkg`` (F, h, w);
    ``ecc`` (F, h, w) or (h, w).  Returns S (F, h, w).  The two neighbouring
    knots of each axis are gathered per pixel (8 corners); the JAX package
    contracts dense weight rows over all knots instead, which gives the
    same interpolant up to rounding."""
    V = lut["S_log"]                       # [Y, rho, ecc]
    n_y, n_r, n_e = V.shape
    flat = V.reshape(-1)
    F = L_bkg.shape[0]
    shape = tuple(L_bkg.shape[1:])
    rho = torch.broadcast_to(torch.as_tensor(rho_map, dtype=torch.float32,
                                             device=V.device), shape)
    ecc = torch.broadcast_to(ecc, (F,) + shape)
    u_y, u_r, u_e = (_axis_uniform(lut, ax) for ax in ("Y_log", "rho_log", "ecc_sqrt"))

    rho_q = torch.log2(torch.clamp(rho, lut["rho"][0], lut["rho"][-1]))
    r0, r1, fr = _cell(rho_q, lut["rho_log"], u_r)          # once per block
    s_log = torch.empty((F,) + shape, dtype=torch.float32, device=V.device)
    step = max(1, _TRILINEAR_CHUNK // max(1, rho.numel()))
    for a in range(0, F, step):
        Y_q = torch.log2(torch.clamp(L_bkg[a:a + step], lut["Y"][0], lut["Y"][-1]))
        ecc_q = torch.sqrt(torch.clamp(ecc[a:a + step], lut["ecc"][0], lut["ecc"][-1]))
        y0, y1, fy = _cell(Y_q, lut["Y_log"], u_y)
        e0, e1, fe = _cell(ecc_q, lut["ecc_sqrt"], u_e)
        acc = torch.zeros_like(Y_q)
        for iy, wy in ((y0, 1.0 - fy), (y1, fy)):
            for ir, wr in ((r0, 1.0 - fr), (r1, fr)):
                row = (iy * n_r + ir) * n_e
                acc += wy * wr * (flat[row + e0] * (1.0 - fe) + flat[row + e1] * fe)
        s_log[a:a + step] = acc
    return torch.exp2(s_log)


# ---------------------------------------------------------------------------
# General queries S(rho, L_bkg, ecc)
# ---------------------------------------------------------------------------

def _query(lut: Dict, rho, L_bkg, ecc):
    """The queries clamped to the grid in linear space and mapped to the
    grid's (log2 rho, log2 Y, sqrt ecc) axes; ``rho`` and ``ecc`` (scalars
    or tensors) broadcast against ``L_bkg``."""
    V = lut["S_log"]
    L = torch.as_tensor(L_bkg, dtype=torch.float32, device=V.device)
    rho = torch.broadcast_to(torch.as_tensor(rho, dtype=torch.float32, device=V.device),
                             L.shape)
    ecc = torch.broadcast_to(torch.as_tensor(ecc, dtype=torch.float32, device=V.device),
                             L.shape)
    return (torch.log2(torch.clamp(rho, lut["rho"][0], lut["rho"][-1])),
            torch.log2(torch.clamp(L, lut["Y"][0], lut["Y"][-1])),
            torch.sqrt(torch.clamp(ecc, lut["ecc"][0], lut["ecc"][-1])))


def sensitivity(lut: Dict, rho, L_bkg, ecc) -> torch.Tensor:
    """Interpolated sensitivity S(rho, L_bkg, ecc) from a LUT: the
    reference's trilinear cell search on every axis (pyfvvdp/fvvdp.py:
    529-537).  ``rho`` and ``ecc`` may be scalars, broadcast against
    ``L_bkg``."""
    rho_q, Y_q, ecc_q = _query(lut, rho, L_bkg, ecc)
    s_log = interp3(lut["rho_log"], lut["Y_log"], lut["ecc_sqrt"], lut["S_log"],
                    rho_q, Y_q, ecc_q)
    return torch.exp2(s_log)


# queries per pass of sensitivity_trilinear: a pass keeps a (chunk, n, n)
# float32 intermediate (4 KB a query at n = 32)
_QUERY_CHUNK = 16384


def sensitivity_trilinear(lut: Dict, rho, L_bkg, ecc) -> torch.Tensor:
    """S(rho, L_bkg, ecc) as :func:`sensitivity` gives it, through dense
    2-point weight rows on each axis (index arithmetic on a uniform axis,
    the reference cell search on another) contracted with the LUT one axis
    after another, as the JAX package computes it, a chunk of queries at a
    time."""
    rho_q, Y_q, ecc_q = _query(lut, rho, L_bkg, ecc)
    shape = Y_q.shape
    rho_q, Y_q, ecc_q = rho_q.reshape(-1), Y_q.reshape(-1), ecc_q.reshape(-1)
    V = lut["S_log"]                       # [Y, rho, ecc]
    n_y, n_r, n_e = V.shape
    V_flat = V.reshape(n_y, n_r * n_e)
    u_y, u_r, u_e = (_axis_uniform(lut, ax) for ax in ("Y_log", "rho_log", "ecc_sqrt"))
    s_log = torch.empty_like(Y_q)
    with _full_fp32_matmul():
        for a in range(0, Y_q.shape[0], _QUERY_CHUNK):
            sl = slice(a, a + _QUERY_CHUNK)
            w_y = _grid_weights(Y_q[sl], lut["Y_log"], u_y)          # (c, n_y)
            w_r = _grid_weights(rho_q[sl], lut["rho_log"], u_r)      # (c, n_r)
            w_e = _grid_weights(ecc_q[sl], lut["ecc_sqrt"], u_e)     # (c, n_e)
            A = torch.matmul(w_y, V_flat).reshape(-1, n_r, n_e)      # (c, rho, ecc)
            B = torch.einsum("pik,pi->pk", A, w_r)                   # (c, ecc)
            s_log[sl] = torch.sum(B * w_e, dim=-1)
    return torch.exp2(s_log).reshape(shape)
