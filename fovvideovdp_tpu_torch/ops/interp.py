"""LUT interpolation with the reference interpolators' semantics: 1-D
linear and 3-D trilinear.

Counterpart of ``fovvideovdp_tpu/ops/interp.py`` (pyfvvdp/interp.py:11-69):
the cell's upper knot is the first knot >= the query, end cells are
clamped, the fraction's denominator carries a 1e-6 epsilon, and a fraction
below 0 (a query under the grid) is 0.
"""
from __future__ import annotations

import torch


def _interpolants(x_q: torch.Tensor, x: torch.Tensor):
    """(i_lo, i_hi, frac) of the query points x_q (flat) in the ascending
    grid x."""
    n = x.shape[0]
    i_hi = torch.clamp(torch.searchsorted(x, x_q, side="left"), max=n - 1)
    i_lo = torch.clamp(i_hi - 1, 0, n - 1)
    f = (x_q - x[i_lo]) / (x[i_hi] - x[i_lo] + 1e-6)
    f = torch.where(i_hi == i_lo, torch.zeros_like(f), f)
    f = torch.where(f < 0.0, torch.zeros_like(f), f)
    return i_lo, i_hi, f


def interp1(x: torch.Tensor, v: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """v(x) at the query points x_q (any shape); x ascending."""
    shp = x_q.shape
    i_lo, i_hi, f = _interpolants(x_q.reshape(-1), x)
    return (v[i_lo] * (1.0 - f) + v[i_hi] * f).reshape(shp)


def interp3(x, y, z, v, x_q, y_q, z_q) -> torch.Tensor:
    """Trilinear interpolation on a 3-D grid at the query points (x_q, y_q,
    z_q), all of one shape.  ``v`` is indexed ``v[y, x, z]``: the reference's
    axis order (pyfvvdp/interp.py:53-57, after MATLAB's interp3)."""
    shp = x_q.shape
    i_lo, i_hi, fi = _interpolants(x_q.reshape(-1), x)
    j_lo, j_hi, fj = _interpolants(y_q.reshape(-1), y)
    k_lo, k_hi, fk = _interpolants(z_q.reshape(-1), z)
    c_lo = ((v[j_lo, i_lo, k_lo] * (1 - fi) + v[j_lo, i_hi, k_lo] * fi) * (1 - fj)
            + (v[j_hi, i_lo, k_lo] * (1 - fi) + v[j_hi, i_hi, k_lo] * fi) * fj)
    c_hi = ((v[j_lo, i_lo, k_hi] * (1 - fi) + v[j_lo, i_hi, k_hi] * fi) * (1 - fj)
            + (v[j_hi, i_lo, k_hi] * (1 - fi) + v[j_hi, i_hi, k_hi] * fi) * fj)
    return (c_lo * (1 - fk) + c_hi * fk).reshape(shp)
