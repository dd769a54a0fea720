"""1-D linear interpolation with the reference interpolators' semantics.

Counterpart of ``interp1`` in ``fovvideovdp_tpu/ops/interp.py:28``
(pyfvvdp/interp.py:11-30): the cell's upper knot is the first knot >= the
query, end cells are clamped, the fraction's denominator carries a 1e-6
epsilon, and a fraction below 0 (a query under the grid) is 0.
"""
from __future__ import annotations

import torch


def interp1(x: torch.Tensor, v: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """v(x) at the query points x_q (any shape); x ascending."""
    shp = x_q.shape
    x_q = x_q.reshape(-1)
    n = x.shape[0]
    i_hi = torch.clamp(torch.searchsorted(x, x_q, side="left"), max=n - 1)
    i_lo = torch.clamp(i_hi - 1, 0, n - 1)
    f = (x_q - x[i_lo]) / (x[i_hi] - x[i_lo] + 1e-6)
    f = torch.where(i_hi == i_lo, torch.zeros_like(f), f)
    f = torch.where(f < 0.0, torch.zeros_like(f), f)
    return (v[i_lo] * (1.0 - f) + v[i_hi] * f).reshape(shp)
