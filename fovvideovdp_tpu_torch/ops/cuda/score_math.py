"""Plain PyTorch copy of the per-pixel scoring math that ``csrc/score_math.cuh``
holds as device functions (counterpart of
``fovvideovdp_tpu/ops/pallas/score_math.py``)."""
from __future__ import annotations

import numpy as np
import torch

from fovvideovdp_tpu_torch.csf import two_knots

# masking clamp: D is clipped at 1e4
L4 = float(np.log2(1e4))


def table_interp(table: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear lookup of a uniform-grid table at coordinate u
    (clamped to [0, n-1]): t[i0] * (1 - f) + t[i1] * f."""
    n = table.shape[-1]
    i0, i1, f = two_knots(torch.clamp(u, 0.0, float(n - 1)), n)
    return table[i0] * (1.0 - f) + table[i1] * f


def d_beta_log2(T, R, ls, p: float, q: float, lc10: float, beta: float):
    """D^beta of the mutual masking model in log2 space:

        log2 D = p*(log2|T-R| + ls) - log2(1 + 2^(q*(log2 min(|T|,|R|) + ls + lc10)))
        D^beta = 2^(beta * min(log2 D, log2 1e4))
    """
    la = torch.log2(torch.abs(T - R)) + ls
    lm = torch.log2(torch.minimum(torch.abs(T), torch.abs(R))) + (ls + lc10)
    ld = p * la - torch.log2(1.0 + torch.exp2(q * lm))
    return torch.exp2(beta * torch.clamp(ld, max=L4))
