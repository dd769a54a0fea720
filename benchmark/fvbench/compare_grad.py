"""The comparison that decides ``correct`` where the metric is a training
loss: what the timed calls returned against the plain reference with its
gradient (``reference/fvvdp_plain_grad.py``) on the same clips.

Numbers compared, each against its limit in ``limits/<workload>.json``, on
every call (``compare.judge`` then judges them):

* ``jod_gap``: |JOD - JOD_ref|, the JOD being 10 - the call's loss;
* ``grad_gap``: ||g - g_ref|| / ||g_ref||, the relative L2 gap of the
  gradient of the loss with respect to the test clip;
* ``grad_max_gap``: max |g - g_ref| / max |g_ref|.

The gradient of a pair's last call is kept and compared in full.  Of every
other call the run keeps a fingerprint, the norm of its gradient, and each
gradient gap reads the least value that norm allows: ||g - g_ref|| is at
least | ||g|| - ||g_ref|| |, and max |g - g_ref| at least that over the
square root of the gradient's size.  A value that is not finite is an
infinite gap.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def norm(g: torch.Tensor) -> torch.Tensor:
    """The gradient's norm, in float64 on its device: a call's fingerprint."""
    return torch.linalg.vector_norm(g, dtype=torch.float64)


class Reference:
    """A pair's JOD and gradient from the reference, and what the gaps
    divide by."""

    def __init__(self, jod: float, grad: torch.Tensor):
        self.jod = jod
        self.grad = grad
        self.norm = float(norm(grad))
        self.max = float(grad.abs().max())
        self.size = grad.numel()


def full_gaps(g: torch.Tensor, ref: Reference) -> Tuple[float, float]:
    """(grad_gap, grad_max_gap) of a whole gradient; infinite where the
    shapes differ."""
    if g is None or g.shape != ref.grad.shape:
        return math.inf, math.inf
    d = g.float() - ref.grad
    return (_finite(float(norm(d)) / max(ref.norm, 1e-300)),
            _finite(float(d.abs().max()) / max(ref.max, 1e-300)))


def norm_gaps(n: float, ref: Reference) -> Tuple[float, float]:
    """The least (grad_gap, grad_max_gap) a gradient of norm ``n`` can have."""
    d = abs(n - ref.norm)
    return (_finite(d / max(ref.norm, 1e-300)),
            _finite(d / (math.sqrt(ref.size) * max(ref.max, 1e-300))))


def call_gaps(calls: List[Tuple[int, float, float]], ref: Dict[int, Reference],
              kept: Dict[int, torch.Tensor]) -> List[Dict[str, float]]:
    """calls: (pair, JOD, gradient norm) of every call in order; ref: pair ->
    its :class:`Reference`; kept: pair -> the gradient of its last call."""
    last = {k: i for i, (k, _, _) in enumerate(calls)}
    out = []
    for i, (k, j, n) in enumerate(calls):
        r = ref[k]
        g, gm = full_gaps(kept.get(k), r) if last[k] == i else norm_gaps(n, r)
        out.append({"jod_gap": _finite(abs(j - r.jod)), "grad_gap": g, "grad_max_gap": gm})
    return out
