"""The comparison that decides ``correct``: what the timed calls returned
against the plain reference (``reference/fvvdp_plain.py``) on the same
raw frames and gaze.

Numbers compared, each against its limit in ``limits/<workload>.json``:

* ``jod_gap``: the largest |JOD - JOD_ref| over every call of the window
  (clips), or over every pair of every call (image sets);
* ``q_gap`` (clips): the largest |Q_per_ch - Q_ref| over every band,
  channel and frame of every call, over the largest |Q_ref| of the pair.

A value that is not finite is an infinite gap.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def _gap(a, b) -> float:
    g = float(np.max(np.abs(np.asarray(a, np.float64) - b))) if np.shape(a) == np.shape(b) \
        else math.inf
    return g if math.isfinite(g) else math.inf


def clip_call_gaps(calls: List[Tuple[int, float, np.ndarray]],
                   ref: Dict[int, Tuple[float, np.ndarray]]) -> List[Dict[str, float]]:
    """calls: (pair, JOD, Q_per_ch) of every call; ref: pair -> (JOD, Q)."""
    out = []
    for k, j, Q in calls:
        jr, Qr = ref[k]
        out.append({"jod_gap": _gap(j, jr),
                    "q_gap": _gap(Q, Qr) / max(float(np.max(np.abs(Qr))), 1e-30)})
    return out


def batch_call_gaps(calls: List[np.ndarray], ref: np.ndarray) -> List[Dict[str, float]]:
    """calls: the JODs (N,) of every call; ref: the reference's (N,)."""
    return [{"jod_gap": _gap(j, ref)} for j in calls]


def judge(per_call: List[Dict[str, float]], limits: Dict[str, float]
          ) -> Tuple[bool, int, Dict[str, Dict]]:
    """(correct, the calls over a limit, {name: {"value": the largest gap,
    "limit"}}).  No call at all is not correct."""
    failed = sum(any(g[k] > limits[k] for k in limits) for g in per_call)
    worst = {k: max([g[k] for g in per_call], default=math.inf) for k in limits}
    return bool(per_call) and failed == 0, failed, \
        {k: {"value": worst[k], "limit": limits[k]} for k in limits}
