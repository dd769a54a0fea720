"""Carrying calibration state from the JAX package into this one.

``state_from_numpy`` takes the JAX metric's parameters and LUTs as plain
host data (``{k: np.asarray(lut[k]) for k in csf.LUT_FIELDS}`` for each of
``fovvideovdp_tpu.fvvdp(...)._luts``) and returns them in this package's
form; ``fvvdp.load_state`` installs them, so both packages score from
identical state: ablation settings among the parameters, and LUTs the JAX
package generated or read from a ``.mat`` cache, on whatever grid (the
uniform-grid flags are computed from the arrays).
"""
from __future__ import annotations

import numbers
from typing import Dict, Sequence, Tuple

import numpy as np

from fovvideovdp_tpu_torch import csf


def _plain(v):
    """Numbers as Python floats (numpy scalars would leak into cache keys
    and scalar kernel arguments); strings and flags unchanged."""
    if isinstance(v, (bool, np.bool_)) or not isinstance(v, numbers.Number):
        return v
    return float(v)


def state_from_numpy(parameters: Dict, luts: Sequence[Dict[str, np.ndarray]],
                     device) -> Tuple[Dict, Tuple[Dict, ...]]:
    params = {k: _plain(v) for k, v in parameters.items()}
    port_luts = tuple(
        csf.lut_from_numpy({k: np.asarray(lut[k]) for k in csf.LUT_FIELDS},
                           device)
        for lut in luts)
    return params, port_luts
