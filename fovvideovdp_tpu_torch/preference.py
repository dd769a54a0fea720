"""JOD differences -> preference probabilities.

Counterpart of ``fovvideovdp_tpu/preference.py`` (the MATLAB helper
matlab/fvvdp_preference.m:17-21): under the JOD definition, a 1-JOD quality
difference corresponds to 75%/25% preference in a pairwise comparison.
"""
from __future__ import annotations

import numpy as np
import torch

# standard deviation of the JOD preference mapping: the probit slope for
# which delta JOD = 1 gives 75 % preference
_SIGMA_JOD = 1.4826


def fvvdp_preference(jod_diff) -> torch.Tensor:
    """Probability (in %) that content A is preferred over B given
    ``jod_diff = JOD_A - JOD_B`` (a number, an array or a tensor)."""
    x = jod_diff if torch.is_tensor(jod_diff) else \
        torch.as_tensor(np.asarray(jod_diff, dtype=np.float32))
    return torch.special.ndtr(x / _SIGMA_JOD) * 100.0
