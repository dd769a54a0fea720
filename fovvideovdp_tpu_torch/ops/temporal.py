"""Temporal channels: sustained / transient filters, padding and the
blockwise temporal filter.

Counterpart of ``fovvideovdp_tpu/ops/temporal.py:21-99,111-207``.  The
filter design and padding indices are host-side numpy identical to the JAX
package's; the filter itself runs through the CUDA kernel on the card
(``ops/cuda/temporal.py``) and through its plain version on the CPU.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

# temporal channels of a test/reference pair over carry ++ new block:
# the CUDA kernel on the card, its plain version on the CPU
from fovvideovdp_tpu_torch.ops.cuda.temporal import temporal_pair as temporal_channels_pair  # noqa: F401


def filter_len_for_fps(fps: float) -> int:
    """250 ms of video, rounded up, and at least 2 taps (the transient
    filter is a finite difference over the window)."""
    if fps <= 0:
        raise RuntimeError("frames_per_second must be positive for video")
    return max(2, int(np.ceil(250.0 / (1000.0 / fps))))


def temporal_filters(fps: float, filter_len: int, sustained_sigma: float = 0.5,
                     sustained_beta: float = 0.06) -> np.ndarray:
    """Sustained (log-Gaussian) and transient (scaled derivative) filters.

    Keeps the reference's time-axis quirk: t spans [0, fl/fps] inclusive
    over fl points, so dt = fl/(fps*(fl-1)).  Returns (2, filter_len)
    float32, F[0] sum-normalised.
    """
    t = np.linspace(0.0, filter_len / fps, filter_len)
    F = np.zeros((2, filter_len))
    F[0] = np.exp(-(np.log(t + 1e-4) - np.log(sustained_beta)) ** 2
                  / (2.0 * sustained_sigma ** 2))
    F[0] = F[0] / np.sum(F[0])

    k2 = 0.062170507756932
    Fdiff = F[0, 1:] - F[0, :-1]
    F[1] = k2 * np.concatenate([Fdiff / (t[1] - t[0]), [0.0]])
    return F.astype(np.float32)


def padding_indices(n_frames: int, filter_len: int, mode: str) -> np.ndarray:
    """Frame indices of the padded sequence (length n_frames + filter_len - 1)
    whose sliding windows replicate the reference's warm-up buffers.

    'circular' keeps the reference's off-by-one: frame 0's window is frames
    [(N-1-fl) .. (N-2)] mod N, without frame 0 itself.
    """
    fl, N = filter_len, n_frames
    if mode == "replicate":
        idx = [0] * (fl - 1) + list(range(N))
    elif mode == "circular":
        idx = [(N - 1 - fl + kk) % N for kk in range(fl)] + list(range(1, N))
    elif mode == "pingpong":
        pingpong = list(range(N)) + list(range(N - 2, 0, -1))
        ind: List[int] = []
        while len(ind) < fl - 1:
            ind = ind + pingpong
        idx = ind[-(fl - 1):] + [0] + list(range(1, N))
    else:
        raise RuntimeError(f'Unknown padding method "{mode}"')
    return np.asarray(idx, dtype=np.int32)


def temporal_channels(padded_t: torch.Tensor, padded_r: torch.Tensor, F) -> torch.Tensor:
    """Temporal channels of a test/reference pair: padded_t, padded_r
    (F_out + fl - 1, H, W), F the (2, fl) filters.  Returns (F_out, 4, H, W)
    ordered [T-sust, R-sust, T-trans, R-trans] (pyfvvdp/fvvdp.py:293): the
    temporal kernel with an empty carry on the card, its plain version on
    the CPU."""
    empty = padded_t[:0]
    taps = torch.as_tensor(np.asarray(F, dtype=np.float32), device=padded_t.device)
    return temporal_channels_pair(empty, padded_t, empty, padded_r, taps)


def apply_temporal_filters(padded: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Causal temporal filtering of a padded frame sequence (plain version).

    padded: (F_out + fl - 1, ...) frames; taps: (n_ch, fl) numpy filters.
    Returns (F_out, n_ch, ...): out[f, c] = sum_j taps[c, j] * padded[f + fl-1 - j],
    summed in increasing j with zero taps skipped, the order of the TPU
    kernel's ``_accumulate_taps``.
    """
    fl = taps.shape[1]
    n_out = padded.shape[0] - fl + 1
    outs = []
    for c in range(taps.shape[0]):
        acc = None
        for j in range(fl):
            w = float(taps[c, j])
            if w == 0.0:
                continue
            term = w * padded[fl - 1 - j: fl - 1 - j + n_out]
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else torch.zeros_like(padded[:n_out]))
    return torch.stack(outs, dim=1)
