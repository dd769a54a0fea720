"""Batch scoring on one card.

Counterpart of ``make_batch_scorer`` and ``make_batch_video_scorer``
(``fovvideovdp_tpu/parallel/sharding.py:328-494``), under the same names.
Where the JAX package builds a scorer over a mesh, each function here scores
a batch on the ``torch.device`` of the :class:`MetricCore` it is given.
Pairs never talk to each other, so a chunk of pairs is a block of
independent frames to every kernel: one launch per pyramid level serves the
chunk.  ``make_mesh``, the ``shard_*`` functions and ``multihost.py`` are not
ported yet (ROADMAP queue 1 item 7).

Both read their pairs from a :class:`video_source.PairBatch` (or any object
with its ``shape`` and ``luminance(start, count, frames=None)``) a chunk at
a time; the caller sizes the chunks from the card's free memory.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fovvideovdp_tpu_torch.core import MetricCore
from fovvideovdp_tpu_torch.ops import masking as mask_ops
from fovvideovdp_tpu_torch.ops import temporal as temporal_ops


def _pool_pairs(Q: torch.Tensor, pool_params: Dict) -> torch.Tensor:
    """(n_bands, 2, N, F) -> (N,) JODs, each pair pooled on its own."""
    return mask_ops.pool_to_jod(
        Q, float(pool_params["w_transient"]), float(pool_params["beta_sch"]),
        float(pool_params["beta_tch"]), float(pool_params["beta_t"]),
        float(pool_params["jod_a"]), float(pool_params["log_jod_exp"]))


def make_batch_scorer(core: MetricCore, pairs, chunk: int, pool_params: Dict,
                      fov_tables=None, gaze: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) JODs of a batch of image pairs: ``chunk`` pairs at a time become
    ``R (chunk, 2, H, W)``, scored as images by ``core.score_frame_pairs``
    and pooled pair by pair.  A foveated core takes either ``fov_tables``,
    one fixation point's tables shared by every pair (``core.fov_tables``),
    or ``gaze``, an (N, 2) tensor with one fixation point per pair (the
    moving-gaze route)."""
    Q = core.score_frame_pairs(
        lambda start, count: tuple(x[:, 0] for x in pairs.luminance(start, count)),
        pairs.shape[0], chunk, fov_tables, gaze)
    return _pool_pairs(Q[:, :, :, None], pool_params)


def make_batch_video_scorer(core: MetricCore, pairs, filt: np.ndarray, pool_params: Dict,
                            chunk: int, block: int, temp_padding: str = "replicate",
                            fov_tables=None, gaze: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(JODs (N,), Q_per_ch (n_bands, 2, N, F)) of a batch of clip pairs,
    with the temporal filters ``filt`` (2, fl) and the clips padded by
    ``temp_padding``.  With ``chunk`` > 0, each clip's padded frames are
    filtered at once (``temporal_pair`` with an empty carry) into its slice
    of the chunk's responses, which are scored in one call.  With ``chunk``
    = 0 (a clip's window does not fit the card), each clip streams ``block``
    frames at a time with its carry (``core.score_video``).  ``gaze``: an
    (N, F, 2) tensor, one row per output frame of each clip, in place of
    ``fov_tables``."""
    device = core.device
    taps = torch.as_tensor(filt, device=device)
    N, _, F, H, W = pairs.shape
    pad_idx = temporal_ops.padding_indices(F, filt.shape[1], temp_padding)
    Q = torch.empty((core.plan.height, 2, N, F), dtype=torch.float32, device=device)
    if chunk > 0:
        idx = torch.as_tensor(pad_idx, dtype=torch.int64, device=device)
        empty = torch.empty((0, H, W), dtype=torch.float32, device=device)
        for pos in range(0, N, chunk):
            n = min(chunk, N - pos)
            lum_t, lum_r = pairs.luminance(pos, n)
            R = torch.empty((n * F, 4, H, W), dtype=torch.float32, device=device)
            for i in range(n):
                temporal_ops.temporal_channels_pair(empty, lum_t[i][idx], empty, lum_r[i][idx],
                                                    taps, out=R[i * F:(i + 1) * F])
            del lum_t, lum_r
            Q_chunk, _ = core.score_frames(
                R, 2, fov_tables, None if gaze is None else gaze[pos:pos + n].reshape(-1, 2))
            del R
            Q[:, :, pos:pos + n] = Q_chunk.reshape(-1, 2, n, F)
    else:
        for i in range(N):
            def frames(sel, i=i):
                t, r = pairs.luminance(i, 1, sel)
                return t[0], r[0]
            Q[:, :, i] = core.score_video(
                lambda start, count: frames(slice(start, start + count)), frames,
                F, taps, pad_idx, block, fov_tables, None if gaze is None else gaze[i])
    return _pool_pairs(Q, pool_params), Q
