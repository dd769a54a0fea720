"""Visual masking model and norm pooling.

Counterpart of ``fovvideovdp_tpu/ops/masking.py:13-70``: the calibrated
'min_mutual_masking_perc_norm2' model (with the ``pu_dilate`` blur of the
mutual-masking signal), ``weber2log`` and the band -> channel -> frame
pooling to JOD, of one clip or of each pair of a batch.
"""
from __future__ import annotations

import torch

from fovvideovdp_tpu_torch import utils
from fovvideovdp_tpu_torch.tracing import span


def apply_masking_model(T, R, N_nCSF, p: float, q: float, mask_c: float,
                        pu_dilate: float = 0.0):
    """Masked visual difference D for one band/channel:
    D = |T/N - R/N|^p / (1 + M_pu^q), clamped to 1e4, where
    M_pu = 10^mask_c * min(|T/N|, |R/N|) when ``pu_dilate`` is 0 and
    10^mask_c times its Gaussian blur of sigma ``pu_dilate`` (replicate
    padding, as MATLAB's imgaussfilt: matlab/fvvdp_core.m:546-552)
    otherwise."""
    T = T / N_nCSF
    R = R / N_nCSF
    M = torch.minimum(torch.abs(T), torch.abs(R))
    if pu_dilate != 0.0:
        # each leading slice of M (..., h, w) blurred as one batch
        M = utils.ImGaussFilt(pu_dilate, pad_mode="edge").run(
            M.reshape((-1, 1) + M.shape[-2:])).reshape(M.shape)
    M_pu = (10.0 ** mask_c) * M
    D = torch.pow(torch.abs(T - R), p) / (1.0 + torch.pow(M_pu, q))
    return torch.clamp(D, max=1e4)


def weber2log(W):
    """Weber contrast (B - A) / A -> log contrast log10(B / A)."""
    return torch.log10(1.0 + W)


def lp_norm(x, p: float, dim=0, normalize: bool = True, keepdim: bool = True):
    """(sum |x|^p)^(1/p), optionally normalised by N^(1/p) along ``dim``."""
    N = x.shape[dim] if normalize else 1.0
    s = torch.sum(torch.pow(torch.abs(x), p), dim=dim, keepdim=keepdim)
    return torch.pow(s, 1.0 / p) / (float(N) ** (1.0 / p))


def pool_to_jod(Q_per_ch: torch.Tensor, w_transient: float, beta_sch: float,
                beta_tch: float, beta_t: float, jod_a: float,
                log_jod_exp: float) -> torch.Tensor:
    """Band -> channel -> frame pooling and the JOD regression.

    Q_per_ch: (n_bands, 2, n_frames) float32, or (n_bands, 2, N, n_frames)
    for N pairs, each pooled on its own (the JAX package ``vmap``s this
    function over pairs, ``fovvideovdp_tpu/parallel/sharding.py:359-364``).
    Returns a 0-d float32 tensor, or (N,), on Q_per_ch's device."""
    with span("fvvdp.pool"):
        w = torch.tensor([1.0, w_transient], dtype=Q_per_ch.dtype,
                         device=Q_per_ch.device).reshape((1, 2) + (1,) * (Q_per_ch.dim() - 2))
        Q_sc = lp_norm(Q_per_ch * w, beta_sch, dim=0, normalize=False)
        Q_tc = lp_norm(Q_sc, beta_tch, dim=1, normalize=False)
        Q = lp_norm(Q_tc, beta_t, dim=-1, normalize=True)
        Q = Q.reshape(Q_per_ch.shape[2:-1])

        sign = 1.0 if jod_a >= 0 else -1.0
        beta_jod = 10.0 ** log_jod_exp
        return sign * torch.pow(abs(jod_a) ** (1.0 / beta_jod) * Q, beta_jod) + 10.0
