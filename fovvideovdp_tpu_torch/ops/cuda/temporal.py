"""Temporal channels of a test/reference pair: wrapper of
``csrc/temporal.cu`` and its plain version.

Replaces the TPU kernels ``fovvideovdp_tpu/ops/pallas/temporal.py``
``_temporal_kernel_pair`` and, with an empty carry, ``_temporal_kernel``.
The plain version mirrors ``_temporal_pair_jnp``: filter the concatenated
window with ``ops.temporal.apply_temporal_filters``.
"""
from __future__ import annotations

import torch

from fovvideovdp_tpu_torch.ops.cuda import _autograd, _lib

_MAX_TAPS = 64  # kMaxTaps of csrc/temporal.cu


def temporal_pair_plain(carry_t, new_t, carry_r, new_r, taps: torch.Tensor) -> torch.Tensor:
    from fovvideovdp_tpu_torch.ops.temporal import apply_temporal_filters
    taps_np = taps.detach().cpu().numpy()
    Rt = apply_temporal_filters(torch.cat([carry_t, new_t], dim=0), taps_np)
    Rr = apply_temporal_filters(torch.cat([carry_r, new_r], dim=0), taps_np)
    return torch.stack([Rt[:, 0], Rr[:, 0], Rt[:, 1], Rr[:, 1]], dim=1)


@_autograd.differentiable(temporal_pair_plain, diff=(0, 1, 2, 3))
def temporal_pair(carry_t: torch.Tensor, new_t: torch.Tensor,
                  carry_r: torch.Tensor, new_r: torch.Tensor,
                  taps: torch.Tensor) -> torch.Tensor:
    """out[f, 2c+s] = sum_j taps[c, j] * x_s[f + fl-1 - j] over the window
    x_s = carry_s ++ new_s (s = test, ref; c = sustained, transient).

    carry_* (ncarry, H, W) with ncarry >= 0, new_* (B, H, W), taps (2, fl)
    float32 on the same device.  Returns (ncarry + B - fl + 1, 4, H, W).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    tensors = (("carry_t", carry_t), ("new_t", new_t), ("carry_r", carry_r),
               ("new_r", new_r), ("taps", taps))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"temporal_pair: {name} must be float32, got {t.dtype}")
        if t.device != new_t.device:
            raise ValueError(f"temporal_pair: {name} is on {t.device}, new_t on {new_t.device}")
    if new_t.dim() != 3 or new_r.shape != new_t.shape:
        raise ValueError(f"temporal_pair: new blocks must be equal (B, H, W), got "
                         f"{tuple(new_t.shape)} and {tuple(new_r.shape)}")
    if carry_t.shape != carry_r.shape or tuple(carry_t.shape[1:]) != tuple(new_t.shape[1:]) \
            or carry_t.dim() != 3:
        raise ValueError(f"temporal_pair: carries {tuple(carry_t.shape)} and "
                         f"{tuple(carry_r.shape)} do not match the block {tuple(new_t.shape)}")
    if taps.dim() != 2 or taps.shape[0] != 2 or not 1 <= taps.shape[1] <= _MAX_TAPS:
        raise ValueError(f"temporal_pair: taps must be (2, fl) with fl <= {_MAX_TAPS}, "
                         f"got {tuple(taps.shape)}")
    ncarry, nnew, fl = carry_t.shape[0], new_t.shape[0], taps.shape[1]
    n_out = ncarry + nnew - fl + 1
    if n_out < 1:
        raise ValueError(f"temporal_pair: window of {ncarry + nnew} frames is "
                         f"shorter than the {fl}-tap filter")
    if new_t.device.type == "cpu":
        return temporal_pair_plain(carry_t, new_t, carry_r, new_r, taps)
    if new_t.device.type != "cuda":
        raise RuntimeError(f"temporal_pair: unsupported device {new_t.device}")
    if not all(t.is_contiguous() for _, t in tensors):
        raise ValueError("temporal_pair needs contiguous tensors")
    H, W = new_t.shape[1], new_t.shape[2]
    out = torch.empty((n_out, 4, H, W), dtype=torch.float32, device=new_t.device)
    fn = _lib.kernel_fn("temporal_pair")
    with torch.cuda.device(new_t.device):
        rc = fn(carry_t.data_ptr(), new_t.data_ptr(), carry_r.data_ptr(),
                new_r.data_ptr(), taps.data_ptr(), out.data_ptr(), ncarry, nnew,
                fl, H * W, _lib.stream_ptr(new_t))
    _lib.check(rc, "temporal_pair")
    _lib.count_launch("temporal_pair")
    return out
