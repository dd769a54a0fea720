"""Gaussian-pyramid reduce: wrapper of ``csrc/reduce.cu`` and its plain
version.

Replaces the TPU kernels ``fovvideovdp_tpu/ops/pallas/reduce.py``
``_reduce_kernel_nopad`` and ``_reduce_kernel``.  The kernel equals the
plain version bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fovvideovdp_tpu_torch.ops.cuda import _autograd, _lib
from fovvideovdp_tpu_torch.ops.pyramid import _gausspyr_reduce_plain as gausspyr_reduce_plain
from fovvideovdp_tpu_torch.ops.pyramid import ceildiv

# csrc/reduce.cu: lanes of a warp that write outputs (lanes 0 and 31 read the
# halo), 4 input columns per lane, at most 4 warps per block
LANES_OUT = 30
COLS_PER_LANE = 4
MAX_WARPS = 4
# output rows a block walks down, the tallest first; a shorter strip only
# where the taller one leaves the card short of one wave of blocks
STRIP_ROWS = (32, 16, 8)
# one wave: 8 blocks of 128 threads on each of the 132 SMs
FILL_BLOCKS = 1056
MAX_GRID_X = 2**31 - 1


class LaunchPlan(NamedTuple):
    """How one reduce is launched: the arm (16-byte loads, or 4-byte loads
    each masked), warps per block, output rows per strip, and the grid
    (column blocks x strips x planes, all on grid.x)."""
    vec: bool
    warps_per_block: int
    strip_rows: int
    col_blocks: int
    strips: int

    @property
    def threads(self) -> int:
        return 32 * self.warps_per_block


def launch_plan(N: int, H: int, W: int, x_ptr: int, y_ptr: int) -> LaunchPlan:
    """The plan for N planes of H x W.  The vector arm needs W a multiple of
    4 and the input on a 16-byte boundary (the output on an 8-byte one)."""
    vec = W % 4 == 0 and x_ptr % 16 == 0 and y_ptr % 8 == 0
    warps = ceildiv(ceildiv(W, COLS_PER_LANE), LANES_OUT)
    wpb = min(MAX_WARPS, warps)
    col_blocks = ceildiv(warps, wpb)
    Ho = ceildiv(H, 2)
    S = next((s for s in STRIP_ROWS if N * col_blocks * ceildiv(Ho, s) >= FILL_BLOCKS),
             STRIP_ROWS[-1])
    plan = LaunchPlan(vec, wpb, S, col_blocks, ceildiv(Ho, S))
    if N * plan.strips * col_blocks > MAX_GRID_X:
        raise ValueError(f"gausspyr_reduce: {N} planes of {H} x {W} need more than "
                         f"{MAX_GRID_X} blocks")
    return plan


def plan_for(x: torch.Tensor, y: torch.Tensor) -> LaunchPlan:
    """The plan for input x (..., H, W) and output y; reads shapes and
    addresses only, on any device."""
    H, W = x.shape[-2], x.shape[-1]
    return launch_plan(x.numel() // (H * W), H, W, x.data_ptr(), y.data_ptr())


# bytes the plain version's autograd graph keeps per frame, as a multiple of
# one frame of its inputs (_autograd.KernelOp): it saves nothing (its
# operations are linear), but its forward and backward each hold about three
# copies of the input
GRAPH_BYTES = 4.0


@_autograd.differentiable(gausspyr_reduce_plain, diff=(0,), framed=(0,), graph_bytes=GRAPH_BYTES)
def gausspyr_reduce(x: torch.Tensor) -> torch.Tensor:
    """One pyramid level, (..., H, W) -> (..., ceil(H/2), ceil(W/2)).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if x.dtype != torch.float32:
        raise TypeError(f"gausspyr_reduce takes float32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] < 2 or x.shape[-1] < 2:
        raise ValueError(f"gausspyr_reduce needs H >= 2 and W >= 2, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return gausspyr_reduce_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"gausspyr_reduce: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("gausspyr_reduce needs a contiguous tensor")
    H, W = x.shape[-2], x.shape[-1]
    y = torch.empty(x.shape[:-2] + (ceildiv(H, 2), ceildiv(W, 2)),
                    dtype=torch.float32, device=x.device)
    plan = plan_for(x, y)
    fn = _lib.kernel_fn("gausspyr_reduce")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), x.numel() // (H * W), H, W, int(plan.vec),
                *plan[1:], _lib.stream_ptr(x))
    _lib.check(rc, "gausspyr_reduce")
    _lib.count_launch("gausspyr_reduce")
    return y
