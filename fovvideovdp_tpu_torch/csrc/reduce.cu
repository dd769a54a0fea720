// gausspyr_reduce: one Gaussian-pyramid level, (N, H, W) -> (N, ceil(H/2), ceil(W/2)).
//
// Replaces the TPU kernels fovvideovdp_tpu/ops/pallas/reduce.py
// `_reduce_kernel_nopad` (through `_gausspyr_reduce_nopad`) and
// `_reduce_kernel` (through `gausspyr_reduce_pallas`).  On the TPU the
// stride-2 filter is a pair of banded matmuls with an XLA pre-pad for the
// shapes the no-pad geometry cannot take; here it is a stencil that takes
// every shape the pyramid produces.
//
// Semantics (fovvideovdp_tpu/ops/pyramid.py:_reduce_rows/_reduce_cols):
// separable 5-tap [.05 .25 .4 .25 .05], stride 2.  Rows use symmetric edges
// (row -1 -> 0, row -2 -> 1, row H -> H-1, row H+1 -> H-2); columns are
// zero-padded and then corrected at the first and last output column, the
// last-column branch picked by the parity of the ROW count (the reference's
// quirk).  Every product and sum is rounded separately (no FMA contraction)
// in the order of the plain version, so the result equals it bit for bit.
//
// Bound on this card: memory bytes (each input read once, each output
// written once; ~1.7 flop per byte).  Design: each thread owns 4 adjacent
// input columns, read as one 16-byte load per row (the vector arm) or four
// masked 4-byte loads (the scalar arm: a width off a multiple of 4 or an
// input off a 16-byte boundary), and walks down a strip of output rows.  It
// keeps the 5-row vertical window in registers and reads 2 new rows per
// output row, issued before this row's arithmetic.  The horizontal pass
// takes the 3 neighbouring columns it needs from the lanes beside it by
// warp shuffles, so no shared memory and no barrier: a warp covers 128
// columns of which lanes 1..30 write outputs and lanes 0 and 31 only supply
// the halo (the neighbouring warps' edge columns, read twice, mostly from
// L1/L2).  Each writing lane stores its 2 outputs as one 8-byte store.  The
// row mirror is index arithmetic on the row; the zero columns are a
// predicate on the load.  Planes, strips and column blocks share grid.x, so
// the plane count has no grid limit.
//
// The launch plan (arm, warps per block, strip height, grid) is decided in
// Python (ops/cuda/reduce.py:launch_plan); the entry point refuses a plan
// that contradicts its arguments.
#include <climits>
#include <cuda_runtime.h>

#include "score_math.cuh"

namespace {

constexpr int kLanesOut = 30;       // lanes of a warp that write outputs
constexpr int kMaxWarps = 4;        // warps per block
constexpr int kMinBlocksPerSM = 8;

struct Cols4 {
    float v[4];
};

__device__ __forceinline__ int mirror_row(int y, int H) {
    y = y < 0 ? -y - 1 : y;
    return y >= H ? 2 * H - 1 - y : y;
}

// Four input columns col..col+3 of one row; 0 outside [0, W).
template <bool kVec>
__device__ __forceinline__ Cols4 load4(const float* __restrict__ row, int col, int W) {
    Cols4 c;
    if (kVec) {
        // W % 4 == 0: a group of four lies wholly inside or wholly outside
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (col >= 0 && col < W) f = __ldg(reinterpret_cast<const float4*>(row + col));
        c.v[0] = f.x;
        c.v[1] = f.y;
        c.v[2] = f.z;
        c.v[3] = f.w;
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            c.v[i] = (col + i >= 0 && col + i < W) ? __ldg(row + col + i) : 0.0f;
    }
    return c;
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocksPerSM)
reduce_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W, int Ho,
              int Wo, int strip_rows, int col_blocks, int strips) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x;
    const int cb = b % col_blocks;
    const int strip = (b / col_blocks) % strips;
    const size_t plane = static_cast<size_t>(b / col_blocks / strips);

    // group of 4 input columns this lane reads; lanes 0 and 31 are the halo
    const int gw = cb * (blockDim.x >> 5) + warp;
    const int g = kLanesOut * gw + lane - 1;
    if (4 * (kLanesOut * gw) >= W) return;   // the whole warp lies past the width
    const int col = 4 * g;
    const bool writes = lane >= 1 && lane <= kLanesOut && 2 * g < Wo;

    const int r0 = strip * strip_rows;
    const int r1 = min(r0 + strip_rows, Ho);
    const float* xp = x + plane * H * W;
    float* yp = y + plane * Ho * Wo;

    // last-column correction: the local indices (in vv below) of columns W-1
    // and W-2, which depend on W mod 4 only
    const int m = W & 3;
    const int i_last = m == 0 ? 5 : m + 1;

    // rows 2r-2 .. 2r+2 of output row r = r0
    Cols4 w0 = load4<kVec>(xp + static_cast<size_t>(mirror_row(2 * r0 - 2, H)) * W, col, W);
    Cols4 w1 = load4<kVec>(xp + static_cast<size_t>(mirror_row(2 * r0 - 1, H)) * W, col, W);
    Cols4 w2 = load4<kVec>(xp + static_cast<size_t>(mirror_row(2 * r0, H)) * W, col, W);
    Cols4 w3 = load4<kVec>(xp + static_cast<size_t>(mirror_row(2 * r0 + 1, H)) * W, col, W);
    Cols4 w4 = load4<kVec>(xp + static_cast<size_t>(mirror_row(2 * r0 + 2, H)) * W, col, W);

    for (int r = r0; r < r1; ++r) {
        // the next output row's two new input rows, in flight during this row
        Cols4 n3 = {}, n4 = {};
        if (r + 1 < r1) {
            n3 = load4<kVec>(xp + static_cast<size_t>(mirror_row(2 * r + 3, H)) * W, col, W);
            n4 = load4<kVec>(xp + static_cast<size_t>(mirror_row(2 * r + 4, H)) * W, col, W);
        }

        // vertical: y_a = sum_k K5[k] * x[2r + k - 2], k ascending
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float a = __fmul_rn(fvvdp::k5(0), w0.v[i]);
            a = __fadd_rn(a, __fmul_rn(fvvdp::k5(1), w1.v[i]));
            a = __fadd_rn(a, __fmul_rn(fvvdp::k5(2), w2.v[i]));
            a = __fadd_rn(a, __fmul_rn(fvvdp::k5(3), w3.v[i]));
            v[i] = __fadd_rn(a, __fmul_rn(fvvdp::k5(4), w4.v[i]));
        }

        // columns col-2 .. col+4 of y_a: two from the lane to the left, one
        // from the lane to the right
        float vv[7];
        vv[0] = __shfl_up_sync(0xffffffffu, v[2], 1);
        vv[1] = __shfl_up_sync(0xffffffffu, v[3], 1);
        vv[2] = v[0];
        vv[3] = v[1];
        vv[4] = v[2];
        vv[5] = v[3];
        vv[6] = __shfl_down_sync(0xffffffffu, v[0], 1);

        if (writes) {
            // horizontal: y[j] = sum_k K5[k] * y_a[2j + k - 2] (zero outside),
            // j = 2g + jj, then the boundary corrections
            float o[2];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                float a = __fmul_rn(fvvdp::k5(0), vv[2 * jj]);
#pragma unroll
                for (int k = 1; k < 5; ++k)
                    a = __fadd_rn(a, __fmul_rn(fvvdp::k5(k), vv[2 * jj + k]));
                const int j = 2 * g + jj;
                if (j == 0)
                    a = __fadd_rn(a, __fadd_rn(__fmul_rn(vv[2], fvvdp::k5(1)),
                                               __fmul_rn(vv[3], fvvdp::k5(0))));
                if (j == Wo - 1) {
                    float vl1, vl2;   // y_a[W-1], y_a[W-2]
                    switch (i_last) {
                        case 2: vl1 = vv[2]; vl2 = vv[1]; break;
                        case 3: vl1 = vv[3]; vl2 = vv[2]; break;
                        case 4: vl1 = vv[4]; vl2 = vv[3]; break;
                        default: vl1 = vv[5]; vl2 = vv[4]; break;
                    }
                    if (H % 2 == 1)
                        a = __fadd_rn(a, __fadd_rn(__fmul_rn(vl1, fvvdp::k5(3)),
                                                   __fmul_rn(vl2, fvvdp::k5(4))));
                    else
                        a = __fadd_rn(a, __fmul_rn(vl1, fvvdp::k5(4)));
                }
                o[jj] = a;
            }
            float* out = yp + static_cast<size_t>(r) * Wo + 2 * g;
            if (kVec) {
                // Wo is even on this arm, so both outputs exist
                *reinterpret_cast<float2*>(out) = make_float2(o[0], o[1]);
            } else {
                out[0] = o[0];
                if (2 * g + 1 < Wo) out[1] = o[1];
            }
        }

        w0 = w2;
        w1 = w3;
        w2 = w4;
        w3 = n3;
        w4 = n4;
    }
}

// The plan fits the arguments: the arm's alignment, blocks of 1..4 warps, the
// column blocks cover the width with no block past it, the strips cover the
// output rows, and the grid fits grid.x.
bool plan_fits(const float* x, const float* y, int N, int H, int W, int vec,
               int warps_per_block, int strip_rows, int col_blocks, int strips) {
    if (N < 1 || H < 2 || W < 2) return false;
    const int Ho = (H + 1) / 2;
    const int groups = (W + 3) / 4;
    const int warps = (groups + kLanesOut - 1) / kLanesOut;
    if (warps_per_block < 1 || warps_per_block > kMaxWarps) return false;
    if (col_blocks != (warps + warps_per_block - 1) / warps_per_block) return false;
    if (strip_rows < 1 || strips != (Ho + strip_rows - 1) / strip_rows) return false;
    if (static_cast<long long>(N) * strips * col_blocks > INT_MAX) return false;
    if (vec && (W % 4 != 0 || reinterpret_cast<size_t>(x) % 16 != 0 ||
                reinterpret_cast<size_t>(y) % 8 != 0))
        return false;
    return true;
}

}  // namespace

// x (N, H, W) and y (N, ceil(H/2), ceil(W/2)), both contiguous.  The plan
// arguments (vec, warps_per_block, strip_rows, col_blocks, strips) are the
// caller's launch plan (ops/cuda/reduce.py:launch_plan); a plan that does not
// fit the arguments is refused with cudaErrorInvalidValue.
extern "C" int fvvdp_gausspyr_reduce(const float* x, float* y, int N, int H, int W, int vec,
                                     int warps_per_block, int strip_rows, int col_blocks,
                                     int strips, cudaStream_t stream) {
    if (!plan_fits(x, y, N, H, W, vec, warps_per_block, strip_rows, col_blocks, strips))
        return static_cast<int>(cudaErrorInvalidValue);
    const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
    const dim3 grid(N * strips * col_blocks);
    const dim3 block(32 * warps_per_block);
    if (vec)
        reduce_kernel<true><<<grid, block, 0, stream>>>(x, y, H, W, Ho, Wo, strip_rows,
                                                        col_blocks, strips);
    else
        reduce_kernel<false><<<grid, block, 0, stream>>>(x, y, H, W, Ho, Wo, strip_rows,
                                                         col_blocks, strips);
    return static_cast<int>(cudaGetLastError());
}
