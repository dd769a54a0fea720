// Gaussian-pyramid expansion of one coarse tile (device functions), shared
// by band_pipeline.cu (expand + score) and expand_contrast.cu (expand +
// Weber contrast, written out).
//
// The expansion follows fovvideovdp_tpu/ops/pyramid.py:gausspyr_expand: the
// zero-interleaved buffer holds x[i] at 2i+2, x[0] at 0 and x[m-1] at 2m+2,
// so along each axis it is a polyphase filter over x extended by one
// replicated sample at each end: even outputs take taps 0, 2, 4, odd ones
// taps 1, 3 (each times 2), summed in that order without FMA contraction,
// vertical pass first, as the plain version does.  The TPU kernels' banded
// matmuls, zero-padded coarse copy and masked edge adds exist for Mosaic and
// have no counterpart here: the window is the coarse tile with clamped
// indices, and no edge branch remains.
//
// A block owns a 16 x 64 fine tile of one frame.  It stages the
// replicate-extended C-channel coarse window (10 x 34) in shared memory and
// expands it vertically into shared memory (16 x 34 per channel); each
// thread then expands horizontally for its own pixels.
#pragma once

#include <cuda_runtime.h>

#include "score_math.cuh"

namespace fvvdp {

constexpr int kTileW = 64;                 // fine columns per block
constexpr int kTileH = 16;                 // fine rows per block
constexpr int kCoarseW = kTileW / 2 + 2;   // replicate-extended coarse window
constexpr int kCoarseH = kTileH / 2 + 2;
constexpr int kTileThreads = 256;
constexpr int kRowsPerPass = kTileThreads / kTileW;

// 2 * K5[k] * x, rounded as the plain version's (gain * K5[k]) * z
__device__ __forceinline__ float tap2(int k, float x) {
    return __fmul_rn(2.0f * k5(k), x);
}

// one output of the polyphase expansion; v points at the window sample
// that holds x[out/2 - 1] (even out) or x[(out+1)/2 - 1] (odd out)
__device__ __forceinline__ float expand_even(const float* v, int stride) {
    return __fadd_rn(__fadd_rn(tap2(0, v[0]), tap2(2, v[stride])), tap2(4, v[2 * stride]));
}
__device__ __forceinline__ float expand_odd(const float* v, int stride) {
    return __fadd_rn(tap2(1, v[0]), tap2(3, v[stride]));
}

// Stage the coarse window of the tile at fine (r0, c0) and expand it
// vertically.  cbase points at this frame's coarse level (C, h2, w2).
// Ends with a __syncthreads(): s_v is ready for every thread.
template <int C>
__device__ __forceinline__ void expand_tile_vertical(
        const float* __restrict__ cbase, int h2, int w2, int r0, int c0, int tid,
        float (&s_c)[C][kCoarseH][kCoarseW], float (&s_v)[C][kTileH][kCoarseW + 1]) {
    // coarse window: extended index i in [-1, m] maps to x[clamp(i, 0, m-1)]
    const int cr0 = r0 / 2 - 1, cc0 = c0 / 2 - 1;
    for (int i = tid; i < C * kCoarseH * kCoarseW; i += kTileThreads) {
        const int ch = i / (kCoarseH * kCoarseW);
        const int rem = i % (kCoarseH * kCoarseW);
        const int rr = rem / kCoarseW, cc = rem % kCoarseW;
        const int gy = min(max(cr0 + rr, 0), h2 - 1);
        const int gx = min(max(cc0 + cc, 0), w2 - 1);
        s_c[ch][rr][cc] = cbase[((size_t)ch * h2 + gy) * w2 + gx];
    }
    __syncthreads();

    // vertical expansion of the window's columns for the tile's 16 rows
    for (int i = tid; i < C * kTileH * kCoarseW; i += kTileThreads) {
        const int ch = i / (kTileH * kCoarseW);
        const int rem = i % (kTileH * kCoarseW);
        const int lr = rem / kCoarseW, cc = rem % kCoarseW;
        s_v[ch][lr][cc] = (lr & 1) ? expand_odd(&s_c[ch][(lr + 1) >> 1][cc], kCoarseW)
                                   : expand_even(&s_c[ch][lr >> 1][cc], kCoarseW);
    }
    __syncthreads();
}

// horizontal expansion: the value at local column lc of one vertically
// expanded row (row points at s_v[ch][lr][0])
__device__ __forceinline__ float expand_tile_horizontal(const float* row, int lc) {
    return (lc & 1) ? expand_odd(row + ((lc + 1) >> 1), 1) : expand_even(row + (lc >> 1), 1);
}

inline dim3 tile_grid(int F, int H, int W) {
    return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, F);
}

}  // namespace fvvdp
