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
// Two designs share the taps:
//  - expand_contrast.cu: a block owns a 16 x 64 fine tile of one frame.  It
//    stages the replicate-extended C-channel coarse window (10 x 34) in
//    shared memory and expands it vertically into shared memory (16 x 34 per
//    channel); each thread then expands horizontally for its own pixels
//    (expand_tile_vertical, expand_tile_horizontal).
//  - band_pipeline.cu: a block owns a 16 x 128 fine tile and every thread a
//    2 x 4 patch of it (rows 2i, 2i+1, columns 4j .. 4j+3).  The block stages
//    the coarse window (10 x 66, rows padded to 68 floats so that a thread's
//    8-byte reads are aligned) once; a thread reads the 3 x 4 samples its
//    patch depends on and expands them in registers, vertically then
//    horizontally (expand_patch).  No second shared array, 1.5 shared loads
//    per pixel and channel where the first design makes 10 of 4 bytes.  The
//    block walks the frames of its tile, and the window of the next frame
//    arrives by asynchronous copies while it scores the current one
//    (window_map, stage_window_async).
#pragma once

#include <cuda_pipeline.h>
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

// ---------------------------------------------------------------------------
// 2 x 4 patches expanded in registers (band_pipeline.cu)
// ---------------------------------------------------------------------------

constexpr int kPatchTileW = 128;                // fine columns per block
constexpr int kPatchTileH = 16;                 // fine rows per block
constexpr int kWinW = kPatchTileW / 2 + 2;      // replicate-extended coarse window
constexpr int kWinH = kPatchTileH / 2 + 2;
constexpr int kWinPitch = kWinW + 2;            // floats per row: a multiple of 4
static_assert(kTileThreads == (kPatchTileW / 4) * (kPatchTileH / 2),
              "one 2 x 4 patch per thread");
static_assert(kTileThreads == 4 * (kWinW - 2), "window_map's 64 x 4 thread map");

// Where a thread reads and writes when the block stages a coarse window:
// threads form 64 columns x 4 rows; a thread copies column x of window rows
// ty, ty + 4 and ty + 8 (the last exists for ty < 2) of every channel, and
// lanes x < 2 also columns 64 and 65.  Extended index i in [-1, m] maps to
// x[clamp(i, 0, m-1)].  The map depends on the tile only, not on the frame.
struct WindowMap {
    int x, ty;
    int src[3];      // offset of (row, column x) in a coarse plane, per window row
    int tail;        // offset from column x to column 64 + x
};

__device__ __forceinline__ WindowMap window_map(int h2, int w2, int r0, int c0, int tid) {
    WindowMap m;
    m.x = tid & 63;
    m.ty = tid >> 6;
    const int cr0 = r0 / 2 - 1, cc0 = c0 / 2 - 1;
    const int gx = min(max(cc0 + m.x, 0), w2 - 1);
    m.tail = min(cc0 + 64 + m.x, w2 - 1) - gx;
#pragma unroll
    for (int k = 0; k < 3; ++k)
        m.src[k] = min(max(cr0 + m.ty + 4 * k, 0), h2 - 1) * w2 + gx;
    return m;
}

// Start the copy of one frame's C-channel coarse window into s_w with 4-byte
// asynchronous copies (no register holds the data, so the copy overlaps the
// arithmetic that follows); cbase points at the frame's coarse level
// (C, h2, w2).  The caller commits, waits and places the barrier.
template <int C>
__device__ __forceinline__ void stage_window_async(
        const WindowMap& m, const float* __restrict__ cbase, int plane,
        float (&s_w)[C][kWinH][kWinPitch]) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int rr = m.ty + 4 * k;
            if (rr < kWinH) {
                const float* src = cbase + (size_t)ch * plane + m.src[k];
                __pipeline_memcpy_async(&s_w[ch][rr][m.x], src, sizeof(float));
                if (m.x < 2)
                    __pipeline_memcpy_async(&s_w[ch][rr][64 + m.x], src + m.tail,
                                            sizeof(float));
            }
        }
    }
}

// one fine row of a patch from four vertically expanded window samples
__device__ __forceinline__ void expand_patch_row(const float (&v)[4], float (&out)[4]) {
    out[0] = __fadd_rn(__fadd_rn(tap2(0, v[0]), tap2(2, v[1])), tap2(4, v[2]));
    out[1] = __fadd_rn(tap2(1, v[1]), tap2(3, v[2]));
    out[2] = __fadd_rn(__fadd_rn(tap2(0, v[1]), tap2(2, v[2])), tap2(4, v[3]));
    out[3] = __fadd_rn(tap2(1, v[2]), tap2(3, v[3]));
}

// The expanded 2 x 4 patch (i, j) of one channel: fine rows 2i, 2i+1 and
// columns 4j .. 4j+3 of the tile, from window rows i .. i+2 and columns
// 2j .. 2j+3.  The same taps, products and order of sums as expand_even /
// expand_odd, vertical pass first, so every value keeps its bits.
__device__ __forceinline__ void expand_patch(const float (&win)[kWinH][kWinPitch], int i,
                                             int j, float (&e)[2][4]) {
    float x[3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const float2 a = *reinterpret_cast<const float2*>(&win[i + r][2 * j]);
        const float2 b = *reinterpret_cast<const float2*>(&win[i + r][2 * j + 2]);
        x[r][0] = a.x;
        x[r][1] = a.y;
        x[r][2] = b.x;
        x[r][3] = b.y;
    }
    float v_even[4], v_odd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        v_even[c] = __fadd_rn(__fadd_rn(tap2(0, x[0][c]), tap2(2, x[1][c])), tap2(4, x[2][c]));
        v_odd[c] = __fadd_rn(tap2(1, x[1][c]), tap2(3, x[2][c]));
    }
    expand_patch_row(v_even, e[0]);
    expand_patch_row(v_odd, e[1]);
}

}  // namespace fvvdp
