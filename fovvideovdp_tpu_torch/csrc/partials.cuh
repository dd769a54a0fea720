// The two-pass per-frame sums the scoring kernels share.
//
// Blocks run in no order and carry nothing between them, so each scoring
// block writes its own partial sums (F, n_parts, 2) and sum_partials_kernel
// adds them per frame in a fixed order, in double.  No atomics: the result
// is the same from run to run.
//
// The pixel scorers (band_score.cu, mov_score.cu) also share their first
// pass: a block of kPixelThreads threads owns that many consecutive pixels
// and walks its frames; per frame each warp adds its two sums with shuffles
// into shared memory (frame_warp_sums), and after every kFrameChunk frames
// the block adds the warps' sums in a fixed order and writes its partials
// (flush_frame_chunk): one barrier pair per chunk, not per frame.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace fvvdp {

constexpr int kPixelThreads = 256;
constexpr int kPixelWarps = kPixelThreads / 32;
constexpr int kFrameChunk = 32;
// pixel blocks below which a level's frames are split over grid.y (two
// blocks per SM of the 132)
constexpr int kFillBlocks = 264;

typedef float FrameSums[kFrameChunk][kPixelWarps][2];

inline int pixel_blocks_of(int hw) { return (hw + kPixelThreads - 1) / kPixelThreads; }

// Frames per grid.y group and the number of groups, for a level of n_blocks
// pixel blocks and F frames: one group unless the level cannot fill the card.
inline void frame_groups(int n_blocks, int F, int* frames_per_group, int* groups) {
    int g = 1;
    if (n_blocks < kFillBlocks) g = std::min(F, (kFillBlocks + n_blocks - 1) / n_blocks);
    *frames_per_group = (F + g - 1) / g;
    *groups = (F + *frames_per_group - 1) / *frames_per_group;
}

// Every thread of the block calls this once per frame with its two terms;
// slot j of the chunk receives the warp's sums.
__device__ __forceinline__ void frame_warp_sums(float a0, float a1, FrameSums s_part, int j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a0 += __shfl_down_sync(0xffffffffu, a0, off);
        a1 += __shfl_down_sync(0xffffffffu, a1, off);
    }
    if (threadIdx.x % 32 == 0) {
        s_part[j][threadIdx.x / 32][0] = a0;
        s_part[j][threadIdx.x / 32][1] = a1;
    }
}

// After nf frames of a chunk starting at frame f0: write the block's
// partials (F, gridDim.x, 2).  Every thread of the block calls it.
__device__ __forceinline__ void flush_frame_chunk(FrameSums s_part, int nf, int f0,
                                                  float* __restrict__ partials) {
    __syncthreads();
    const int tid = threadIdx.x;
    if (tid < 2 * nf) {
        const int j = tid >> 1, c = tid & 1;
        float s = 0.0f;
        for (int w = 0; w < kPixelWarps; ++w) s += s_part[j][w][c];
        partials[((size_t)(f0 + j) * gridDim.x + blockIdx.x) * 2 + c] = s;
    }
    __syncthreads();
}

constexpr int kSumThreads = 256;

// out[f, c] = sum over parts of partials[f, part, c], in a fixed order
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                    int n_parts) {
    __shared__ double s_red[2][kSumThreads];
    const int f = blockIdx.x, tid = threadIdx.x;
    const float* p = partials + (size_t)f * n_parts * 2;
    double s = 0.0, t = 0.0;
    for (int i = tid; i < n_parts; i += kSumThreads) {
        s += p[2 * i];
        t += p[2 * i + 1];
    }
    s_red[0][tid] = s;
    s_red[1][tid] = t;
    __syncthreads();
    for (int half = kSumThreads / 2; half > 0; half >>= 1) {
        if (tid < half) {
            s_red[0][tid] += s_red[0][tid + half];
            s_red[1][tid] += s_red[1][tid + half];
        }
        __syncthreads();
    }
    if (tid == 0) {
        out[2 * f] = static_cast<float>(s_red[0][0]);
        out[2 * f + 1] = static_cast<float>(s_red[1][0]);
    }
}

}  // namespace fvvdp
