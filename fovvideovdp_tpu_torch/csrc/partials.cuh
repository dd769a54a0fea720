// Second pass of the two-pass per-frame sums the scoring kernels share.
//
// Blocks run in no order and carry nothing between them, so each scoring
// block writes its own partial sums (F, n_parts, 2) and this kernel adds
// them per frame in a fixed order, in double.  No atomics: the result is
// the same from run to run.
#pragma once

#include <cuda_runtime.h>

namespace fvvdp {

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
