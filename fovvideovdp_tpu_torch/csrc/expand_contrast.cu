// expand_contrast: one contrast-pyramid level written out: (F, C, H, W)
// fine + (F, C, ceil(H/2), ceil(W/2)) coarse Gaussian levels ->
// Weber contrast (F, C, H, W) and background luminance (F, 1, H, W).
//
// Replaces the TPU kernel fovvideovdp_tpu/ops/pallas/expand.py
// `_expand_contrast_kernel` (through `expand_contrast_pallas`).  Per fine
// pixel:
//   e        = gausspyr_expand(coarse)            (all C channels)
//   L_bkg    = max(e[bkg_ch], 0.1)
//   contrast = min((fine - e) / L_bkg, 1000)
// The routes that need the contrast itself call it: per-pixel CSF tables
// (fixed-gaze foveation), heatmaps and per-channel LUTs.  The default route
// keeps contrast inside band_pipeline.cu instead.
//
// Bound on this card: memory bytes.  Per fine pixel-frame the function
// reads C fine and C/4 coarse values and writes C contrast values and one
// L_bkg: 4 B x (2.25 C + 1), 40 B at C = 4, against ~70 flop.  Design: the
// expansion of csrc/expand.cuh (one block per frame and 16 x 64 fine tile,
// coarse window staged once in shared memory, so each coarse value is read
// from memory about once); every thread then reads its fine values and
// writes its results, consecutive threads on consecutive columns, so loads
// and stores are coalesced.  One kernel for every shape and for C = 2
// (images) and C = 4 (videos); the TPU kernel's shape gate is not needed.
// The arithmetic is rounded as the plain version rounds it (no FMA
// contraction in the expansion, IEEE division), so the two agree to the
// last bit.
#include <cuda_runtime.h>

#include "expand.cuh"

namespace {

using fvvdp::kCoarseH;
using fvvdp::kCoarseW;
using fvvdp::kRowsPerPass;
using fvvdp::kTileH;
using fvvdp::kTileW;
constexpr int kThreads = fvvdp::kTileThreads;

template <int C>
__global__ void __launch_bounds__(kThreads)
expand_contrast_kernel(const float* __restrict__ fine, const float* __restrict__ coarse,
                       float* __restrict__ contrast, float* __restrict__ lbkg_out,
                       int H, int W, int h2, int w2, int bkg_ch) {
    __shared__ float s_c[C][kCoarseH][kCoarseW];
    __shared__ float s_v[C][kTileH][kCoarseW + 1];

    const int f = blockIdx.z;
    const int r0 = blockIdx.y * kTileH;
    const int c0 = blockIdx.x * kTileW;
    const int tid = threadIdx.x;

    fvvdp::expand_tile_vertical<C>(coarse + (size_t)f * C * h2 * w2, h2, w2, r0, c0, tid,
                                   s_c, s_v);

    const int lc = tid % kTileW;
    const int gx = c0 + lc;
    if (gx >= W) return;
    const size_t plane = (size_t)H * W;
    const float* fbase = fine + (size_t)f * C * plane;
    float* cbase = contrast + (size_t)f * C * plane;
    float* lbase = lbkg_out + (size_t)f * plane;
    for (int lr = tid / kTileW; lr < kTileH; lr += kRowsPerPass) {
        const int gy = r0 + lr;
        if (gy >= H) break;
        float e[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
            e[ch] = fvvdp::expand_tile_horizontal(s_v[ch][lr], lc);
        float eb = e[0];
#pragma unroll
        for (int ch = 1; ch < C; ++ch)
            if (ch == bkg_ch) eb = e[ch];
        const float lbkg = fvvdp::clamp_min(eb, 0.1f);
        const size_t off = (size_t)gy * W + gx;
        lbase[off] = lbkg;
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
            cbase[ch * plane + off] =
                fvvdp::clamp_max((fbase[ch * plane + off] - e[ch]) / lbkg, 1000.0f);
    }
}

}  // namespace

// fine (F,C,H,W), coarse (F,C,h2,w2), contrast (F,C,H,W), lbkg (F,1,H,W):
// device pointers, float32, contiguous.  C is 2 or 4.
extern "C" int fvvdp_expand_contrast(const float* fine, const float* coarse,
                                     float* contrast, float* lbkg, int F, int C, int H,
                                     int W, int h2, int w2, int bkg_ch,
                                     cudaStream_t stream) {
    if (bkg_ch < 0 || bkg_ch >= C || F < 1 || F > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid = fvvdp::tile_grid(F, H, W);
    if (C == 4)
        expand_contrast_kernel<4><<<grid, kThreads, 0, stream>>>(fine, coarse, contrast, lbkg,
                                                                 H, W, h2, w2, bkg_ch);
    else if (C == 2)
        expand_contrast_kernel<2><<<grid, kThreads, 0, stream>>>(fine, coarse, contrast, lbkg,
                                                                 H, W, h2, w2, bkg_ch);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
