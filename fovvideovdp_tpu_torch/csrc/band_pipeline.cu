// expand_score2: one contrast-pyramid level scored end to end, both
// temporal channels: (F, 4, H, W) fine + (F, 4, ceil(H/2), ceil(W/2))
// coarse Gaussian levels -> (F, 2) per-frame sums of D^beta.
//
// Replaces the TPU kernel fovvideovdp_tpu/ops/pallas/band_pipeline.py
// `_expand_score_kernel` (through `_expand_score2_call`), with the math of
// fovvideovdp_tpu/ops/pallas/score_math.py as device functions
// (score_math.cuh).  Per fine pixel:
//   e        = gausspyr_expand(coarse)            (all four channels)
//   L_bkg    = max(e[bkg_ch], 0.1)
//   contrast = min((fine - e) / L_bkg, 1000)
//   u        = (log2(clamp(L_bkg, Ymin, Ymax)) - y0) / dy, in [0, n-1]
//   ls_c     = table_c(u) + log2(corr)            (log2 sensitivity)
//   D^beta   = d_beta_log2(T_c, R_c, ls_c, ...)    (channel c = sust, trans)
// Contrast and L_bkg never leave the block.  The per-band gain is folded
// into corr by the caller.
//
// The expansion (a polyphase filter over a clamped coarse window in shared
// memory) is csrc/expand.cuh, shared with expand_contrast.cu.
//
// Bound on this card: about 11 log2/exp2 per fine pixel (the SFU rate)
// against 20 bytes of fine input per pixel; whichever is larger.  Design:
// one block per (frame, 16 x 64 fine tile).  The block stages the
// replicate-extended 4-channel coarse window (10 x 34) in shared memory,
// expands it vertically into shared memory (16 x 34 per channel), and each
// thread then expands horizontally, scores four pixels and keeps two
// running sums.  The table (2 x n floats) sits in shared memory and is read
// with a direct 2-tap lookup.  Per-block sums are reduced in a fixed order
// and written as partials (F, n_tiles, 2); a second kernel sums them per
// frame in a fixed order.  No atomics: results are deterministic.
#include <cuda_runtime.h>

#include "expand.cuh"
#include "partials.cuh"
#include "score_math.cuh"

namespace {

using fvvdp::kCoarseH;
using fvvdp::kCoarseW;
using fvvdp::kRowsPerPass;
using fvvdp::kTileH;
using fvvdp::kTileW;
constexpr int kThreads = fvvdp::kTileThreads;
constexpr int kMaxGrid = 64;

struct ScoreParams {
    float y0, dy, Ymin, Ymax, p, q_s, q_t, lc10, lcorr, beta;
};

__global__ void __launch_bounds__(kThreads)
expand_score_kernel(const float* __restrict__ fine, const float* __restrict__ coarse,
                    const float* __restrict__ tables, float* __restrict__ partials,
                    int H, int W, int h2, int w2, int n_grid, int bkg_ch,
                    ScoreParams sp) {
    __shared__ float s_c[4][kCoarseH][kCoarseW];
    __shared__ float s_v[4][kTileH][kCoarseW + 1];
    __shared__ float s_tab[2][kMaxGrid];
    __shared__ float s_red[2][kThreads / 32];

    const int f = blockIdx.z;
    const int r0 = blockIdx.y * kTileH;
    const int c0 = blockIdx.x * kTileW;
    const int tid = threadIdx.x;

    for (int i = tid; i < 2 * n_grid; i += kThreads) s_tab[i / n_grid][i % n_grid] = tables[i];

    fvvdp::expand_tile_vertical<4>(coarse + (size_t)f * 4 * h2 * w2, h2, w2, r0, c0, tid,
                                   s_c, s_v);

    const int lc = tid % kTileW;
    const int gx = c0 + lc;
    const size_t plane = (size_t)H * W;
    const float* fbase = fine + (size_t)f * 4 * plane;
    float acc_s = 0.0f, acc_t = 0.0f;
    for (int lr = tid / kTileW; lr < kTileH; lr += kRowsPerPass) {
        const int gy = r0 + lr;
        if (gy >= H || gx >= W) continue;
        float e[4];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
            e[ch] = fvvdp::expand_tile_horizontal(s_v[ch][lr], lc);
        const float lbkg = fvvdp::clamp_min(e[bkg_ch], 0.1f);
        float con[4];
        const float* fp = fbase + (size_t)gy * W + gx;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
            con[ch] = fvvdp::clamp_max((fp[ch * plane] - e[ch]) / lbkg, 1000.0f);

        float u = (log2f(fvvdp::clampf(lbkg, sp.Ymin, sp.Ymax)) - sp.y0) / sp.dy;
        u = fvvdp::clampf(u, 0.0f, static_cast<float>(n_grid - 1));
        const float ls_s = fvvdp::table_interp(s_tab[0], n_grid, u) + sp.lcorr;
        const float ls_t = fvvdp::table_interp(s_tab[1], n_grid, u) + sp.lcorr;
        acc_s += fvvdp::d_beta_log2(con[0], con[1], ls_s, sp.p, sp.q_s, sp.lc10, sp.beta);
        acc_t += fvvdp::d_beta_log2(con[2], con[3], ls_t, sp.p, sp.q_t, sp.lc10, sp.beta);
    }

    // fixed-order block reduction: warp shuffles, then warp 0's lane 0
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        acc_s += __shfl_down_sync(0xffffffffu, acc_s, off);
        acc_t += __shfl_down_sync(0xffffffffu, acc_t, off);
    }
    const int warp = tid / 32, lane = tid % 32;
    if (lane == 0) {
        s_red[0][warp] = acc_s;
        s_red[1][warp] = acc_t;
    }
    __syncthreads();
    if (tid == 0) {
        float s = 0.0f, t = 0.0f;
        for (int w = 0; w < kThreads / 32; ++w) {
            s += s_red[0][w];
            t += s_red[1][w];
        }
        const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
        const size_t n_tiles = (size_t)gridDim.x * gridDim.y;
        float* out = partials + ((size_t)f * n_tiles + tile) * 2;
        out[0] = s;
        out[1] = t;
    }
}

}  // namespace

extern "C" int fvvdp_expand_score2_n_tiles(int H, int W) {
    const dim3 g = fvvdp::tile_grid(1, H, W);
    return static_cast<int>(g.x * g.y);
}

// fine (F,4,H,W), coarse (F,4,h2,w2), tables (2,n_grid), partials scratch
// (F, n_tiles, 2) and out (F, 2): device pointers, float32, contiguous.
extern "C" int fvvdp_expand_score2(const float* fine, const float* coarse,
                                   const float* tables, float* partials, float* out,
                                   int F, int H, int W, int h2, int w2, int n_grid,
                                   int bkg_ch, float y0, float dy, float Ymin,
                                   float Ymax, float p, float q_s, float q_t,
                                   float lc10, float lcorr, float beta,
                                   cudaStream_t stream) {
    if (n_grid < 1 || n_grid > kMaxGrid || bkg_ch < 0 || bkg_ch > 3)
        return static_cast<int>(cudaErrorInvalidValue);
    const ScoreParams sp{y0, dy, Ymin, Ymax, p, q_s, q_t, lc10, lcorr, beta};
    const dim3 grid = fvvdp::tile_grid(F, H, W);
    expand_score_kernel<<<grid, kThreads, 0, stream>>>(fine, coarse, tables, partials, H,
                                                       W, h2, w2, n_grid, bkg_ch, sp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fvvdp::sum_partials_kernel<<<F, fvvdp::kSumThreads, 0, stream>>>(
        partials, out, static_cast<int>(grid.x * grid.y));
    return static_cast<int>(cudaGetLastError());
}
