// band_score, band_score2, band_score2_fov: CSF + mutual masking + beta-norm
// partial of one materialised contrast band -> per-frame sums of D^beta.
//
// Replaces the TPU kernels of fovvideovdp_tpu/ops/pallas/band_score.py:
//   `_band_score_kernel`      one temporal channel, one 1-D CSF table
//   `_band_score2_kernel`     both channels, two 1-D tables on a shared grid
//   `_band_score2_fov_kernel` both channels, PER-PIXEL tables (n, h, w)
//                             (fixed-gaze foveation)
// They are one computation with three ways of finding the table.  Per pixel
// and frame:
//   u      = (log2(clamp(L_bkg, Ymin, Ymax)) - y0) / dy, clamped to [0, n-1]
//   ls_c   = t_c[i0] * (1 - f) + t_c[i1] * f + log2(corr)   (i0 = floor u)
//   D^beta = d_beta_log2(T_c, R_c, ls_c, ...)                (score_math.cuh)
// u and the knot pair are found once for both channels.
//
// Bound on this card: memory bytes.  Per pixel-frame the function reads
// 12 B (one channel) or 20 B (two channels) of band and L_bkg; the
// per-pixel variant also reads 2 n floats of tables per pixel (152 B at
// n = 19) which every frame of the block shares.  Against that stand 6 or
// 11 log2/exp2 per pixel-frame, under half the bytes' time.
//
// Design.  Everything is pointwise, so a block owns 256 consecutive pixels
// of the flattened (h, w) plane, one per thread, and every load is
// coalesced.  On the TPU the grid runs in order and the per-pixel tables of
// a tile stay in VMEM while the frames pass; here nothing carries from block
// to block, so the frame loop is INSIDE the block: the block stages its
// pixels' tables once in shared memory laid out [knot][thread] (no bank
// conflicts, and indexable by the data-dependent knot, which registers are
// not), then walks its frames.  The tables are so read from memory once per
// block of frames, not once per frame.  Where a level has too few pixel
// blocks to fill the card, the frames are split over grid.y instead (the
// tables of such a level are small).  The per-frame sums go through the two
// passes of partials.cuh.  No atomics.  Pixels past the end of the plane are
// masked; the TPU kernels pad with T = R = 0 instead.  A NaN in L_bkg or the
// contrast gives a NaN sum for that frame (score_math.cuh).
#include <cuda_runtime.h>

#include "partials.cuh"
#include "score_math.cuh"

namespace {

using fvvdp::kFrameChunk;
constexpr int kThreads = fvvdp::kPixelThreads;
constexpr int kMaxGrid = 64;

struct BandArgs {
    const float* ch[4];   // T-sust, R-sust, T-trans, R-trans planes of frame 0
    long long fs[4];      // their frame strides, in floats
    const float* L;       // (F, hw) background luminance
    long long L_fs;
    const float* tab[2];  // 1-D: (n,) each; per pixel: (n, hw) each
    float* partials;      // (F, n_blocks, 2)
    int F, hw, n_grid, frames_per_group;
    float y0, dy, Ymin, Ymax, p, q[2], lc10, lcorr, beta;
};

template <bool kPerPixel, int kCh>
__global__ void __launch_bounds__(kThreads) band_score_kernel(BandArgs a) {
    extern __shared__ float s_tab[];   // 1-D: [kCh][n]; per pixel: [kCh][n][kThreads]
    __shared__ fvvdp::FrameSums s_part;

    const int tid = threadIdx.x;
    const int n = a.n_grid;
    const long long pix = (long long)blockIdx.x * kThreads + tid;
    const bool live = pix < a.hw;

    if (kPerPixel) {
        // thread tid reads and later uses only column tid: no barrier needed
        for (int c = 0; c < kCh; ++c)
            for (int k = 0; k < n; ++k)
                s_tab[(c * n + k) * kThreads + tid] =
                    live ? a.tab[c][(size_t)k * a.hw + pix] : 0.0f;
    } else {
        for (int i = tid; i < kCh * n; i += kThreads) s_tab[i] = a.tab[i / n][i % n];
        __syncthreads();
    }
    const int t_stride = kPerPixel ? kThreads : 1;
    const float* my_tab = kPerPixel ? s_tab + tid : s_tab;

    const int f_begin = blockIdx.y * a.frames_per_group;
    const int f_end = min(a.F, f_begin + a.frames_per_group);
    for (int f0 = f_begin; f0 < f_end; f0 += kFrameChunk) {
        const int nf = min(kFrameChunk, f_end - f0);
#pragma unroll 4
        for (int j = 0; j < nf; ++j) {
            const long long f = f0 + j;
            float acc[2] = {0.0f, 0.0f};
            if (live) {
                const float L = a.L[f * a.L_fs + pix];
                float u = (log2f(fvvdp::clampf(L, a.Ymin, a.Ymax)) - a.y0) / a.dy;
                u = fvvdp::clampf(u, 0.0f, static_cast<float>(n - 1));
                int i0, i1;
                float fr;
                fvvdp::table_knots(u, n, &i0, &i1, &fr);
#pragma unroll
                for (int c = 0; c < kCh; ++c) {
                    const float* t = my_tab + (size_t)c * n * t_stride;
                    const float ls = t[i0 * t_stride] * (1.0f - fr) + t[i1 * t_stride] * fr
                                     + a.lcorr;
                    const float T = a.ch[2 * c][f * a.fs[2 * c] + pix];
                    const float R = a.ch[2 * c + 1][f * a.fs[2 * c + 1] + pix];
                    acc[c] = fvvdp::d_beta_log2(T, R, ls, a.p, a.q[c], a.lc10, a.beta);
                }
            }
            fvvdp::frame_warp_sums(acc[0], acc[1], s_part, j);
        }
        fvvdp::flush_frame_chunk(s_part, nf, f0, a.partials);
    }
}

template <bool kPerPixel, int kCh>
int launch(BandArgs a, float* out, cudaStream_t stream) {
    if (a.n_grid < 1 || a.n_grid > kMaxGrid || a.F < 1 || a.hw < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_blocks = fvvdp::pixel_blocks_of(a.hw);
    int groups;
    fvvdp::frame_groups(n_blocks, a.F, &a.frames_per_group, &groups);
    if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * kCh * a.n_grid * (kPerPixel ? kThreads : 1);
    auto kernel = band_score_kernel<kPerPixel, kCh>;
    if (kPerPixel) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(sizeof(float) * kCh * kMaxGrid * kThreads));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(n_blocks, groups), kThreads, smem, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fvvdp::sum_partials_kernel<<<a.F, fvvdp::kSumThreads, 0, stream>>>(a.partials, out,
                                                                       n_blocks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pixel blocks of a plane of hw pixels (the partials' middle dimension)
extern "C" int fvvdp_band_score_n_blocks(int hw) { return fvvdp::pixel_blocks_of(hw); }

// One channel.  T, R, L: planes of hw floats per frame at the given frame
// strides; table (n_grid,); partials scratch (F, n_blocks, 2); out (F, 2),
// of which column 0 holds the sums (column 1 is zero).
extern "C" int fvvdp_band_score(const float* T, const float* R, const float* L,
                                const float* table, float* partials, float* out, int F,
                                int hw, long long fs_T, long long fs_R, long long fs_L,
                                int n_grid, float y0, float dy, float Ymin, float Ymax,
                                float p, float q, float lc10, float lcorr, float beta,
                                cudaStream_t stream) {
    BandArgs a{{T, R, nullptr, nullptr}, {fs_T, fs_R, 0, 0}, L, fs_L, {table, nullptr},
               partials, F, hw, n_grid, 0, y0, dy, Ymin, Ymax, p, {q, q}, lc10, lcorr, beta};
    return launch<false, 1>(a, out, stream);
}

// Both channels, 1-D tables.  band (F, 4, hw) contiguous; tables (2, n_grid).
extern "C" int fvvdp_band_score2(const float* band, const float* L, const float* tables,
                                 float* partials, float* out, int F, int hw,
                                 long long fs_L, int n_grid, float y0, float dy,
                                 float Ymin, float Ymax, float p, float q_s, float q_t,
                                 float lc10, float lcorr, float beta, cudaStream_t stream) {
    const long long fs = 4LL * hw;
    BandArgs a{{band, band + hw, band + 2LL * hw, band + 3LL * hw}, {fs, fs, fs, fs}, L, fs_L,
               {tables, tables + n_grid}, partials, F, hw, n_grid, 0, y0, dy, Ymin, Ymax, p,
               {q_s, q_t}, lc10, lcorr, beta};
    return launch<false, 2>(a, out, stream);
}

// Both channels, per-pixel tables.  tabs_s, tabs_t (n_grid, hw) plane-major.
extern "C" int fvvdp_band_score2_fov(const float* band, const float* L, const float* tabs_s,
                                     const float* tabs_t, float* partials, float* out,
                                     int F, int hw, long long fs_L, int n_grid, float y0,
                                     float dy, float Ymin, float Ymax, float p, float q_s,
                                     float q_t, float lc10, float lcorr, float beta,
                                     cudaStream_t stream) {
    const long long fs = 4LL * hw;
    BandArgs a{{band, band + hw, band + 2LL * hw, band + 3LL * hw}, {fs, fs, fs, fs}, L, fs_L,
               {tabs_s, tabs_t}, partials, F, hw, n_grid, 0, y0, dy, Ymin, Ymax, p,
               {q_s, q_t}, lc10, lcorr, beta};
    return launch<true, 2>(a, out, stream);
}
