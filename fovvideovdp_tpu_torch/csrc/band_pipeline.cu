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
// Bound on this card: memory bytes, 16 B of fine and 4 B of coarse per fine
// pixel.  What stands against reaching it is the instruction count (the
// expansion, 11 log2/exp2 and five divisions per pixel take longer to run than
// the bytes take to arrive unless each is cheap) and the latency of a short-lived
// block that waits for its bytes before it can start.  Design:
//  - a block of 256 threads owns a 16 x 128 fine tile and walks the frames of
//    that tile; a thread owns a 2 x 4 patch of it.  Per frame a thread loads
//    fine as eight 16-byte loads (2 rows x 4 channels; a warp covers 128
//    contiguous columns), and the loads of frame j + 1 are requested before the
//    arithmetic of frame j.  The replicate-extended coarse window
//    (4 x 10 x 66) of frame j + 1 arrives in the second of two shared buffers
//    by 4-byte asynchronous copies meanwhile: one barrier per frame.  The
//    table, the patch's place and the window's clamped addresses are worked
//    out once per block, not per frame.  Where a level has too few tiles to
//    fill the card, its frames are split over grid.y;
//  - the patch is expanded in registers from 3 x 4 window samples per channel
//    (csrc/expand.cuh), bit for bit as the plain version;
//  - one reciprocal of L_bkg and of dy (the latter from the host) and
//    multiplies in place of divisions, log2 and exp2 as the special-function
//    unit's instructions (score_math.cuh: ApproxMath): within 3e-6 relative
//    of the plain version on a frame's sum at the 4K levels, against a bar of
//    1e-4;
//  - the vector arm needs W % 4 == 0 and a 16-byte aligned fine; everything
//    else takes the scalar arm of the same kernel (4-byte loads, each
//    masked).  The wrapper chooses the arm, the tiles and the split of the
//    frames (ops/cuda/band_pipeline.py:launch_plan); this file checks them.
// The per-frame sums go through the two passes of partials.cuh: per block and
// frame in a fixed order, then per frame over the tiles in a fixed order.  No
// atomics: results are deterministic.  A NaN in either level gives a NaN sum
// for its frame (score_math.cuh).
//
// A row range [r_lo, r_hi) of the fine level scores those rows only (a strip
// of a lone image split over several cards).  The tiles stay on the level's
// grid of 16-row tile rows: the launch covers tile rows r_lo / 16 up to
// ceil(r_hi / 16), and rows outside the range are loaded only where they are
// in the level and never summed.  A strip that starts on a tile row
// therefore gives every tile the partial sums of the whole level's launch,
// and the strips' partials, laid end to end in row order, are the whole
// level's.  Without a place for the sums, the launch leaves its partials for
// the caller to gather and add with fvvdp_sum_partials.  The coarse window
// still clamps at the whole level's edges, so a strip expands as the whole
// level does.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "expand.cuh"
#include "partials.cuh"
#include "score_math.cuh"

namespace {

using fvvdp::kFrameChunk;
using fvvdp::kPatchTileH;
using fvvdp::kPatchTileW;
using fvvdp::kWinH;
using fvvdp::kWinPitch;
using Math = fvvdp::ApproxMath;
constexpr int kThreads = fvvdp::kTileThreads;
constexpr int kMaxGrid = 64;
static_assert(kThreads == fvvdp::kPixelThreads, "the first pass of partials.cuh");

struct ScoreArgs {
    const float* fine;     // (F, 4, H, W)
    const float* coarse;   // (F, 4, h2, w2)
    const float* tables;   // (2, n_grid)
    float* partials;       // (F, tiles, 2)
    int F, H, W, h2, w2, n_grid, tiles_x, frames_per_group;
    int tile_row0, r_lo, r_hi;   // first tile row of the launch; the rows scored
    float y0, inv_dy, Ymin, Ymax, p, q_s, q_t, lc10, lcorr, beta;
};

// Four consecutive values of one row; columns at or past n_cols read as 0.
template <bool kVec>
__device__ __forceinline__ void load_quad(const float* __restrict__ p, int n_cols,
                                          float (&v)[4]) {
    if (kVec) {
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n_cols > 0) q = __ldcs(reinterpret_cast<const float4*>(p));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = k < n_cols ? __ldcs(p + k) : 0.0f;
    }
}

// A thread's 2 x 4 patch of the four fine channels: [row][channel][column].
struct Patch {
    float v[2][4][4];
};

template <bool kVec>
__device__ __forceinline__ void load_patch(const float* __restrict__ p, size_t plane, int W,
                                           int n_rows, int n_cols, Patch& out) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
            load_quad<kVec>(p + ch * plane + (size_t)r * W, r < n_rows ? n_cols : 0,
                            out.v[r][ch]);
}

template <bool kVec, int kBkg>
__global__ void __launch_bounds__(kThreads, 2) expand_score_kernel(ScoreArgs a) {
    __shared__ __align__(16) float s_w[2][4][kWinH][kWinPitch];
    __shared__ float s_tab[2 * kMaxGrid];
    __shared__ fvvdp::FrameSums s_part;

    const int tid = threadIdx.x;
    const int tile_y = blockIdx.x / a.tiles_x, tile_x = blockIdx.x - tile_y * a.tiles_x;
    const int r0 = (a.tile_row0 + tile_y) * kPatchTileH, c0 = tile_x * kPatchTileW;
    const int pj = tid & 31, pi = tid >> 5;   // the thread's patch in the tile
    const int gy = r0 + 2 * pi, gx = c0 + 4 * pj;
    const int n_rows = min(max(a.r_hi - gy, 0), 2);   // rows loaded: those before r_hi
    const int skip = a.r_lo - gy;                      // rows before r_lo: not summed
    const int n_cols = min(max(a.W - gx, 0), 4);   // 0 or 4 on the vector arm
    const size_t plane = (size_t)a.H * a.W;
    const int c_plane = a.h2 * a.w2;
    const float* fine0 = a.fine + (size_t)gy * a.W + gx;
    const fvvdp::WindowMap wmap = fvvdp::window_map(a.h2, a.w2, r0, c0, tid);

    const int f_begin = blockIdx.y * a.frames_per_group;
    const int f_end = min(a.F, f_begin + a.frames_per_group);

    // frame f_begin: its fine patch into registers, its window into buffer 0
    Patch cur;
    load_patch<kVec>(fine0 + (size_t)f_begin * 4 * plane, plane, a.W, n_rows, n_cols, cur);
    fvvdp::stage_window_async<4>(wmap, a.coarse + (size_t)f_begin * 4 * c_plane, c_plane, s_w[0]);
    __pipeline_commit();
    if (tid < 2 * a.n_grid) s_tab[tid] = a.tables[tid];

    const float n_top = static_cast<float>(a.n_grid - 1);
    const float* tab_s = s_tab;
    const float* tab_t = s_tab + a.n_grid;

    for (int f = f_begin; f < f_end; ++f) {
        const int j = (f - f_begin) % kFrameChunk;
        const int buf = (f - f_begin) & 1;
        // this frame's window has landed, and nobody reads the other buffer any more
        __pipeline_wait_prior(0);
        __syncthreads();
        // the next frame's bytes are requested before this frame's arithmetic
        Patch nxt;
        const bool more = f + 1 < f_end;
        load_patch<kVec>(fine0 + (size_t)(f + 1) * 4 * plane, plane, a.W, more ? n_rows : 0,
                         n_cols, nxt);
        if (more) {
            fvvdp::stage_window_async<4>(wmap, a.coarse + (size_t)(f + 1) * 4 * c_plane, c_plane,
                                         s_w[buf ^ 1]);
            __pipeline_commit();
        }

        float e[4][2][4];    // [channel][row][column]
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) fvvdp::expand_patch(s_w[buf][ch], pi, pj, e[ch]);

        float acc_s = 0.0f, acc_t = 0.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float lbkg = fvvdp::clamp_min(e[kBkg][r][k], 0.1f);
                const float inv_l = Math::rcp(lbkg);
                float con[4];
#pragma unroll
                for (int ch = 0; ch < 4; ++ch)
                    con[ch] = fvvdp::clamp_max((cur.v[r][ch][k] - e[ch][r][k]) * inv_l,
                                               1000.0f);

                float u = (Math::log2(fvvdp::clampf(lbkg, a.Ymin, a.Ymax)) - a.y0) * a.inv_dy;
                u = fvvdp::clampf(u, 0.0f, n_top);
                int i0, i1;
                float fr;
                fvvdp::table_knots(u, a.n_grid, &i0, &i1, &fr);
                const float ls_s = tab_s[i0] * (1.0f - fr) + tab_s[i1] * fr + a.lcorr;
                const float ls_t = tab_t[i0] * (1.0f - fr) + tab_t[i1] * fr + a.lcorr;
                const float d_s = fvvdp::d_beta_log2<Math>(con[0], con[1], ls_s, a.p, a.q_s,
                                                           a.lc10, a.beta);
                const float d_t = fvvdp::d_beta_log2<Math>(con[2], con[3], ls_t, a.p, a.q_t,
                                                           a.lc10, a.beta);
                const bool live = r < n_rows && r >= skip && k < n_cols;
                acc_s += live ? d_s : 0.0f;
                acc_t += live ? d_t : 0.0f;
            }
        }
        fvvdp::frame_warp_sums(acc_s, acc_t, s_part, j);
        if (j == kFrameChunk - 1 || !more)
            fvvdp::flush_frame_chunk(s_part, j + 1, f - j, a.partials);
        cur = nxt;
    }
}

template <bool kVec, int kBkg>
int launch(const ScoreArgs& a, int tiles, int groups, float* out, cudaStream_t stream) {
    expand_score_kernel<kVec, kBkg><<<dim3(tiles, groups), kThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
    fvvdp::sum_partials_kernel<<<a.F, fvvdp::kSumThreads, 0, stream>>>(a.partials, out, tiles);
    return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_bkg(int bkg_ch, const ScoreArgs& a, int tiles, int groups, float* out,
               cudaStream_t stream) {
    switch (bkg_ch) {
        case 0: return launch<kVec, 0>(a, tiles, groups, out, stream);
        case 1: return launch<kVec, 1>(a, tiles, groups, out, stream);
        case 2: return launch<kVec, 2>(a, tiles, groups, out, stream);
        default: return launch<kVec, 3>(a, tiles, groups, out, stream);
    }
}

}  // namespace

// fine (F,4,H,W), coarse (F,4,h2,w2), tables (2,n_grid), partials
// (F, tiles_x * tiles_y, 2) and out (F, 2): device pointers, float32,
// contiguous; out may be null, and the partials are then the result.  Fine
// rows [r_lo, r_hi) are scored (0 and H: the whole level).  vec, tiles_x,
// tiles_y, frames_per_group and groups are the caller's launch plan
// (ops/cuda/band_pipeline.py:launch_plan): the arm with 16-byte loads, the
// 16 x 128 tiles of the rows and the split of the frames over grid.y.  A plan
// that does not fit the arguments is refused.
extern "C" int fvvdp_expand_score2(const float* fine, const float* coarse,
                                   const float* tables, float* partials, float* out,
                                   int F, int H, int W, int h2, int w2, int n_grid,
                                   int r_lo, int r_hi,
                                   int bkg_ch, int vec, int tiles_x, int tiles_y,
                                   int frames_per_group, int groups, float y0, float inv_dy,
                                   float Ymin, float Ymax, float p, float q_s, float q_t,
                                   float lc10, float lcorr, float beta,
                                   cudaStream_t stream) {
    if (n_grid < 1 || n_grid > kMaxGrid || bkg_ch < 0 || bkg_ch > 3 || F < 1 || H < 1 ||
        W < 1 || h2 != (H + 1) / 2 || w2 != (W + 1) / 2 ||
        (long long)h2 * w2 > (1LL << 30))
        return static_cast<int>(cudaErrorInvalidValue);
    if (r_lo < 0 || r_hi <= r_lo || r_hi > H) return static_cast<int>(cudaErrorInvalidValue);
    const int tile_row0 = r_lo / kPatchTileH;
    if (tiles_x != (W + kPatchTileW - 1) / kPatchTileW ||
        tiles_y != (r_hi + kPatchTileH - 1) / kPatchTileH - tile_row0 || frames_per_group < 1 ||
        groups != (F + frames_per_group - 1) / frames_per_group || groups > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (vec && (W % 4 != 0 ||
                reinterpret_cast<std::uintptr_t>(fine + (size_t)r_lo * W) % 16 != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    const ScoreArgs a{fine, coarse, tables, partials, F, H, W, h2, w2, n_grid, tiles_x,
                      frames_per_group, tile_row0, r_lo, r_hi,
                      y0, inv_dy, Ymin, Ymax, p, q_s, q_t, lc10, lcorr, beta};
    const int tiles = tiles_x * tiles_y;
    return vec ? launch_bkg<true>(bkg_ch, a, tiles, groups, out, stream)
               : launch_bkg<false>(bkg_ch, a, tiles, groups, out, stream);
}

// out[f, c] = sum over parts of partials[f, part, c] (F, n_parts, 2), in the
// fixed order of expand_score2's second pass: the tile partials of a level's
// strips, gathered from several launches in row order, summed as one launch
// of the whole level sums its own.
extern "C" int fvvdp_sum_partials(const float* partials, float* out, int F, int n_parts,
                                  cudaStream_t stream) {
    if (F < 1 || n_parts < 1) return static_cast<int>(cudaErrorInvalidValue);
    fvvdp::sum_partials_kernel<<<F, fvvdp::kSumThreads, 0, stream>>>(partials, out, n_parts);
    return static_cast<int>(cudaGetLastError());
}
