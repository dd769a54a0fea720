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
// per-pixel instance also reads 2 n floats of tables per pixel (152 B at
// n = 19), which every frame of a block shares.  Against that stand 6 or 11
// log2/exp2 per pixel-frame.
//
// Design.  A block owns a run of consecutive pixels of the flattened (h, w)
// plane, four per thread, and walks its frames inside the kernel.  Per frame
// a thread loads each plane it reads (T, R per channel, L_bkg) as one 16-byte
// load (a warp covers 512 contiguous bytes of each), and the loads of the
// next frame are requested before this frame's arithmetic.  log2 and exp2 are
// the special-function unit's instructions (score_math.cuh: ApproxMath), and
// the host passes 1/dy for the one division.  A thread adds its four pixels,
// then the per-frame sums go through the two passes of partials.cuh.  No
// atomics.
//  - 1-D tables (band_score, band_score2): 256 threads, 1,024 pixels a
//    block; the tables sit in shared memory, both channels' knots
//    interleaved so that one 8-byte read fetches a knot of both.
//  - Per-pixel tables (band_score2_fov): on the TPU the tables of a tile
//    stay in VMEM while the grid walks its frames; here a block stages its
//    pixels' tables once in shared memory, [knot][pixel of the thread]
//    [thread] as (sustained, transient) pairs, so that a thread's read at
//    its data-dependent knot is one 8-byte read and a warp's reads hit no
//    bank twice.  The copy is 4-byte cp.async (consecutive threads copy
//    consecutive pixels of a knot row, 128 contiguous bytes a warp), issued
//    before the first frames' loads, so the two overlap, and no register
//    holds the data.  The table bytes (8 n per pixel) cap the pixels an SM
//    holds; the wrapper takes the largest block (1,024, 512, 256 or 128
//    pixels) of which two fit on an SM, and this instance keeps two frames
//    in flight instead of one to make up for the fewer warps.
// Where a level has too few blocks to fill the card, the frames are split
// over grid.y (each group stages its own tables; such levels are small).
//
// The vector arm needs hw % 4 == 0 and 16-byte aligned planes (every
// plane's first element and frame stride); everything else takes the scalar
// arm of the same kernel (4-byte loads, each masked).  Pixels past the end
// of the plane read as 0 (zero tables), which scores 0, and are masked as
// well; the TPU kernels pad with T = R = 0 instead.  The wrapper chooses the
// arm, the block and the grid (ops/cuda/band_score.py:launch_plan); this
// file checks them.  lg2(0) = -inf and ex2(-inf) = 0, so a zero channel sums
// to exactly 0; a NaN in L_bkg or the contrast gives a NaN sum for that
// frame (score_math.cuh).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "partials.cuh"
#include "score_math.cuh"

namespace {

using fvvdp::kFrameChunk;
using Math = fvvdp::ApproxMath;
constexpr int kPix = 4;                            // consecutive pixels per thread
constexpr int kMaxThreads = fvvdp::kPixelThreads;
constexpr int kBlockPixels1D = kMaxThreads * kPix;
constexpr int kMaxGrid = 64;
// a block's most shared memory on sm_90 (227 KB), less the frame sums and
// the 1-D tables: room for the per-pixel tables
constexpr size_t kMaxTableBytes =
    232448 - sizeof(fvvdp::FrameSums) - sizeof(float) * 2 * kMaxGrid;

struct BandArgs {
    const float* ch[4];   // T-sust, R-sust, T-trans, R-trans (one channel: T, R) of frame 0
    long long fs[4];      // their frame strides, in floats
    const float* L;       // (F, hw) background luminance
    long long L_fs;
    const float* tab[2];  // 1-D: (n,) each; per pixel: (n, hw) each
    float* partials;      // (F, n_blocks, 2)
    int F, hw, n_grid, frames_per_group;
    float y0, inv_dy, Ymin, Ymax, p, q[2], lc10, lcorr, beta;
};

// kPix consecutive values; those at or past n_live read as 0.  Every value
// is read once: streaming loads.
template <bool kVec>
__device__ __forceinline__ void load_pixels(const float* __restrict__ p, int n_live,
                                            float (&v)[kPix]) {
    if (kVec) {
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n_live > 0) q = __ldcs(reinterpret_cast<const float4*>(p));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k) v[k] = k < n_live ? __ldcs(p + k) : 0.0f;
    }
}

// One frame's inputs of a thread's pixels.
template <int kCh>
struct FrameIn {
    float ch[2 * kCh][kPix];
    float L[kPix];
};

template <int kCh, bool kVec>
__device__ __forceinline__ void load_frame(const BandArgs& a, long long f, long long pix0,
                                           int n_live, FrameIn<kCh>& in) {
#pragma unroll
    for (int c = 0; c < 2 * kCh; ++c)
        load_pixels<kVec>(a.ch[c] + f * a.fs[c] + pix0, n_live, in.ch[c]);
    load_pixels<kVec>(a.L + f * a.L_fs + pix0, n_live, in.L);
}

// 4-byte asynchronous copy into shared memory; src_bytes = 0 writes a 0.
__device__ __forceinline__ void cp_async4(void* dst, const float* src, int src_bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// Start the copy of the block's per-pixel tables (pixels blk0 .. blk0 + 4 T
// - 1) into s2, pair (sustained, transient) of knot k, pixel j of thread t
// at s2[(k * kPix + j) * T + t].  The caller waits and places the barrier.
__device__ __forceinline__ void stage_pixel_tables(const BandArgs& a, long long blk0,
                                                   float2* s2) {
    const int T = blockDim.x;
    for (int k = 0; k < a.n_grid; ++k) {
        const size_t row = (size_t)k * a.hw;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
            const int p = threadIdx.x + i * T;        // the block's pixel
            const long long g = blk0 + p;
            const bool in = g < a.hw;
            float* dst = reinterpret_cast<float*>(s2 + (k * kPix + (p % kPix)) * T + p / kPix);
#pragma unroll
            for (int c = 0; c < 2; ++c)
                cp_async4(dst + c, a.tab[c] + row + (in ? g : 0), in ? 4 : 0);
        }
    }
    __pipeline_commit();
}

template <int kCh, bool kPerPixel, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 2) band_score_kernel(BandArgs a) {
    extern __shared__ __align__(16) float2 s_pix[];   // kPerPixel: [n][kPix][T]
    __shared__ __align__(8) float s_tab[2 * kMaxGrid];  // 1-D: [n], or [n][2] interleaved
    __shared__ fvvdp::FrameSums s_part;
    // frames in flight beyond the one being scored
    constexpr int kAhead = kPerPixel ? 2 : 1;

    const int tid = threadIdx.x, T = blockDim.x;
    const long long blk0 = (long long)blockIdx.x * T * kPix;
    const long long pix0 = blk0 + (long long)tid * kPix;
    const int n_live = static_cast<int>(min(max((long long)a.hw - pix0, 0LL), (long long)kPix));
    const int n = a.n_grid;
    const int f_begin = blockIdx.y * a.frames_per_group;
    const int f_end = min(a.F, f_begin + a.frames_per_group);

    if (kPerPixel) {
        stage_pixel_tables(a, blk0, s_pix);
    } else {
        for (int i = tid; i < kCh * n; i += T)
            s_tab[i] = kCh == 2 ? a.tab[i & 1][i >> 1] : a.tab[0][i];
    }
    // in[0] is the frame being scored, in[i] the one i frames later
    FrameIn<kCh> in[kAhead + 1];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
        load_frame<kCh, kVec>(a, f_begin + i, pix0, f_begin + i < f_end ? n_live : 0, in[i]);
    if (kPerPixel) __pipeline_wait_prior(0);
    __syncthreads();

    const float n_top = static_cast<float>(n - 1);
    // knot i of this thread's pixel k: tab2[k * T + i * k_step] per pixel, tab2[i] 1-D
    const float2* tab2 = kPerPixel ? s_pix + tid : reinterpret_cast<const float2*>(s_tab);
    const int k_step = kPerPixel ? kPix * T : 1;

#pragma unroll 2
    for (int f = f_begin; f < f_end; ++f) {
        const int j = (f - f_begin) % kFrameChunk;
        const bool more = f + 1 < f_end;
        // the next frames' bytes are requested before this frame's arithmetic
        load_frame<kCh, kVec>(a, f + kAhead, pix0, f + kAhead < f_end ? n_live : 0,
                              in[kAhead]);
        float acc[2] = {0.0f, 0.0f};
        if (n_live > 0) {
            const FrameIn<kCh>& cur = in[0];
#pragma unroll
            for (int k = 0; k < kPix; ++k) {
                float u = (Math::log2(fvvdp::clampf(cur.L[k], a.Ymin, a.Ymax)) - a.y0)
                          * a.inv_dy;
                u = fvvdp::clampf(u, 0.0f, n_top);
                int i0, i1;
                float fr;
                fvvdp::table_knots(u, n, &i0, &i1, &fr);
                float ls[2];
                if (kCh == 1) {
                    ls[0] = s_tab[i0] * (1.0f - fr) + s_tab[i1] * fr;
                } else {
                    const float2* t = tab2 + (kPerPixel ? k * T : 0);
                    const float2 v0 = t[i0 * k_step], v1 = t[i1 * k_step];
                    ls[0] = v0.x * (1.0f - fr) + v1.x * fr;
                    ls[1] = v0.y * (1.0f - fr) + v1.y * fr;
                }
                const bool live = kVec || k < n_live;
#pragma unroll
                for (int c = 0; c < kCh; ++c) {
                    const float d = fvvdp::d_beta_log2<Math>(cur.ch[2 * c][k], cur.ch[2 * c + 1][k],
                                                             ls[c] + a.lcorr, a.p, a.q[c], a.lc10,
                                                             a.beta);
                    acc[c] += live ? d : 0.0f;
                }
            }
        }
        fvvdp::frame_warp_sums<kCh>(acc[0], acc[1], s_part, j);
        if (j == kFrameChunk - 1 || !more)
            fvvdp::flush_frame_chunk(s_part, j + 1, f - j, a.partials);
#pragma unroll
        for (int i = 0; i < kAhead; ++i) in[i] = in[i + 1];
    }
}

// The caller's launch plan (ops/cuda/band_score.py:launch_plan).
struct Plan {
    int vec, block_pixels, n_blocks, frames_per_group, groups;
};

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

size_t pixel_table_bytes(int n_grid, int block_pixels) {
    return sizeof(float2) * (size_t)n_grid * block_pixels;
}

// Whether the plan fits the arguments: the blocks cover the plane, the
// groups the frames, the vector arm's planes are aligned, and a block of the
// per-pixel instance is one the kernel takes (128 to 1,024 pixels, its
// tables inside a block's shared memory).
bool plan_fits(const BandArgs& a, int n_planes, bool per_pixel, const Plan& p) {
    if (a.n_grid < 1 || a.n_grid > kMaxGrid || a.F < 1 || a.hw < 1) return false;
    if (per_pixel ? (p.block_pixels < 128 || p.block_pixels > kBlockPixels1D ||
                     p.block_pixels % 128 != 0 ||
                     pixel_table_bytes(a.n_grid, p.block_pixels) > kMaxTableBytes)
                  : p.block_pixels != kBlockPixels1D)
        return false;
    if (p.n_blocks != (a.hw + p.block_pixels - 1) / p.block_pixels || p.frames_per_group < 1 ||
        p.groups != (a.F + p.frames_per_group - 1) / p.frames_per_group || p.groups > 65535)
        return false;
    if (p.vec) {
        if (a.hw % 4 != 0 || a.L_fs % 4 != 0 || !aligned16(a.L)) return false;
        for (int c = 0; c < n_planes; ++c)
            if (a.fs[c] % 4 != 0 || !aligned16(a.ch[c])) return false;
    }
    return true;
}

template <int kCh, bool kPerPixel, bool kVec>
int launch(const BandArgs& a, const Plan& p, float* out, cudaStream_t stream) {
    auto kernel = band_score_kernel<kCh, kPerPixel, kVec>;
    const size_t smem = kPerPixel ? pixel_table_bytes(a.n_grid, p.block_pixels) : 0;
    if (kPerPixel) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       static_cast<int>(cudaSharedmemCarveoutMaxShared));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(p.n_blocks, p.groups), p.block_pixels / kPix, smem, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fvvdp::sum_partials_kernel<<<a.F, fvvdp::kSumThreads, 0, stream>>>(a.partials, out,
                                                                       p.n_blocks);
    return static_cast<int>(cudaGetLastError());
}

template <int kCh, bool kPerPixel>
int launch_checked(const BandArgs& a, const Plan& p, float* out, cudaStream_t stream) {
    if (!plan_fits(a, 2 * kCh, kPerPixel, p)) return static_cast<int>(cudaErrorInvalidValue);
    return p.vec ? launch<kCh, kPerPixel, true>(a, p, out, stream)
                 : launch<kCh, kPerPixel, false>(a, p, out, stream);
}

}  // namespace

// The plan arguments (vec, block_pixels, n_blocks, frames_per_group, groups)
// of each entry point are the caller's launch plan
// (ops/cuda/band_score.py:launch_plan): the arm with 16-byte loads, the
// pixels of a block and the blocks of the plane (the partials' middle
// dimension), and the split of the frames over grid.y.  A plan that does not
// fit the arguments is refused.  The scalars take 1/dy in place of dy.

// One channel.  T, R, L: planes of hw floats per frame at the given frame
// strides; table (n_grid,); partials scratch (F, n_blocks, 2); out (F, 2),
// of which column 0 holds the sums (column 1 is zero).
extern "C" int fvvdp_band_score(const float* T, const float* R, const float* L,
                                const float* table, float* partials, float* out, int F,
                                int hw, long long fs_T, long long fs_R, long long fs_L,
                                int n_grid, int vec, int block_pixels, int n_blocks,
                                int frames_per_group, int groups, float y0, float inv_dy,
                                float Ymin, float Ymax, float p, float q, float lc10,
                                float lcorr, float beta, cudaStream_t stream) {
    BandArgs a{{T, R, nullptr, nullptr}, {fs_T, fs_R, 0, 0}, L, fs_L, {table, nullptr},
               partials, F, hw, n_grid, frames_per_group, y0, inv_dy, Ymin, Ymax, p, {q, q},
               lc10, lcorr, beta};
    return launch_checked<1, false>(a, {vec, block_pixels, n_blocks, frames_per_group, groups},
                                    out, stream);
}

// Both channels, 1-D tables.  band (F, 4, hw) contiguous; tables (2, n_grid).
extern "C" int fvvdp_band_score2(const float* band, const float* L, const float* tables,
                                 float* partials, float* out, int F, int hw, long long fs_L,
                                 int n_grid, int vec, int block_pixels, int n_blocks,
                                 int frames_per_group, int groups, float y0, float inv_dy,
                                 float Ymin, float Ymax, float p, float q_s, float q_t,
                                 float lc10, float lcorr, float beta, cudaStream_t stream) {
    const long long fs = 4LL * hw;
    BandArgs a{{band, band + hw, band + 2LL * hw, band + 3LL * hw}, {fs, fs, fs, fs}, L, fs_L,
               {tables, tables + n_grid}, partials, F, hw, n_grid, frames_per_group, y0,
               inv_dy, Ymin, Ymax, p, {q_s, q_t}, lc10, lcorr, beta};
    return launch_checked<2, false>(a, {vec, block_pixels, n_blocks, frames_per_group, groups},
                                    out, stream);
}

// Both channels, per-pixel tables.  tabs_s, tabs_t (n_grid, hw) plane-major.
extern "C" int fvvdp_band_score2_fov(const float* band, const float* L, const float* tabs_s,
                                     const float* tabs_t, float* partials, float* out,
                                     int F, int hw, long long fs_L, int n_grid, int vec,
                                     int block_pixels, int n_blocks, int frames_per_group,
                                     int groups, float y0, float inv_dy, float Ymin, float Ymax,
                                     float p, float q_s, float q_t, float lc10, float lcorr,
                                     float beta, cudaStream_t stream) {
    const long long fs = 4LL * hw;
    BandArgs a{{band, band + hw, band + 2LL * hw, band + 3LL * hw}, {fs, fs, fs, fs}, L, fs_L,
               {tabs_s, tabs_t}, partials, F, hw, n_grid, frames_per_group, y0, inv_dy, Ymin,
               Ymax, p, {q_s, q_t}, lc10, lcorr, beta};
    return launch_checked<2, true>(a, {vec, block_pixels, n_blocks, frames_per_group, groups},
                                   out, stream);
}
