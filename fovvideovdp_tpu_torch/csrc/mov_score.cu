// mov_score: moving-gaze foveated scorer of one materialised contrast band.
// Per frame the gaze, and with it every pixel's eccentricity, moves, so the
// CSF is looked up in the 3-D LUT for every pixel of every frame:
//   ecc    = |vd(pixel) - gaze[f]|                  (view directions, degrees)
//   t_e    = (sqrt(clamp(ecc, emin, emax)) - es0) / des, clamped to [0, n_e-1]
//   u      = (log2(clamp(L_bkg, Ymin, Ymax)) - y0) / dy, clamped to [0, ny-1]
//   t_r    = the pixel's rho coordinate, static, window-local, in [0, nr-1]
//   S_log  = trilinear interpolation of the windowed LUT V[e][y][r] at
//            (t_e, u, t_r), for the sustained and the transient channel
//            (two tables, or one table plus the scalar off5)
//   D^beta = d_beta_log2(T_c, R_c, S_log_c + log2(corr), ...)  (score_math.cuh)
// and D^beta is summed over the band's pixels -> (F, 2).
//
// Replaces the TPU kernel `_mov_kernel` of
// fovvideovdp_tpu/ops/pallas/mov_score.py.  That kernel loops over dynamic
// per-tile knot windows with hat weights, keeps the LUT in scalar memory,
// cuts narrow 128-wide tiles to keep the windows short and pre-differences
// the luminance axis, all because its vector unit cannot gather.  A thread
// here gathers: the two knots of each axis, 8 corners per table, which is
// the same interpolant up to rounding.  Every level shape is taken.
//
// Bound on this card: memory bytes.  Per pixel-frame the function reads
// 20 B of band and L_bkg; per pixel 12 B of static planes (vd0, vd1, t_r),
// which every frame of the block shares; the LUT window is a few KB.  What
// stands against reaching it is the instruction count: 13 log2/exp2/sqrt, two
// divisions, three knot searches and 16 gathers per pixel-frame.
//
// Design.  A block of 256 threads owns 1,024 consecutive pixels of the
// flattened plane, four per thread, and walks its frames inside the kernel,
// so the three static planes are read once per block of frames (once per
// group where a small level splits its frames over grid.y).  Per frame a
// thread loads T_s, R_s, T_t, R_t and L as five 16-byte loads (a warp covers
// 512 contiguous bytes of each plane), and the loads of frame j + 1 are requested
// before the arithmetic of frame j.  The block stages the LUT window once in
// shared memory (2 x 32 x 19 x 4 floats = 19.5 KB on the shipped calibration),
// the two tables interleaved, so that one 8-byte read fetches a corner of
// both; neighbouring pixels sit in the same or the next LUT cell, so a warp's
// gathers mostly broadcast.  A LUT too large for that (no window, a user LUT
// with more knots: 2 x 32^3 floats = 262 KB) is read from global memory
// through the read-only path instead, where it stays in L1/L2: the same
// kernel with kLutShared = false.  1/des, 1/dy and the LUT's strides come
// from the host; log2, exp2 and both square roots are the special-function
// unit's instructions (score_math.cuh: ApproxMath), within 3e-6 relative of
// the plain version on a frame's sum at the 4K levels against a bar of 2e-4.
// The gaze
// directions (F, 2) are a device tensor; a frame's pair is one broadcast
// load.  A thread adds its four pixels, then the per-frame sums go through
// the two passes of partials.cuh: ten shuffles per four pixels.  No atomics.
// A NaN in the gaze, L_bkg or the contrast gives a NaN sum for that frame
// (score_math.cuh).
//
// The vector arm needs hw % 4 == 0 and 16-byte aligned planes (band, L and
// its frame stride, vd, t_r); everything else takes the scalar arm of the
// same kernel (4-byte loads, each masked).  The wrapper chooses the arm, the
// LUT's place and the grid (ops/cuda/mov_score.py:launch_plan); this file
// checks them.
#include <cuda_runtime.h>

#include <cstdint>

#include "partials.cuh"
#include "score_math.cuh"

namespace {

using fvvdp::kFrameChunk;
using Math = fvvdp::ApproxMath;
constexpr int kThreads = fvvdp::kPixelThreads;
constexpr int kPix = 4;                          // consecutive pixels per thread
constexpr int kBlockPixels = kThreads * kPix;
// Largest LUT (both tables) staged in shared memory.  With the 2 KB of frame
// sums this stays inside the 48 KB a block has without opting in, and
// several blocks still share an SM.
constexpr int kMaxSharedLutBytes = 40 * 1024;

struct MovArgs {
    const float* band;    // (F, 4, hw): T-sust, R-sust, T-trans, R-trans
    const float* L;       // (F, hw) background luminance
    long long L_fs;       // its frame stride, in floats
    const float* vd0;     // (hw) view direction, horizontal, degrees
    const float* vd1;     // (hw) vertical
    const float* t_r;     // (hw) rho coordinate in the window
    const float* gaze;    // (F, 2) gaze view directions, degrees
    const float* V[2];    // (n_e, ny, nr) each; V[1] unused when !kTwo
    float* partials;      // (F, n_blocks, 2)
    int F, hw, n_e, ny, nr, se, frames_per_group;   // se = ny * nr
    float y0, inv_dy, Ymin, Ymax, es0, inv_des, emin, emax, off5;
    float p, q[2], lc10, lcorr, beta;
};

// kPix consecutive values; those at or past n_live read as 0.
template <bool kVec>
__device__ __forceinline__ void load_pixels(const float* __restrict__ p, int n_live,
                                            float (&v)[kPix]) {
    if (kVec) {
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n_live > 0) q = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k) v[k] = k < n_live ? __ldg(p + k) : 0.0f;
    }
}

// One frame's inputs of a thread's pixels.
struct FrameIn {
    float ch[4][kPix];
    float L[kPix];
};

template <bool kVec>
__device__ __forceinline__ void load_frame(const MovArgs& a, long long f, long long pix0,
                                           int n_live, FrameIn& in) {
    const float* b = a.band + f * 4 * a.hw + pix0;
#pragma unroll
    for (int c = 0; c < 4; ++c) load_pixels<kVec>(b + (long long)c * a.hw, n_live, in.ch[c]);
    load_pixels<kVec>(a.L + f * a.L_fs + pix0, n_live, in.L);
}

// The values of both tables at LUT index i (t is left alone when !kTwo).
// Shared memory holds the two tables interleaved.
template <bool kTwo, bool kLutShared>
__device__ __forceinline__ void lut_at(const MovArgs& a, const float* s_lut, int i, float& s,
                                       float& t) {
    if (kLutShared) {
        if (kTwo) {
            const float2 v = reinterpret_cast<const float2*>(s_lut)[i];
            s = v.x;
            t = v.y;
        } else {
            s = s_lut[i];
        }
    } else {
        s = __ldg(a.V[0] + i);
        if (kTwo) t = __ldg(a.V[1] + i);
    }
}

// Trilinear value of both tables: base is the index of the (ecc, Y, rho)
// corner, de / dy / dr the steps to the upper knot of each axis (0 at the
// last knot), fe / fy / fr the fractions.
template <bool kTwo, bool kLutShared>
__device__ __forceinline__ void trilinear(const MovArgs& a, const float* s_lut, int base, int de,
                                          int dy, int dr, float fe, float fy, float fr,
                                          float& s, float& t) {
    float ve[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        float vy[2][2];
#pragma unroll
        for (int y = 0; y < 2; ++y) {
            const int i = base + (e ? de : 0) + (y ? dy : 0);
            float s0, t0 = 0.0f, s1, t1 = 0.0f;
            lut_at<kTwo, kLutShared>(a, s_lut, i, s0, t0);
            lut_at<kTwo, kLutShared>(a, s_lut, i + dr, s1, t1);
            vy[y][0] = s0 * (1.0f - fr) + s1 * fr;
            vy[y][1] = t0 * (1.0f - fr) + t1 * fr;
        }
        ve[e][0] = vy[0][0] * (1.0f - fy) + vy[1][0] * fy;
        ve[e][1] = vy[0][1] * (1.0f - fy) + vy[1][1] * fy;
    }
    s = ve[0][0] * (1.0f - fe) + ve[1][0] * fe;
    t = ve[0][1] * (1.0f - fe) + ve[1][1] * fe;
}

// The lower knot of coordinate u on an axis of n knots, the step to the
// upper one in units of stride (0 at the last knot) and the fraction.
__device__ __forceinline__ void knot_step(float u, int n, int stride, int* k, int* step,
                                          float* f) {
    const int i = min(max(static_cast<int>(floorf(u)), 0), n - 1);
    *k = i;
    *step = i < n - 1 ? stride : 0;
    *f = u - static_cast<float>(i);
}

template <bool kTwo, bool kLutShared, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) mov_score_kernel(MovArgs a) {
    extern __shared__ __align__(16) float s_lut[];   // kLutShared: [n_e * ny * nr][1 or 2]
    __shared__ fvvdp::FrameSums s_part;

    const int tid = threadIdx.x;
    const long long pix0 = ((long long)blockIdx.x * kThreads + tid) * kPix;
    const int n_live = static_cast<int>(min(max((long long)a.hw - pix0, 0LL), (long long)kPix));

    if (kLutShared) {
        const int n_lut = a.n_e * a.se;
        if (kTwo) {
            float2* s2 = reinterpret_cast<float2*>(s_lut);
            for (int i = tid; i < n_lut; i += kThreads)
                s2[i] = make_float2(__ldg(a.V[0] + i), __ldg(a.V[1] + i));
        } else {
            for (int i = tid; i < n_lut; i += kThreads) s_lut[i] = __ldg(a.V[0] + i);
        }
        __syncthreads();
    }

    // static per pixel: view direction, the rho knot pair and its fraction
    float vd0[kPix], vd1[kPix], fr[kPix];
    int r0[kPix], dr[kPix];
    {
        float tr[kPix];
        load_pixels<kVec>(a.vd0 + pix0, n_live, vd0);
        load_pixels<kVec>(a.vd1 + pix0, n_live, vd1);
        load_pixels<kVec>(a.t_r + pix0, n_live, tr);
#pragma unroll
        for (int k = 0; k < kPix; ++k) knot_step(tr[k], a.nr, 1, &r0[k], &dr[k], &fr[k]);
    }
    const float e_top = static_cast<float>(a.n_e - 1), y_top = static_cast<float>(a.ny - 1);

    const int f_begin = blockIdx.y * a.frames_per_group;
    const int f_end = min(a.F, f_begin + a.frames_per_group);
    for (int f0 = f_begin; f0 < f_end; f0 += kFrameChunk) {
        const int nf = min(kFrameChunk, f_end - f0);
        FrameIn cur;
        load_frame<kVec>(a, f0, pix0, n_live, cur);
#pragma unroll 2
        for (int j = 0; j < nf; ++j) {
            const long long f = f0 + j;
            // the next frame's bytes are requested before this frame's arithmetic
            FrameIn nxt;
            load_frame<kVec>(a, f + 1, pix0, j + 1 < nf ? n_live : 0, nxt);
            float acc[2] = {0.0f, 0.0f};
            if (n_live > 0) {
                const float g0 = __ldg(a.gaze + 2 * f), g1 = __ldg(a.gaze + 2 * f + 1);
#pragma unroll
                for (int k = 0; k < kPix; ++k) {
                    const float dx = vd0[k] - g0, dv = vd1[k] - g1;
                    const float ecc = Math::sqrt(dx * dx + dv * dv);
                    float te = (Math::sqrt(fvvdp::clampf(ecc, a.emin, a.emax)) - a.es0)
                               * a.inv_des;
                    te = fvvdp::clampf(te, 0.0f, e_top);
                    float u = (Math::log2(fvvdp::clampf(cur.L[k], a.Ymin, a.Ymax)) - a.y0)
                              * a.inv_dy;
                    u = fvvdp::clampf(u, 0.0f, y_top);
                    int ie, de, iy, dy;
                    float fe, fy;
                    knot_step(te, a.n_e, a.se, &ie, &de, &fe);
                    knot_step(u, a.ny, a.nr, &iy, &dy, &fy);
                    float s_s, s_t = 0.0f;
                    trilinear<kTwo, kLutShared>(a, s_lut, ie * a.se + iy * a.nr + r0[k], de, dy,
                                                dr[k], fe, fy, fr[k], s_s, s_t);
                    if (!kTwo) s_t = s_s + a.off5;
                    const float d_s = fvvdp::d_beta_log2<Math>(
                        cur.ch[0][k], cur.ch[1][k], s_s + a.lcorr, a.p, a.q[0], a.lc10, a.beta);
                    const float d_t = fvvdp::d_beta_log2<Math>(
                        cur.ch[2][k], cur.ch[3][k], s_t + a.lcorr, a.p, a.q[1], a.lc10, a.beta);
                    const bool live = kVec || k < n_live;
                    acc[0] += live ? d_s : 0.0f;
                    acc[1] += live ? d_t : 0.0f;
                }
            }
            fvvdp::frame_warp_sums(acc[0], acc[1], s_part, j);
            cur = nxt;
        }
        fvvdp::flush_frame_chunk(s_part, nf, f0, a.partials);
    }
}

template <bool kTwo, bool kLutShared, bool kVec>
int launch(const MovArgs& a, int n_blocks, int groups, float* out, cudaStream_t stream) {
    const size_t smem = kLutShared ? sizeof(float) * (kTwo ? 2 : 1) * a.n_e * a.se : 0;
    mov_score_kernel<kTwo, kLutShared, kVec>
        <<<dim3(n_blocks, groups), kThreads, smem, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fvvdp::sum_partials_kernel<<<a.F, fvvdp::kSumThreads, 0, stream>>>(a.partials, out,
                                                                       n_blocks);
    return static_cast<int>(cudaGetLastError());
}

template <bool kTwo, bool kLutShared>
int launch_arm(bool vec, const MovArgs& a, int n_blocks, int groups, float* out,
               cudaStream_t stream) {
    return vec ? launch<kTwo, kLutShared, true>(a, n_blocks, groups, out, stream)
               : launch<kTwo, kLutShared, false>(a, n_blocks, groups, out, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// band (F, 4, hw) contiguous; L: planes of hw floats at frame stride fs_L;
// vd (2, hw); t_r (hw); gaze (F, 2); V2s, V2t (n_e, ny * nr), V2t null for
// the one-table arm, which adds off5 to the sustained log2 sensitivity;
// partials scratch (F, n_blocks, 2); out (F, 2).  vec, lut_shared, n_blocks,
// frames_per_group and groups are the caller's launch plan
// (ops/cuda/mov_score.py:launch_plan): the arm with 16-byte loads, the LUT
// staged in shared memory, the blocks of 1,024 pixels and the split of the
// frames over grid.y.  A plan that does not fit the arguments is refused.
extern "C" int fvvdp_mov_score(const float* band, const float* L, const float* vd,
                               const float* t_r, const float* gaze, const float* V2s,
                               const float* V2t, float* partials, float* out, int F, int hw,
                               long long fs_L, int n_e, int ny, int nr, int vec, int lut_shared,
                               int n_blocks, int frames_per_group, int groups, float es0,
                               float inv_des, float emin, float emax, float off5, float y0,
                               float inv_dy, float Ymin, float Ymax, float p, float q_s,
                               float q_t, float lc10, float lcorr, float beta,
                               cudaStream_t stream) {
    if (F < 1 || hw < 1 || n_e < 1 || ny < 1 || nr < 1 ||
        (long long)n_e * ny * nr > (1LL << 28))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_blocks != (hw + kBlockPixels - 1) / kBlockPixels || frames_per_group < 1 ||
        groups != (F + frames_per_group - 1) / frames_per_group || groups > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool two = V2t != nullptr;
    if (lut_shared && 4LL * (two ? 2 : 1) * n_e * ny * nr > kMaxSharedLutBytes)
        return static_cast<int>(cudaErrorInvalidValue);
    if (vec && (hw % 4 != 0 || fs_L % 4 != 0 || !aligned16(band) || !aligned16(L) ||
                !aligned16(vd) || !aligned16(t_r)))
        return static_cast<int>(cudaErrorInvalidValue);
    MovArgs a{band, L, fs_L, vd, vd + hw, t_r, gaze, {V2s, V2t}, partials,
              F, hw, n_e, ny, nr, ny * nr, frames_per_group,
              y0, inv_dy, Ymin, Ymax, es0, inv_des, emin, emax, off5,
              p, {q_s, q_t}, lc10, lcorr, beta};
    if (two)
        return lut_shared ? launch_arm<true, true>(vec, a, n_blocks, groups, out, stream)
                          : launch_arm<true, false>(vec, a, n_blocks, groups, out, stream);
    return lut_shared ? launch_arm<false, true>(vec, a, n_blocks, groups, out, stream)
                      : launch_arm<false, false>(vec, a, n_blocks, groups, out, stream);
}
