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
// which every frame of the block shares; the LUT window is a few KB.
// Against that stand 13 log2/exp2/sqrt per pixel-frame and 16 shared-memory
// loads, each under half the bytes' time.
//
// Design.  As band_score.cu: a block owns 256 consecutive pixels of the
// flattened plane, one per thread, and walks its frames inside the kernel,
// so the three static planes are read once per block of frames (once per
// group where a small level splits its frames over grid.y) and every load of
// the band is coalesced.  The block stages the LUT window once in shared
// memory (2 x 32 x 19 x 4 floats = 19.5 KB on the shipped calibration);
// neighbouring pixels sit in the same or the next LUT cell, so a warp's
// gathers mostly broadcast.  A LUT too large for that (no window, a user LUT
// with more knots: 2 x 32^3 floats = 262 KB) is read from global memory
// through the read-only path instead, where it stays in L2: the same kernel
// with kLutShared = false.  The gaze directions (F, 2) are a device tensor;
// a frame's pair is one broadcast load.  The per-frame sums go through the
// two passes of partials.cuh.  No atomics.  A NaN in the gaze, L_bkg or the
// contrast gives a NaN sum for that frame (score_math.cuh).
#include <cuda_runtime.h>

#include "partials.cuh"
#include "score_math.cuh"

namespace {

using fvvdp::kFrameChunk;
constexpr int kThreads = fvvdp::kPixelThreads;
// Largest LUT (both tables) staged in shared memory.  With the 2 KB of frame
// sums this stays inside the 48 KB a block has without opting in, and
// several blocks still share an SM.
constexpr int kMaxSharedLutBytes = 40 * 1024;

struct MovArgs {
    const float* ch[4];   // T-sust, R-sust, T-trans, R-trans planes of frame 0
    long long fs;         // their frame stride, in floats
    const float* L;       // (F, hw) background luminance
    long long L_fs;
    const float* vd0;     // (hw) view direction, horizontal, degrees
    const float* vd1;     // (hw) vertical
    const float* t_r;     // (hw) rho coordinate in the window
    const float* gaze;    // (F, 2) gaze view directions, degrees
    const float* V[2];    // (n_e, ny, nr) each; V[1] unused when !kTwo
    float* partials;      // (F, n_blocks, 2)
    int F, hw, n_e, ny, nr, frames_per_group;
    float y0, dy, Ymin, Ymax, es0, des, emin, emax, off5;
    float p, q[2], lc10, lcorr, beta;
};

template <bool kLutShared>
__device__ __forceinline__ float lut_at(const float* V, int i) {
    return kLutShared ? V[i] : __ldg(V + i);
}

// Trilinear value of one table: row[e][y] are the offsets of the four
// (ecc, Y) knot rows, r0 / r1 the rho knot pair inside a row.
template <bool kLutShared>
__device__ __forceinline__ float trilinear(const float* V, const int (&row)[2][2], int r0,
                                           int r1, float fe, float fy, float fr) {
    float ve[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        float vy[2];
#pragma unroll
        for (int y = 0; y < 2; ++y)
            vy[y] = lut_at<kLutShared>(V, row[e][y] + r0) * (1.0f - fr)
                    + lut_at<kLutShared>(V, row[e][y] + r1) * fr;
        ve[e] = vy[0] * (1.0f - fy) + vy[1] * fy;
    }
    return ve[0] * (1.0f - fe) + ve[1] * fe;
}

template <bool kTwo, bool kLutShared>
__global__ void __launch_bounds__(kThreads) mov_score_kernel(MovArgs a) {
    extern __shared__ float s_lut[];   // kLutShared: [1 or 2][n_e * ny * nr]
    __shared__ fvvdp::FrameSums s_part;

    const int tid = threadIdx.x;
    const int n_lut = a.n_e * a.ny * a.nr;
    const long long pix = (long long)blockIdx.x * kThreads + tid;
    const bool live = pix < a.hw;

    const float* V[2] = {a.V[0], a.V[1]};
    if (kLutShared) {
        for (int i = tid; i < n_lut; i += kThreads) s_lut[i] = a.V[0][i];
        if (kTwo)
            for (int i = tid; i < n_lut; i += kThreads) s_lut[n_lut + i] = a.V[1][i];
        __syncthreads();
        V[0] = s_lut;
        V[1] = s_lut + n_lut;
    }

    // static per pixel: view direction and the rho knot pair
    float vd0 = 0.0f, vd1 = 0.0f, fr = 0.0f;
    int r0 = 0, r1 = 0;
    if (live) {
        vd0 = a.vd0[pix];
        vd1 = a.vd1[pix];
        fvvdp::table_knots(a.t_r[pix], a.nr, &r0, &r1, &fr);
    }

    const int f_begin = blockIdx.y * a.frames_per_group;
    const int f_end = min(a.F, f_begin + a.frames_per_group);
    for (int f0 = f_begin; f0 < f_end; f0 += kFrameChunk) {
        const int nf = min(kFrameChunk, f_end - f0);
#pragma unroll 2
        for (int j = 0; j < nf; ++j) {
            const long long f = f0 + j;
            float acc[2] = {0.0f, 0.0f};
            if (live) {
                const float dx = vd0 - __ldg(a.gaze + 2 * f);
                const float dv = vd1 - __ldg(a.gaze + 2 * f + 1);
                const float ecc = sqrtf(dx * dx + dv * dv);
                float te = (sqrtf(fvvdp::clampf(ecc, a.emin, a.emax)) - a.es0) / a.des;
                te = fvvdp::clampf(te, 0.0f, static_cast<float>(a.n_e - 1));
                const float L = a.L[f * a.L_fs + pix];
                float u = (log2f(fvvdp::clampf(L, a.Ymin, a.Ymax)) - a.y0) / a.dy;
                u = fvvdp::clampf(u, 0.0f, static_cast<float>(a.ny - 1));
                int ie0, ie1, iy0, iy1;
                float fe, fy;
                fvvdp::table_knots(te, a.n_e, &ie0, &ie1, &fe);
                fvvdp::table_knots(u, a.ny, &iy0, &iy1, &fy);
                const int row[2][2] = {
                    {(ie0 * a.ny + iy0) * a.nr, (ie0 * a.ny + iy1) * a.nr},
                    {(ie1 * a.ny + iy0) * a.nr, (ie1 * a.ny + iy1) * a.nr}};
                const float s_s = trilinear<kLutShared>(V[0], row, r0, r1, fe, fy, fr);
                const float s_t = kTwo ? trilinear<kLutShared>(V[1], row, r0, r1, fe, fy, fr)
                                       : s_s + a.off5;
                const float ls[2] = {s_s + a.lcorr, s_t + a.lcorr};
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const float T = a.ch[2 * c][f * a.fs + pix];
                    const float R = a.ch[2 * c + 1][f * a.fs + pix];
                    acc[c] = fvvdp::d_beta_log2(T, R, ls[c], a.p, a.q[c], a.lc10, a.beta);
                }
            }
            fvvdp::frame_warp_sums(acc[0], acc[1], s_part, j);
        }
        fvvdp::flush_frame_chunk(s_part, nf, f0, a.partials);
    }
}

bool lut_fits_shared(int n_e, int ny, int nr, int two) {
    const long long bytes = 4LL * (two ? 2 : 1) * n_e * ny * nr;
    return bytes <= kMaxSharedLutBytes;
}

template <bool kTwo, bool kLutShared>
int launch(const MovArgs& a, int n_blocks, int groups, float* out, cudaStream_t stream) {
    const size_t smem =
        kLutShared ? sizeof(float) * (kTwo ? 2 : 1) * a.n_e * a.ny * a.nr : 0;
    mov_score_kernel<kTwo, kLutShared><<<dim3(n_blocks, groups), kThreads, smem, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fvvdp::sum_partials_kernel<<<a.F, fvvdp::kSumThreads, 0, stream>>>(a.partials, out,
                                                                       n_blocks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a LUT window of these sizes is staged in shared memory, 0 when the
// kernel reads it from global memory
extern "C" int fvvdp_mov_score_lut_in_shared(int n_e, int ny, int nr, int two) {
    return lut_fits_shared(n_e, ny, nr, two) ? 1 : 0;
}

// band (F, 4, hw) contiguous; L: planes of hw floats at frame stride fs_L;
// vd (2, hw); t_r (hw); gaze (F, 2); V2s, V2t (n_e, ny * nr), V2t null for
// the one-table arm, which adds off5 to the sustained log2 sensitivity;
// partials scratch (F, n_blocks, 2) with n_blocks = fvvdp_band_score_n_blocks(hw)
// (partials.cuh: pixel_blocks_of); out (F, 2).
extern "C" int fvvdp_mov_score(const float* band, const float* L, const float* vd,
                               const float* t_r, const float* gaze, const float* V2s,
                               const float* V2t, float* partials, float* out, int F, int hw,
                               long long fs_L, int n_e, int ny, int nr, float es0, float des,
                               float emin, float emax, float off5, float y0, float dy,
                               float Ymin, float Ymax, float p, float q_s, float q_t,
                               float lc10, float lcorr, float beta, cudaStream_t stream) {
    if (F < 1 || hw < 1 || n_e < 1 || ny < 1 || nr < 1 ||
        (long long)n_e * ny * nr > (1LL << 28))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool two = V2t != nullptr;
    MovArgs a{{band, band + hw, band + 2LL * hw, band + 3LL * hw}, 4LL * hw, L, fs_L,
              vd, vd + hw, t_r, gaze, {V2s, V2t}, partials, F, hw, n_e, ny, nr, 0,
              y0, dy, Ymin, Ymax, es0, des, emin, emax, off5, p, {q_s, q_t}, lc10, lcorr,
              beta};
    const int n_blocks = fvvdp::pixel_blocks_of(hw);
    int groups;
    fvvdp::frame_groups(n_blocks, F, &a.frames_per_group, &groups);
    if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const bool shared = lut_fits_shared(n_e, ny, nr, two ? 1 : 0);
    if (two)
        return shared ? launch<true, true>(a, n_blocks, groups, out, stream)
                      : launch<true, false>(a, n_blocks, groups, out, stream);
    return shared ? launch<false, true>(a, n_blocks, groups, out, stream)
                  : launch<false, false>(a, n_blocks, groups, out, stream);
}
