// luminance: integer-coded colour frames -> float32 absolute luminance,
// (C, pixels) codes -> (pixels,) cd/m^2, C = 1 or 3.
//
// Replaces no TPU kernel: the JAX package leaves the decode, the EOTF and
// RGB -> Y to XLA, which fuses them into one pass
// (fovvideovdp_tpu/video_source.py:_luminance_cfirst).  In PyTorch the same
// arithmetic is about 13 float32 passes over each channel, some 300 B a
// pixel against the 7 the work needs.
//
// Semantics: for uint8 codes, and 16-bit codes stored as int16 (read here as
// unsigned), the decode, the clip, the EOTF and the channel weight are a
// function of the stored code alone.  The wrapper tabulates that function
// on the card with the plain version's own torch calls
// (ops/cuda/luminance.py:tables), T_c[v] = dm.forward(decode(v)) * w_c, so
// each entry is what the plain version computes for that code.  Each pixel
// is L = T_0[r]; L = L + T_1[g]; L = L + T_2[b] (L = T_0[v] for grey), the
// plain version's order of additions, each rounded on its own
// (__fadd_rn), so the result equals the plain version bit for bit.
//
// Bound on this card: memory bytes (each code read once, each float32
// written once: 7 B a pixel for uint8 RGB; a pixel's byte extractions and
// three lookups are a few instructions).  Design:
// the wrapper reduces the view's strides to rows of pixels (row r, pixel j:
// element r * row_stride + j * pixel_stride + c * channel_stride), so a
// planar (C, n, H, W) block and an interleaved (n, H, W, C) chunk are both
// read in place.  A thread owns groups of 4 pixels, 4 groups in flight,
// and loads each group as 32-bit words: one per plane for uint8 planes, 3
// for 4 interleaved uint8 RGB pixels (12 bytes), twice that for 16-bit
// codes, all issued before any lookup.  It stores the group's 4 outputs as
// one 16-byte store.  The uint8 tables (3 KB) sit in shared memory; the
// 16-bit tables (768 KB) are read through __ldg from L2.  A group cut by
// the end of the pixels takes the scalar path, which reads one code at a
// time through the full strides; so does every group of the scalar arm
// (a view whose words are not 4-byte aligned, or rows of a length off a
// multiple of 4).  A grid-stride loop over enough blocks to fill the 132
// SMs.
//
// The launch plan (layout, arm, grid) is decided in Python
// (ops/cuda/luminance.py:launch_plan); the entry point refuses a plan that
// contradicts its arguments.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupsPerThread = 4;    // groups of 4 pixels in flight per thread
constexpr int kMinBlocksPerSM = 4;

// element k of a little-endian run of 32-bit words holding codes of type T
template <typename T>
__device__ __forceinline__ unsigned element(const unsigned* w, int k) {
    if constexpr (sizeof(T) == 1)
        return (w[k >> 2] >> ((k & 3) * 8)) & 0xFFu;
    else
        return (w[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu;
}

template <typename T>
struct Tables {
    const float* global;                 // C tables of 2^(8 sizeof(T)) entries
    const float* shared;                 // the same in shared memory (uint8 only)

    __device__ __forceinline__ float at(int c, unsigned v) const {
        if constexpr (sizeof(T) == 1)
            return shared[(c << 8) + v];
        else
            return __ldg(global + static_cast<size_t>(c) * 65536 + v);
    }
};

template <typename T, int C>
__device__ __forceinline__ float lum(const Tables<T>& tab, const unsigned (&v)[C]) {
    float L = tab.at(0, v[0]);
#pragma unroll
    for (int c = 1; c < C; ++c) L = __fadd_rn(L, tab.at(c, v[c]));
    return L;
}

struct Layout {
    long long rows, row_len, row_stride, pixel_stride, channel_stride;

    // element offset of pixel p's channel 0
    __device__ __forceinline__ long long offset(long long p) const {
        if (rows == 1) return p * pixel_stride;
        const long long r = p / row_len;
        return r * row_stride + (p - r * row_len) * pixel_stride;
    }
};

template <typename T, int C>
__device__ __forceinline__ float pixel(const T* __restrict__ x, const Tables<T>& tab,
                                       const Layout& lay, long long p) {
    const T* px = x + lay.offset(p);
    unsigned v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(px + c * lay.channel_stride);
    return lum<T, C>(tab, v);
}

// kVec: groups of 4 pixels as 32-bit words (planar: pixel_stride 1, each
// plane's words 4-byte aligned; kInterleaved: pixel_stride C,
// channel_stride 1), rows a multiple of 4 pixels long or a single row
template <typename T, int C, bool kInterleaved, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
luminance_kernel(const T* __restrict__ x, const float* __restrict__ tables,
                 float* __restrict__ out, long long n, Layout lay) {
    __shared__ float stab[sizeof(T) == 1 ? C * 256 : 1];
    if constexpr (sizeof(T) == 1) {
        for (int i = threadIdx.x; i < C * 256; i += kThreads) stab[i] = __ldg(tables + i);
        __syncthreads();
    }
    const Tables<T> tab{tables, stab};
    // words a stream of one group takes, and the streams (planes) of a group
    constexpr int kWords = (kInterleaved ? C : 1) * static_cast<int>(sizeof(T));
    constexpr int kStreams = kInterleaved ? 1 : C;
    const long long groups = (n + 3) / 4;
    const long long step = static_cast<long long>(gridDim.x) * kThreads * kGroupsPerThread;
    for (long long g0 = static_cast<long long>(blockIdx.x) * kThreads * kGroupsPerThread +
                        threadIdx.x;
         g0 < groups; g0 += step) {
        if (kVec) {
            unsigned w[kGroupsPerThread][kStreams][kWords];
#pragma unroll
            for (int k = 0; k < kGroupsPerThread; ++k) {
                const long long p = 4 * (g0 + k * kThreads);
                if (p + 4 > n) continue;
                const T* px = x + lay.offset(p);
#pragma unroll
                for (int s = 0; s < kStreams; ++s) {
                    const unsigned* wp =
                        reinterpret_cast<const unsigned*>(px + s * lay.channel_stride);
#pragma unroll
                    for (int i = 0; i < kWords; ++i) w[k][s][i] = __ldg(wp + i);
                }
            }
#pragma unroll
            for (int k = 0; k < kGroupsPerThread; ++k) {
                const long long p = 4 * (g0 + k * kThreads);
                if (p >= n) continue;
                if (p + 4 > n) {
                    // the ragged end of the pixels
                    for (long long q = p; q < n; ++q) out[q] = pixel<T, C>(x, tab, lay, q);
                    continue;
                }
                float o[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    unsigned v[C];
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        if constexpr (kInterleaved)
                            v[c] = element<T>(w[k][0], C * j + c);
                        else
                            v[c] = element<T>(w[k][c], j);
                    }
                    o[j] = lum<T, C>(tab, v);
                }
                *reinterpret_cast<float4*>(out + p) = make_float4(o[0], o[1], o[2], o[3]);
            }
        } else {
#pragma unroll
            for (int k = 0; k < kGroupsPerThread; ++k) {
                const long long p = 4 * (g0 + k * kThreads);
                for (long long q = p; q < p + 4 && q < n; ++q)
                    out[q] = pixel<T, C>(x, tab, lay, q);
            }
        }
    }
}

template <typename T, int C>
void launch(const void* x, const float* tables, float* out, long long n, const Layout& lay,
            bool interleaved, bool vec, int blocks, cudaStream_t stream) {
    const T* xs = static_cast<const T*>(x);
    auto kernel = vec ? luminance_kernel<T, C, false, true> : luminance_kernel<T, C, false, false>;
    if constexpr (C == 3)
        if (vec && interleaved) kernel = luminance_kernel<T, C, true, true>;
    kernel<<<blocks, kThreads, 0, stream>>>(xs, tables, out, n, lay);
}

bool aligned(const void* p, long long bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan fits the arguments: rows that cover the pixels, one or three
// channels of 1- or 2-byte codes, a grid of at least one block and, on the
// vector arm, the layout and alignment its word loads and 16-byte stores
// need.
bool plan_fits(const void* x, const float* out, long long n, const Layout& lay,
               int channels, int elem_bytes, int interleaved, int vec, int blocks) {
    if (n < 1 || lay.rows < 1 || lay.row_len < 1 || lay.rows * lay.row_len != n) return false;
    if (channels != 1 && channels != 3) return false;
    if (elem_bytes != 1 && elem_bytes != 2) return false;
    if (blocks < 1) return false;
    if (!vec) return true;
    if (lay.rows > 1 && (lay.row_len % 4 != 0 || lay.row_stride * elem_bytes % 4 != 0))
        return false;
    if (!aligned(out, 16)) return false;
    const char* base = static_cast<const char*>(x);
    if (interleaved)
        return channels == 3 && lay.pixel_stride == 3 && lay.channel_stride == 1 &&
               aligned(base, 4);
    if (lay.pixel_stride != 1) return false;
    for (int c = 0; c < channels; ++c)
        if (!aligned(base + c * lay.channel_stride * elem_bytes, 4)) return false;
    return true;
}

}  // namespace

extern "C" int fvvdp_luminance(const void* x, const float* tables, float* out, long long n,
                               long long rows, long long row_len, long long row_stride,
                               long long pixel_stride, long long channel_stride, int channels,
                               int elem_bytes, int interleaved, int vec, int blocks,
                               cudaStream_t stream) {
    const Layout lay{rows, row_len, row_stride, pixel_stride, channel_stride};
    if (!plan_fits(x, out, n, lay, channels, elem_bytes, interleaved, vec, blocks))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool il = interleaved != 0, v = vec != 0;
    if (elem_bytes == 1) {
        if (channels == 3)
            launch<uint8_t, 3>(x, tables, out, n, lay, il, v, blocks, stream);
        else
            launch<uint8_t, 1>(x, tables, out, n, lay, il, v, blocks, stream);
    } else {
        if (channels == 3)
            launch<uint16_t, 3>(x, tables, out, n, lay, il, v, blocks, stream);
        else
            launch<uint16_t, 1>(x, tables, out, n, lay, il, v, blocks, stream);
    }
    return static_cast<int>(cudaGetLastError());
}
