// Per-pixel scoring math shared by the band kernels (device functions).
//
// Replaces the in-kernel helpers of the TPU package,
// fovvideovdp_tpu/ops/pallas/score_math.py: `table_interp_delta_dyn` (the
// CSF table lookup) and `d_beta_log2` (mutual masking in log2 space).
// The TPU form telescopes the table into per-knot deltas over a dynamic
// knot window because its vector unit cannot gather; Hopper reads the two
// neighbouring knots from shared memory directly, which gives the same
// piecewise-linear value up to rounding.
//
// No fast-math: log2f(0) = -inf and exp2f(-inf) = 0 carry D(0,0) = 0, which
// the zero-filled transient channels of the image path rely on.
//
// Non-finite input: a NaN in, a NaN out.  Every clamp of the kernels is one
// of the comparison forms below, which keep a NaN operand as torch.clamp and
// jnp.clip do (and as the TPU kernels do); fminf / fmaxf would drop it and
// score a broken pixel as a plausible number.  For finite operands the two
// forms give the same bits.
#pragma once

#include <cuda_runtime.h>

namespace fvvdp {

// Burt-Adelson taps (float32 values of [.25 - a/2, .25, a, .25, .25 - a/2],
// a = 0.4), as the Python side's K5.
__device__ __forceinline__ float k5(int k) {
    return k == 2 ? 0.4f : ((k == 1 || k == 3) ? 0.25f : 0.05f);
}

// x clamped from below / from above / to [lo, hi]; NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return clamp_max(clamp_min(x, lo), hi);
}

// log2(1e4): the masking model clamps D at 1e4.
constexpr float kLog2ClampD = 13.287712379549449f;

// Piecewise-linear lookup of a table on a uniform grid at coordinate u
// (already clamped to [0, n-1]): t[i0] * (1 - f) + t[i1] * f.
__device__ __forceinline__ float table_interp(const float* tab, int n, float u) {
    int i0 = static_cast<int>(floorf(u));
    i0 = min(max(i0, 0), n - 1);
    const int i1 = min(i0 + 1, n - 1);
    const float f = u - static_cast<float>(i0);
    return tab[i0] * (1.0f - f) + tab[i1] * f;
}

// The knot pair and fraction of that lookup, for callers that read several
// tables (or a strided one) at the same coordinate.
__device__ __forceinline__ void table_knots(float u, int n, int* i0, int* i1, float* f) {
    const int k = min(max(static_cast<int>(floorf(u)), 0), n - 1);
    *i0 = k;
    *i1 = min(k + 1, n - 1);
    *f = u - static_cast<float>(k);
}

// D^beta of the mutual masking model in log2 space; T, R are contrasts and
// ls the per-pixel log2 of the normalisation (log2 sensitivity + log2 of
// the correction):
//   log2 D = p*(log2|T-R| + ls) - log2(1 + 2^(q*(log2 min(|T|,|R|) + ls + lc10)))
//   D^beta = 2^(beta * min(log2 D, log2 1e4))
// A NaN contrast makes |T-R| NaN, which the last clamp keeps.
__device__ __forceinline__ float d_beta_log2(float T, float R, float ls, float p,
                                             float q, float lc10, float beta) {
    const float la = log2f(fabsf(T - R)) + ls;
    const float lm = log2f(fminf(fabsf(T), fabsf(R))) + (ls + lc10);
    const float ld = p * la - log2f(1.0f + exp2f(q * lm));
    return exp2f(beta * clamp_max(ld, kLog2ClampD));
}

}  // namespace fvvdp
