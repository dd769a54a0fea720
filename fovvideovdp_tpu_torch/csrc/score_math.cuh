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
// No -use_fast_math: log2(0) = -inf and exp2(-inf) = 0 carry D(0,0) = 0, which
// the zero-filled transient channels of the image path rely on.  Two sets of
// transcendentals keep that (PreciseMath, ApproxMath below); a kernel names
// the one it scores with.
//
// Non-finite input: a NaN in, a NaN out.  Every clamp of the kernels is one
// of the forms below: the card's min / max instructions with the NaN
// qualifier, which return NaN when an operand is NaN, as torch.clamp and
// jnp.clip do (and as the TPU kernels do).  fminf / fmaxf would drop the NaN
// and score a broken pixel as a plausible number; a comparison and a select
// keep it too, but cost two instructions where these cost one.  For finite
// operands all three give the same bits.
#pragma once

#include <cuda_runtime.h>

namespace fvvdp {

// Burt-Adelson taps (float32 values of [.25 - a/2, .25, a, .25, .25 - a/2],
// a = 0.4), as the Python side's K5.
__device__ __forceinline__ float k5(int k) {
    return k == 2 ? 0.4f : ((k == 1 || k == 3) ? 0.25f : 0.05f);
}

// x clamped from below / from above / to [lo, hi]; NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
    float y;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(lo));
    return y;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
    float y;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(hi));
    return y;
}
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

// libdevice's log2f and exp2f: a polynomial of some 20 instructions and a
// range-checked ex2, within 1 and 2 ulp.
struct PreciseMath {
    static __device__ __forceinline__ float log2(float x) { return log2f(x); }
    static __device__ __forceinline__ float exp2(float x) { return exp2f(x); }
};

// The special-function unit's own instructions, one each: lg2 with an
// absolute error under 2^-22, ex2 and sqrt within 2 ulp and 1 ulp, the
// reciprocal within 1 ulp.  lg2(0) = -inf, ex2(-inf) = 0, sqrt(0) = 0, a NaN
// stays a NaN; subnormal operands and results count as 0, which moves a
// D^beta of 1e-38 to 0 and nothing else.  In log2 space 2^-22 is a relative
// 2e-7 of D, against the scorers' bar of 1e-4 on a frame's sum.
struct ApproxMath {
    static __device__ __forceinline__ float log2(float x) {
        float y;
        asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
        return y;
    }
    static __device__ __forceinline__ float exp2(float x) {
        float y;
        asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
        return y;
    }
    static __device__ __forceinline__ float sqrt(float x) {
        float y;
        asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
        return y;
    }
    static __device__ __forceinline__ float rcp(float x) {
        float y;
        asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
        return y;
    }
};

// D^beta of the mutual masking model in log2 space; T, R are contrasts and
// ls the per-pixel log2 of the normalisation (log2 sensitivity + log2 of
// the correction):
//   log2 D = p*(log2|T-R| + ls) - log2(1 + 2^(q*(log2 min(|T|,|R|) + ls + lc10)))
//   D^beta = 2^(beta * min(log2 D, log2 1e4))
// A NaN contrast makes |T-R| NaN, which the last clamp keeps.
template <class Math = PreciseMath>
__device__ __forceinline__ float d_beta_log2(float T, float R, float ls, float p,
                                             float q, float lc10, float beta) {
    const float la = Math::log2(fabsf(T - R)) + ls;
    const float lm = Math::log2(fminf(fabsf(T), fabsf(R))) + (ls + lc10);
    const float ld = p * la - Math::log2(1.0f + Math::exp2(q * lm));
    return Math::exp2(beta * clamp_max(ld, kLog2ClampD));
}

}  // namespace fvvdp
