// The check of csrc/pow_nonneg.cuh against powf, built only by the tests
// (tests/test_torch_yuv_luminance.py::test_kernel_powf_is_powf_on_every_float):
// for each of the three exponents as csrc/yuv_luminance.cu uses them, the
// floats x in [0, 2] (every bit pattern from 0 to 2.0) where pow_nonneg(x, y)
// and powf(x, y) differ.
#include <cuda_runtime.h>

#include "pow_nonneg.cuh"

namespace {

__global__ void pow_check_kernel(unsigned long long* __restrict__ mismatches) {
    const unsigned last = 0x40000000u;
    unsigned bad[3] = {0, 0, 0};
    for (unsigned b = blockIdx.x * blockDim.x + threadIdx.x; b <= last;
         b += gridDim.x * blockDim.x) {
        const float x = __uint_as_float(b);
        bad[0] += __float_as_uint(pow_nonneg<true>(x, kSrgbExp)) != __float_as_uint(powf(x, kSrgbExp));
        bad[1] += __float_as_uint(pow_nonneg<false>(x, kPqInvM)) != __float_as_uint(powf(x, kPqInvM));
        bad[2] += __float_as_uint(pow_nonneg<true>(x, kPqInvN)) != __float_as_uint(powf(x, kPqInvN));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
        if (bad[k]) atomicAdd(mismatches + k, static_cast<unsigned long long>(bad[k]));
}

}  // namespace

// three counts into mismatches (device memory, zeroed by the caller), for
// 2.4, 1 / m, 1 / n
extern "C" int fvvdp_pow_nonneg_mismatches(unsigned long long* mismatches, cudaStream_t stream) {
    pow_check_kernel<<<1056, 256, 0, stream>>>(mismatches);
    return static_cast<int>(cudaGetLastError());
}
