// The int8 arithmetic that the int8 kernels share (conv_flat.cu, neck_flat.cu):
// requantization and the conv epilogue, in the JAX package's operation order
// and rounding. The sources that include it are compiled with --fmad=false,
// and the products and sums are written with explicit round-to-nearest
// intrinsics, so the results equal the plain PyTorch versions bit for bit:
// y = acc * (s_w * s_in) + bias, SiLU as y * (1 / (1 + exp(-y))), int8 as
// clip(rint(y * (1/out_scale)), -127, 127).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int32_t quant1(float v, float inv_s) {
    float q = rintf(__fmul_rn(v, inv_s));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    return (int32_t)q;
}

__device__ __forceinline__ float epi(int32_t acc, float sw, float s_in, float b,
                                     int act) {
    float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sw, s_in)), b);
    if (act) {
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
        y = __fmul_rn(y, sig);
    }
    return y;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace
