// The int8 arithmetic that the int8 kernels share (conv_flat.cu, neck_flat.cu,
// conv_cmajor_q8.cu):
// requantization and the conv epilogue, in the JAX package's operation order
// and rounding. The sources that include it are compiled with --fmad=false,
// and the products and sums are written with explicit round-to-nearest
// intrinsics, so the results equal the plain PyTorch versions bit for bit:
// y = acc * (s_w * s_in) + bias, SiLU as y * (1 / (1 + exp(-y))) or ReLU as
// max(y, 0), int8 as clip(rint(y * (1/out_scale)), -127, 127).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Activation codes of the epilogue, as the wrappers pass them.
constexpr int ACT_NONE = 0;
constexpr int ACT_SILU = 1;
constexpr int ACT_RELU = 2;

// Output types (the wrappers' out_mode) and input types (in_type).
constexpr int OUT_I8 = 0;
constexpr int OUT_F32 = 1;
constexpr int OUT_BF16 = 2;
constexpr int IN_I8 = 0;
constexpr int IN_F32 = 1;
constexpr int IN_BF16 = 2;

// clip(rint(v * inv_s), -127, 127) without conversion instructions: the
// clamp to +-128 first leaves every in-range result as it was, rint is an
// add and a subtract of 1.5 * 2^23 (round to nearest even, exact for
// |q| <= 2^22), and the int is read from the bits of q + 1.5 * 2^23.
__device__ __forceinline__ int32_t quant1(float v, float inv_s) {
    float q = fminf(fmaxf(__fmul_rn(v, inv_s), -128.0f), 128.0f);
    q = __fadd_rn(__fadd_rn(q, 12582912.0f), -12582912.0f);
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    return __float_as_int(__fadd_rn(q, 12582912.0f)) - 0x4B400000;
}

// The epilogue with the scale product sws = s_w * s_in (rounded once) given.
__device__ __forceinline__ float epi_s(int32_t acc, float sws, float b,
                                       int act) {
    float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), sws), b);
    if (act == ACT_SILU) {
        // the correctly rounded reciprocal: 1 / x exactly as __fdiv_rn
        const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-y)));
        y = __fmul_rn(y, sig);
    } else if (act == ACT_RELU) {
        y = fmaxf(y, 0.0f);
    }
    return y;
}

__device__ __forceinline__ float epi(int32_t acc, float sw, float s_in, float b,
                                     int act) {
    return epi_s(acc, __fmul_rn(sw, s_in), b, act);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace
