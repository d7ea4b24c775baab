// Channel-major int8 convolutions, for Hopper.
//
// K13 conv3x3_cmajor_q8 replaces rep_yolo_tpu/ops/pallas/conv_kernel.py:
// conv3x3_cmajor_q8 (kernel _conv3_q8_kernel): a 3x3 stride-1 conv with zero
// padding 1 on an input quantized at s_in while it is staged (or arriving as
// int8), s32 sums, then y = acc * (s_w * s_in) + bias and SiLU, ReLU or
// nothing (q8_common.cuh), stored as bfloat16 (one rounding of the float32
// value, the JAX y.astype(bf16)) or as int8 at out_scale.
// K14 conv1x1_cmajor_q8 replaces conv_kernel.py:conv1x1_cmajor_q8
// (_conv1_q8_kernel): the same as a 1x1, over 1-3 input sections read in
// place of their concat (as K11 does), all quantized at one s_in or all int8.
//
// Layout: NCHW (B, C, H, W), as the JAX contract has it; the input is int8,
// float32 or bfloat16 (widened exactly to float32, then quantized). The
// weights are int8 per output channel (ops/quant.quantize_weights), packed
// once by the wrapper (ops/kernels/conv_kernel.py) with the output channels
// padded to a multiple of BM = 32 and the input channels to a multiple of 32,
// all with zeros (exact).
//
// Both are implicit GEMMs on the int8 tensor cores, as K10 is on the bf16
// ones: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, M = output
// channels, N = output pixels, K = taps x input channels, one k-step per tap
// and 32 input channels. A block of 4 warps computes 32 output channels x 128
// pixels (3x3: an 8 x 16 tile of the map, 1x1: 128 consecutive pixels of
// H*W); each warp holds 32 channels x 32 pixels of s32 sums (2 x 4
// fragments). Per chunk of input channels the block stages the input tile
// (3x3: with its one-pixel halo, zero outside the map) as 32-bit words of
// four channels of one pixel, quantizing float input on the way, so that one
// B fragment register is one shared load; the plane and weight-row pitches
// make the fragment loads free of bank conflicts. s32 sums do not depend on
// their order, so the result is exact against the plain version whatever the
// tile order.
//
// Bound on this card: 2 * MACs int8 operations over 1,979 TOP/s against the
// bytes of the input (1, 2 or 4 a value), the weights and the output; at
// kernel_bench's shapes (C, O = 24-1024 at 20-320 px) most calls are bound by
// their bytes. This simple version stages without double buffering, loads
// the input a value at a time from four channel planes, re-reads the 3x3
// halo (1.4x), pads C to a multiple of 32 (C = 24 and 48 do a third more
// MACs) and O to 32 (O = 24 under-fills a tile); wgmma with TMA-staged tiles
// is later work. The TPU kernel's KP = round_up(9C, 32), its 128-lane row
// pitch and its row tiles were Mosaic's constraints and have no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_common.cuh"

namespace {

constexpr int NT = 128;               // threads per block: 4 warps
constexpr int BM = 32;                // output channels per block
constexpr int TH = 8;                 // 3x3 output tile: 8 rows x 16 columns
constexpr int TW = 16;
constexpr int SH = TH + 2;            // the halo'd input tile
constexpr int SW = TW + 2;
constexpr int TP = 128;               // 1x1: pixels per block
constexpr int KQ = 32;                // input channels per k-step
constexpr int PLANE3 = 200;           // words per channel quad of the 3x3 tile
                                      // (>= SH*SW, 8 mod 32: conflict-free)
constexpr int WCH3 = 9 * KQ / 4;      // words of one output channel's chunk
constexpr int WROW3 = WCH3 + 4;       // its row pitch in shared memory: 76
constexpr int KC1 = 64;               // 1x1: input channels per stage
constexpr int PLANE1 = TP + 8;        // 136 words, 8 mod 32
constexpr int WROW1 = KC1 / 4 + 4;    // 20 words

// input types and output modes, as the wrapper passes them
constexpr int IN_I8 = 0;
constexpr int IN_F32 = 1;
constexpr int IN_BF16 = 2;
constexpr int OUT_I8 = 0;
constexpr int OUT_BF16 = 2;

__device__ __forceinline__ void mma_s8(int32_t* d, const uint32_t* a,
                                       const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The int8 byte of element i of x: as it is, or quantized at 1 / inv_s.
// The input type is a template parameter: this load is the staging loop,
// which bounds these kernels.
template <int IN>
__device__ __forceinline__ uint32_t load_q(const void* x, long long i,
                                           float inv_s) {
    if (IN == IN_I8) return (uint32_t)(uint8_t)((const int8_t*)x)[i];
    const float v = IN == IN_F32 ? ((const float*)x)[i]
                                 : __bfloat162float(((const __nv_bfloat16*)x)[i]);
    return (uint32_t)(quant1(v, inv_s) & 0xff);
}

// Two neighbouring pixels of one output channel: the epilogue of both, then
// one store (a pair when both exist and the pair is aligned).
__device__ __forceinline__ void store2(void* y, long long i, bool two,
                                       bool pair, int32_t a0, int32_t a1,
                                       float sw, float s_in, float b, int act,
                                       float inv_out, int out_mode) {
    const float v0 = epi(a0, sw, s_in, b, act);
    const float v1 = epi(a1, sw, s_in, b, act);
    if (out_mode == OUT_BF16) {
        __nv_bfloat16* dst = (__nv_bfloat16*)y + i;
        if (two && pair) {
            __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(dst) = v;
        } else {
            dst[0] = __float2bfloat16_rn(v0);
            if (two) dst[1] = __float2bfloat16_rn(v1);
        }
    } else {
        int8_t* dst = (int8_t*)y + i;
        const uint32_t q0 = (uint32_t)(quant1(v0, inv_out) & 0xff);
        const uint32_t q1 = (uint32_t)(quant1(v1, inv_out) & 0xff);
        if (two && pair) {
            *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(q0 | (q1 << 8));
        } else {
            dst[0] = (int8_t)q0;
            if (two) dst[1] = (int8_t)q1;
        }
    }
}

// ---------------------------------------------------------------------------
// K13: 3x3, stride 1, pad 1
// ---------------------------------------------------------------------------

// x (B, C, H, W); w (Opad, nchunks, 9, 32) int8 read as words, tap = u*3 + v;
// grid (tiles, Opad / 32, B).
template <int IN>
__global__ void __launch_bounds__(NT)
conv3x3_q8_cm_kernel(const void* __restrict__ x, const uint32_t* __restrict__ w,
                     const float* __restrict__ s_w, const float* __restrict__ bias,
                     void* __restrict__ y, int C, int H, int W, int O,
                     int nchunks, int tiles_x, float s_in, float inv_s_in,
                     float inv_out, int act, int out_mode) {
    __shared__ uint32_t s_x[KQ / 4 * PLANE3];
    __shared__ __align__(16) uint32_t s_wt[BM * WROW3];

    const int ob = blockIdx.y, b = blockIdx.z;
    const int ty0 = (blockIdx.x / tiles_x) * TH;
    const int tx0 = (blockIdx.x % tiles_x) * TW;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long HW = (long long)H * W;
    const long long xb = (long long)b * C * HW;
    const uint32_t* wb = w + (long long)ob * BM * nchunks * WCH3;

    int32_t acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int ch = 0; ch < nchunks; ++ch) {
        const int c0 = ch * KQ;
        __syncthreads();
        for (int e = tid; e < KQ / 4 * SH * SW; e += NT) {
            const int q = e / (SH * SW), rem = e - q * (SH * SW);
            const int r = rem / SW, col = rem - r * SW;
            const int gy = ty0 - 1 + r, gx = tx0 - 1 + col;
            uint32_t word = 0;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
                const long long base = xb + (long long)gy * W + gx;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int c = c0 + 4 * q + k;
                    if (c < C)
                        word |= load_q<IN>(x, base + (long long)c * HW, inv_s_in)
                                << (8 * k);
                }
            }
            s_x[q * PLANE3 + r * SW + col] = word;
        }
        for (int e = tid; e < BM * (WCH3 / 4); e += NT) {
            const int o = e / (WCH3 / 4), j = e - o * (WCH3 / 4);
            reinterpret_cast<uint4*>(s_wt + o * WROW3)[j] =
                reinterpret_cast<const uint4*>(
                    wb + ((long long)o * nchunks + ch) * WCH3)[j];
        }
        __syncthreads();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int u = tap / 3, v = tap - 3 * u;
            uint32_t a[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t* r0 = s_wt + (i * 16 + g) * WROW3 + tap * (KQ / 4) + t;
                const uint32_t* r8 = r0 + 8 * WROW3;
                a[i][0] = r0[0];
                a[i][1] = r8[0];
                a[i][2] = r0[4];
                a[i][3] = r8[4];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int pr = 2 * warp + (j >> 1), pc = (j & 1) * 8 + g;
                const uint32_t* sp = s_x + (pr + u) * SW + pc + v;
                const uint32_t bf[2] = {sp[t * PLANE3], sp[(t + 4) * PLANE3]};
                mma_s8(acc[0][j], a[0], bf);
                mma_s8(acc[1][j], a[1], bf);
            }
        }
    }

    const bool pair = (W & 1) == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int oy = ty0 + 2 * warp + (j >> 1);
            const int ox = tx0 + (j & 1) * 8 + t * 2;
            if (oy >= H || ox >= W) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = ob * BM + i * 16 + g + h * 8;
                if (o >= O) continue;
                store2(y, ((long long)b * O + o) * HW + (long long)oy * W + ox,
                       ox + 1 < W, pair, acc[i][j][2 * h], acc[i][j][2 * h + 1],
                       s_w[o], s_in, bias[o], act, inv_out, out_mode);
            }
        }
}

// ---------------------------------------------------------------------------
// K14: 1x1 over 1-3 sections
// ---------------------------------------------------------------------------

// The quantized byte of channel c (of the concat) at pixel pix of image b.
template <int IN>
__device__ __forceinline__ uint32_t load_sec(const void* x0, const void* x1,
                                             const void* x2, int C0, int C1,
                                             int C2, int b, int c, long long HW,
                                             long long pix, float inv_s) {
    if (c < C0) return load_q<IN>(x0, ((long long)b * C0 + c) * HW + pix, inv_s);
    c -= C0;
    if (c < C1) return load_q<IN>(x1, ((long long)b * C1 + c) * HW + pix, inv_s);
    c -= C1;
    return load_q<IN>(x2, ((long long)b * C2 + c) * HW + pix, inv_s);
}

// Sections x0..x2 (B, C_s, H, W); w (Opad, Kp) int8, Kp = C0 + C1 + C2
// rounded up to 32; grid (ceil(HW / 128), Opad / 32, B).
template <int IN>
__global__ void __launch_bounds__(NT)
conv1x1_q8_cm_kernel(const void* __restrict__ x0, const void* __restrict__ x1,
                     const void* __restrict__ x2, int C0, int C1, int C2,
                     const int8_t* __restrict__ w, const float* __restrict__ s_w,
                     const float* __restrict__ bias, void* __restrict__ y,
                     long long HW, int O, int Kp, float s_in, float inv_s_in,
                     float inv_out, int act, int out_mode) {
    __shared__ uint32_t s_x[KC1 / 4 * PLANE1];
    __shared__ __align__(16) uint32_t s_wt[BM * WROW1];

    const int ob = blockIdx.y, b = blockIdx.z;
    const long long p0 = (long long)blockIdx.x * TP;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int Ct = C0 + C1 + C2;

    int32_t acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int k0 = 0; k0 < Kp; k0 += KC1) {
        const int nk = min(KC1, Kp - k0);          // 64, or 32 at the end
        __syncthreads();
        for (int e = tid; e < nk / 4 * TP; e += NT) {
            const int q = e / TP, p = e - q * TP;
            const long long pix = p0 + p;
            uint32_t word = 0;
            if (pix < HW) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int c = k0 + 4 * q + k;
                    if (c < Ct)
                        word |= load_sec<IN>(x0, x1, x2, C0, C1, C2, b, c, HW, pix,
                                             inv_s_in) << (8 * k);
                }
            }
            s_x[q * PLANE1 + p] = word;
        }
        for (int e = tid; e < BM * (nk / 16); e += NT) {
            const int o = e / (nk / 16), j = e - o * (nk / 16);
            reinterpret_cast<uint4*>(s_wt + o * WROW1)[j] =
                reinterpret_cast<const uint4*>(
                    w + (long long)(ob * BM + o) * Kp + k0)[j];
        }
        __syncthreads();
        for (int kk = 0; kk < nk; kk += KQ) {
            uint32_t a[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t* r0 = s_wt + (i * 16 + g) * WROW1 + kk / 4 + t;
                const uint32_t* r8 = r0 + 8 * WROW1;
                a[i][0] = r0[0];
                a[i][1] = r8[0];
                a[i][2] = r0[4];
                a[i][3] = r8[4];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint32_t* sp = s_x + (kk / 4 + t) * PLANE1 + warp * 32 + j * 8 + g;
                const uint32_t bf[2] = {sp[0], sp[4 * PLANE1]};
                mma_s8(acc[0][j], a[0], bf);
                mma_s8(acc[1][j], a[1], bf);
            }
        }
    }

    const bool pair = (HW & 1) == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const long long pix = p0 + warp * 32 + j * 8 + t * 2;
            if (pix >= HW) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = ob * BM + i * 16 + g + h * 8;
                if (o >= O) continue;
                store2(y, ((long long)b * O + o) * HW + pix, pix + 1 < HW, pair,
                       acc[i][j][2 * h], acc[i][j][2 * h + 1], s_w[o], s_in,
                       bias[o], act, inv_out, out_mode);
            }
        }
}

}  // namespace

// K13. x (B, C, H, W) int8 (in_type 0), float32 (1) or bfloat16 (2); w packed
// (Opad, ceil(C / 32), 9, 32) int8; s_w, bias (O,) float32; y (B, O, H, W)
// int8 at 1 / inv_out (out_mode 0) or bfloat16 (2); act 0 none, 1 SiLU,
// 2 ReLU. Returns a cudaError_t.
extern "C" int conv3x3_cmajor_q8(const void* x, const void* w, const float* s_w,
                                 const float* bias, void* y, int B, int C, int H,
                                 int W, int O, int in_type, int out_mode,
                                 float s_in, float inv_s_in, float inv_out,
                                 int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    if (in_type < 0 || in_type > 2 || (out_mode != OUT_I8 && out_mode != OUT_BF16))
        return (int)cudaErrorInvalidValue;
    const int tiles_x = (W + TW - 1) / TW;
    const int nchunks = (C + KQ - 1) / KQ;
    dim3 grid(tiles_x * ((H + TH - 1) / TH), (O + BM - 1) / BM, B);
#define K3(IN) conv3x3_q8_cm_kernel<IN><<<grid, NT, 0, stream>>>( \
        x, (const uint32_t*)w, s_w, bias, y, C, H, W, O, nchunks, tiles_x, s_in, \
        inv_s_in, inv_out, act, out_mode)
    if (in_type == IN_I8) K3(IN_I8);
    else if (in_type == IN_F32) K3(IN_F32);
    else K3(IN_BF16);
#undef K3
    return (int)cudaGetLastError();
}

// K14. Sections x0..x2 (B, C_s, H, W) (C_s = 0 for an absent one), all of one
// in_type; w packed (Opad, Kp) int8, Kp = C0 + C1 + C2 rounded up to 32; y
// (B, O, H, W) as for K13. Returns a cudaError_t.
extern "C" int conv1x1_cmajor_q8(const void* x0, const void* x1, const void* x2,
                                 int C0, int C1, int C2, const void* w,
                                 const float* s_w, const float* bias, void* y,
                                 int B, long long HW, int O, int in_type,
                                 int out_mode, float s_in, float inv_s_in,
                                 float inv_out, int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int Ct = C0 + C1 + C2;
    if (B <= 0 || Ct <= 0 || HW <= 0 || O <= 0) return 0;
    if (in_type < 0 || in_type > 2 || (out_mode != OUT_I8 && out_mode != OUT_BF16))
        return (int)cudaErrorInvalidValue;
    const int Kp = (Ct + KQ - 1) / KQ * KQ;
    dim3 grid((unsigned)((HW + TP - 1) / TP), (O + BM - 1) / BM, B);
#define K1(IN) conv1x1_q8_cm_kernel<IN><<<grid, NT, 0, stream>>>( \
        x0, x1, x2, C0, C1, C2, (const int8_t*)w, s_w, bias, y, HW, O, Kp, s_in, \
        inv_s_in, inv_out, act, out_mode)
    if (in_type == IN_I8) K1(IN_I8);
    else if (in_type == IN_F32) K1(IN_F32);
    else K1(IN_BF16);
#undef K1
    return (int)cudaGetLastError();
}
