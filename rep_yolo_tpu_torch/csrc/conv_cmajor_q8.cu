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
// once by the wrapper (ops/kernels/conv_kernel.py CMQConv.packed_cm) with the
// output channels padded to a multiple of 32 and the input channels to a
// multiple of 32, all with zeros (exact).
//
// Both are implicit GEMMs on the int8 tensor cores, as K10 is on the bf16
// ones: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, M = output
// channels, N = output pixels, K = taps x input channels. The B fragment's
// register is a 32-bit word of four channels of one pixel, so the staged
// input is a plane of such words per channel quad, and the plane and
// weight-row pitches make the fragment loads free of bank conflicts. s32
// sums do not depend on their order, so both are exact against their plain
// versions whatever the tile order.
//
// What bounds them on this card: 2 * MACs int8 operations over 1,979 TOP/s
// against the bytes of the input (1, 2 or 4 a value), the weights and the
// output over 3.35 TB/s; at kernel_bench's shapes (C, O = 24-1024 at 20-320
// px) most calls are bound by their bytes, so what counts is how often and
// how wide the input is read.
//
// K13 (4 warps, 32 output channels x an 8 x 16 tile of the map, each warp
// 32 x 32) stages its halo'd tile a value at a time from four channel
// planes, with no double buffering, for every 32 output channels; it pads C
// to 32 per tap. That is the staging K14 had before this design.
//
// K14 (8 warps, 128 consecutive pixels of H*W x an M tile of 64 output
// channels where O <= 64, else 128, each warp 32 channels x 32 or 64
// pixels):
// - the input is staged once per M tile, so once for O <= 128 and four
//   times at O = 512 (32-channel tiles staged it 16 times at 768 -> 512);
// - it comes in as 16-byte loads along a plane (16 int8, 8 bf16 or 4 f32
//   pixels), is quantized in registers and turned from 4 channels x 4
//   pixels into the fragment's (pixel, 4-channel) words by __byte_perm; a
//   plane whose start or length is not 16-byte aligned (H*W*size % 16 != 0)
//   takes scalar loads in the kernel;
// - double buffering: int8 input on aligned planes lands by cp.async in a
//   second pair of stages and is transposed from there; float input (or a
//   misaligned plane) holds the next chunk's loads in registers across the
//   current chunk's products; the weights of a 64-channel chunk arrive for
//   the whole M tile by cp.async, two stages;
// - the epilogue (q8_common.cuh) goes through a (BM, 128) tile in shared
//   memory, so each store is 16 bytes of consecutive pixels of one output
//   channel.
// Rows of the packing past O are zero-filled in the kernel, so K14 reads
// K13's packing as it is. wgmma with TMA-staged tiles is later work. The TPU
// kernels' KP = round_up(9C, 32), 128-lane row pitch and row tiles were
// Mosaic's constraints and have no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_common.cuh"

namespace {

constexpr int NT = 128;               // K13 threads per block: 4 warps
constexpr int BM = 32;                // K13 output channels per block
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

constexpr int NT1 = 256;              // K14 threads: 8 warps
constexpr int RAWP = TP / 4 + 4;      // 36 words: one int8 channel row of
                                      // 128 pixels as cp.async lands it
constexpr int EPW = (TP + 8) / 2;     // 68 words: a bf16 row of the epilogue
                                      // tile (an int8 row takes 36)

// The 4 x 4 byte transpose: w[c] holds pixels 0..3 of channel c (byte j =
// pixel j); p[j] gets channels 0..3 of pixel j (byte c = channel c), the B
// fragment's word.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* p) {
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);   // a0 b0 a1 b1
    const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);   // a2 b2 a3 b3
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
    p[0] = __byte_perm(t0, t2, 0x5410);                    // a0 b0 c0 d0
    p[1] = __byte_perm(t0, t2, 0x7632);
    p[2] = __byte_perm(t1, t3, 0x5410);
    p[3] = __byte_perm(t1, t3, 0x7632);
}

// The plane of channel c (of the concat) of image b, or nullptr past Ct.
template <int ES>
__device__ __forceinline__ const char* plane(const void* x0, const void* x1,
                                             const void* x2, int C0, int C1,
                                             int C2, int b, int c,
                                             long long HW) {
    if (c < C0) return (const char*)x0 + ((long long)b * C0 + c) * HW * ES;
    c -= C0;
    if (c < C1) return (const char*)x1 + ((long long)b * C1 + c) * HW * ES;
    c -= C1;
    if (c < C2) return (const char*)x2 + ((long long)b * C2 + c) * HW * ES;
    return nullptr;
}

// 16 bytes of one plane from pixel pix on, a value at a time: the path of a
// plane whose start or length is not 16-byte aligned, and of the map's end.
template <int IN, int ES>
__device__ __forceinline__ uint4 load16_scalar(const char* src, long long pix,
                                               long long HW) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16 / ES; ++e) {
        if (pix + e < HW) {
            uint32_t bits;
            if (IN == IN_F32) bits = ((const uint32_t*)src)[pix + e];
            else if (IN == IN_BF16) bits = ((const uint16_t*)src)[pix + e];
            else bits = ((const uint8_t*)src)[pix + e];
            w[(e * ES) / 4] |= bits << (8 * ((e * ES) % 4));
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes of one channel's consecutive pixels as words of four int8 pixels
// (byte j = pixel j), quantized at 1 / inv_s unless already int8.
template <int IN>
__device__ __forceinline__ void qwords(const uint4 r, float inv_s,
                                       uint32_t* out) {
    if (IN == IN_I8) {
        out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
    } else if (IN == IN_F32) {
        out[0] = (uint32_t)(quant1(__uint_as_float(r.x), inv_s) & 0xff) |
                 (uint32_t)(quant1(__uint_as_float(r.y), inv_s) & 0xff) << 8 |
                 (uint32_t)(quant1(__uint_as_float(r.z), inv_s) & 0xff) << 16 |
                 (uint32_t)(quant1(__uint_as_float(r.w), inv_s) & 0xff) << 24;
    } else {
        const uint32_t v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t a = v[2 * h], b = v[2 * h + 1];
            out[h] = (uint32_t)(quant1(__uint_as_float(a << 16), inv_s) & 0xff) |
                     (uint32_t)(quant1(__uint_as_float(a & 0xffff0000u), inv_s)
                                & 0xff) << 8 |
                     (uint32_t)(quant1(__uint_as_float(b << 16), inv_s) & 0xff)
                         << 16 |
                     (uint32_t)(quant1(__uint_as_float(b & 0xffff0000u), inv_s)
                                & 0xff) << 24;
        }
    }
}

// Sections x0..x2 (B, C_s, H, W); w (Opad, Kp) int8, Kp = C0 + C1 + C2
// rounded up to 32 (rows from O on are not read); grid (ceil(HW / 128),
// ceil(O / BM), B). vec: every plane starts and ends 16-byte aligned; ASYNC
// (int8 input, vec) stages the input with cp.async, else through registers.
// With BM = 64 three blocks share an SM (at most 85 registers a thread),
// which hides more of the thin maps' load latency; BM = 128 would spill.
template <int IN, int BM, bool ASYNC>
__global__ void __launch_bounds__(NT1, BM == 64 ? 3 : 1)
conv1x1_q8_cm_kernel(const void* __restrict__ x0, const void* __restrict__ x1,
                     const void* __restrict__ x2, int C0, int C1, int C2,
                     const int8_t* __restrict__ w, const float* __restrict__ s_w,
                     const float* __restrict__ bias, void* __restrict__ y,
                     long long HW, int O, int Kp, float s_in, float inv_s_in,
                     float inv_out, int act, int out_mode, int vec) {
    constexpr int ES = IN == IN_F32 ? 4 : IN == IN_BF16 ? 2 : 1;
    constexpr int VP = 16 / ES;                // pixels of one 16-byte load
    constexpr int GPR = TP / VP;               // such loads along a plane row
    constexpr int ITEMS = KC1 / 4 * GPR;       // 4 channels x VP pixels each
    constexpr int IPT = ASYNC ? 1 : (ITEMS + NT1 - 1) / NT1;
    constexpr int WM = BM / 32;                // warps along O
    constexpr int WN = TP / (8 / WM);          // pixels of a warp: 32 or 64
    constexpr int NF = WN / 8;
    constexpr int SW_WORDS = BM * WROW1;       // one stage of weights
    constexpr int SX_OFF = 2 * SW_WORDS;
    constexpr int RAW_OFF = SX_OFF + KC1 / 4 * PLANE1;
    constexpr int STAGE_WORDS = RAW_OFF + (ASYNC ? 2 * KC1 * RAWP : 0);
    constexpr int EPI_WORDS = BM * EPW;
    __shared__ __align__(16) uint32_t sm[STAGE_WORDS > EPI_WORDS ? STAGE_WORDS
                                                                 : EPI_WORDS];
    uint32_t* s_x = sm + SX_OFF;

    const int b = blockIdx.z, o0 = blockIdx.y * BM;
    const long long p0 = (long long)blockIdx.x * TP;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp % WM) * 32, wn = (warp / WM) * WN;
    const int nchunks = (Kp + KC1 - 1) / KC1;

    // weights of chunk ch for the whole M tile: rows of nk bytes, 16 a copy
    auto stage_w = [&](int ch) {
        const int k0 = ch * KC1, per = min(KC1, Kp - k0) / 16;
        uint32_t* dst = sm + (ch & 1) * SW_WORDS;
        for (int e = tid; e < BM * per; e += NT1) {
            const int r = e / per, j = e - r * per, o = o0 + r;
            cp_async16(dst + r * WROW1 + 4 * j,
                       w + (long long)(o < O ? o : 0) * Kp + k0 + 16 * j, o < O);
        }
    };
    // int8 input of chunk ch as it lies: 64 channel rows of 128 pixels
    auto stage_raw = [&](int ch) {
        uint32_t* dst = sm + RAW_OFF + (ch & 1) * KC1 * RAWP;
        for (int e = tid; e < KC1 * (TP / 16); e += NT1) {
            const int cl = e / (TP / 16), j = e - cl * (TP / 16);
            const long long pix = p0 + 16 * j;
            const char* src = plane<ES>(x0, x1, x2, C0, C1, C2, b,
                                        ch * KC1 + cl, HW);
            const bool ok = src != nullptr && pix < HW;
            cp_async16(dst + cl * RAWP + 4 * j, ok ? src + pix : (const char*)w,
                       ok);
        }
    };
    // the register path: 16-byte loads of four planes, held across the
    // current chunk's products
    uint4 raw[IPT][4];
    auto load_regs = [&](int ch) {
#pragma unroll
        for (int it = 0; it < IPT; ++it) {
            const int e = tid + it * NT1;
            if (e >= ITEMS) continue;
            const int q = e / GPR;
            const long long pix = p0 + (e - q * GPR) * VP;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const char* src = plane<ES>(x0, x1, x2, C0, C1, C2, b,
                                            ch * KC1 + 4 * q + cc, HW);
                uint4 r = make_uint4(0u, 0u, 0u, 0u);
                if (src != nullptr) {
                    if (vec) {
                        if (pix < HW)
                            r = __ldg(reinterpret_cast<const uint4*>(src + pix * ES));
                    } else {
                        r = load16_scalar<IN, ES>(src, pix, HW);
                    }
                }
                raw[it][cc] = r;
            }
        }
    };
    // quantize, transpose to (pixel, 4 channels) words, store to s_x
    auto store_regs = [&]() {
#pragma unroll
        for (int it = 0; it < IPT; ++it) {
            const int e = tid + it * NT1;
            if (e >= ITEMS) continue;
            const int q = e / GPR;
            uint32_t cw[4][4];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) qwords<IN>(raw[it][cc], inv_s_in, cw[cc]);
            uint32_t* dst = s_x + q * PLANE1 + (e - q * GPR) * VP;
#pragma unroll
            for (int wi = 0; wi < VP / 4; ++wi) {
                const uint32_t in4[4] = {cw[0][wi], cw[1][wi], cw[2][wi], cw[3][wi]};
                uint32_t p[4];
                transpose4(in4, p);
                *reinterpret_cast<uint4*>(dst + 4 * wi) = make_uint4(p[0], p[1], p[2], p[3]);
            }
        }
    };
    // the cp.async path: landed rows -> (pixel, 4 channels) words
    auto transpose_raw = [&](int ch) {
        const uint32_t* src_s = sm + RAW_OFF + (ch & 1) * KC1 * RAWP;
        const int q = tid >> 4, hg = tid & 15;        // 16 quads x 16 x 8 px
        uint2 v[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
            v[cc] = *reinterpret_cast<const uint2*>(src_s + (4 * q + cc) * RAWP + 2 * hg);
        const uint32_t lo[4] = {v[0].x, v[1].x, v[2].x, v[3].x};
        const uint32_t hi[4] = {v[0].y, v[1].y, v[2].y, v[3].y};
        uint32_t p[8];
        transpose4(lo, p);
        transpose4(hi, p + 4);
        uint4* dst = reinterpret_cast<uint4*>(s_x + q * PLANE1 + 8 * hg);
        dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
        dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
    };

    int32_t acc[2][NF][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    stage_w(0);
    if (ASYNC) stage_raw(0);
    cp_async_commit();
    if (nchunks > 1) {
        stage_w(1);
        if (ASYNC) stage_raw(1);
    }
    cp_async_commit();
    if (!ASYNC) load_regs(0);
    for (int ch = 0; ch < nchunks; ++ch) {
        if (!ASYNC) {
            store_regs();
            if (ch + 1 < nchunks) load_regs(ch + 1);   // in flight meanwhile
        }
        cp_async_wait<1>();                            // chunk ch has landed
        __syncthreads();
        if (ASYNC) {
            transpose_raw(ch);
            __syncthreads();
        }
        const uint32_t* s_wt = sm + (ch & 1) * SW_WORDS;
        const int nk = min(KC1, Kp - ch * KC1);        // 64, or 32 at the end
        for (int kk = 0; kk < nk; kk += KQ) {
            uint32_t a[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t* r0 = s_wt + (wm + i * 16 + g) * WROW1 + kk / 4 + t;
                const uint32_t* r8 = r0 + 8 * WROW1;
                a[i][0] = r0[0];
                a[i][1] = r8[0];
                a[i][2] = r0[4];
                a[i][3] = r8[4];
            }
#pragma unroll
            for (int j = 0; j < NF; ++j) {
                const uint32_t* sp = s_x + (kk / 4 + t) * PLANE1 + wn + j * 8 + g;
                const uint32_t bf[2] = {sp[0], sp[4 * PLANE1]};
                mma_s8(acc[0][j], a[0], bf);
                mma_s8(acc[1][j], a[1], bf);
            }
        }
        __syncthreads();                 // every warp is done with the stage
        if (ch + 2 < nchunks) {
            stage_w(ch + 2);
            if (ASYNC) stage_raw(ch + 2);
        }
        cp_async_commit();
    }
    cp_async_wait<0>();

    // epilogue into a (BM, 128) tile in shared memory, then 16-byte stores of
    // consecutive pixels of one output channel
    const bool bf16_out = out_mode == OUT_BF16;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int ol = wm + i * 16 + g + 8 * h, o = o0 + ol;
            if (o >= O) continue;
            const float sw = s_w[o], bo = bias[o];
#pragma unroll
            for (int j = 0; j < NF; ++j) {
                const int pl = wn + j * 8 + 2 * t;
                const float v0 = epi(acc[i][j][2 * h], sw, s_in, bo, act);
                const float v1 = epi(acc[i][j][2 * h + 1], sw, s_in, bo, act);
                if (bf16_out) {
                    reinterpret_cast<__nv_bfloat162*>(sm + ol * EPW)[pl / 2] =
                        __floats2bfloat162_rn(v0, v1);
                } else {
                    const uint32_t q0 = (uint32_t)(quant1(v0, inv_out) & 0xff);
                    const uint32_t q1 = (uint32_t)(quant1(v1, inv_out) & 0xff);
                    reinterpret_cast<uint16_t*>(sm + ol * (EPW / 2 + 2))[pl / 2] =
                        (uint16_t)(q0 | (q1 << 8));
                }
            }
        }
    __syncthreads();
    const int vp_out = bf16_out ? 8 : 16;                 // pixels a store
    const int row_words = bf16_out ? EPW : EPW / 2 + 2;   // 68 or 36
    const int es_out = bf16_out ? 2 : 1;
    const bool vec_out = HW % vp_out == 0;
    for (int e = tid; e < BM * (TP / vp_out); e += NT1) {
        const int ol = e / (TP / vp_out), j = e - ol * (TP / vp_out);
        const int o = o0 + ol;
        const long long pix = p0 + (long long)j * vp_out;
        if (o >= O || pix >= HW) continue;
        const uint32_t* src = sm + ol * row_words + 4 * j;
        char* dst = (char*)y + (((long long)b * O + o) * HW + pix) * es_out;
        if (vec_out) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
            const char* sb = (const char*)src;
            const int n = (int)min((long long)vp_out, HW - pix) * es_out;
            for (int k = 0; k < n; ++k) dst[k] = sb[k];
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
    const int es = in_type == IN_F32 ? 4 : in_type == IN_BF16 ? 2 : 1;
    int vec = (HW * es) % 16 == 0;
    const void* xs[3] = {x0, x1, x2};
    const int cs[3] = {C0, C1, C2};
    for (int s = 0; s < 3; ++s)
        if (cs[s] > 0 && (uintptr_t)xs[s] % 16 != 0) vec = 0;
    const int bm = O <= 64 ? 64 : 128;
    dim3 grid((unsigned)((HW + TP - 1) / TP), (O + bm - 1) / bm, B);
#define K1(IN, BMV, AS) conv1x1_q8_cm_kernel<IN, BMV, AS><<<grid, NT1, 0, stream>>>( \
        x0, x1, x2, C0, C1, C2, (const int8_t*)w, s_w, bias, y, HW, O, Kp, s_in, \
        inv_s_in, inv_out, act, out_mode, vec)
#define K1M(IN, AS) do { if (bm == 64) K1(IN, 64, AS); else K1(IN, 128, AS); } while (0)
    if (in_type == IN_I8 && vec) K1M(IN_I8, true);
    else if (in_type == IN_I8) K1M(IN_I8, false);
    else if (in_type == IN_F32) K1M(IN_F32, false);
    else K1M(IN_BF16, false);
#undef K1M
#undef K1
    return (int)cudaGetLastError();
}
