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
// weights are int8 per output channel (ops/quant.quantize_weights).
//
// What bounds them on this card: 2 * MACs int8 operations over 1,979 TOP/s
// against the bytes of the input (1, 2 or 4 a value), the weights and the
// output over 3.35 TB/s; at kernel_bench's shapes (C, O = 24-1024 at 20-320
// px) most calls are bound by their bytes, so what counts is how often and
// how wide the input is read.
//
// K13 runs on K4's int8 wgmma core (conv_wgmma.cuh, conv_q8_wgmma_kernel
// with CM = the input type): pixels on M, output channels on N, the nine
// taps as descriptor offsets into a halo'd tile staged once per chunk of 32
// input channels for a block of BN = 24-128 output channels (the tile from
// ops/kernels/conv_kernel.py:k13_route), so at 512 -> 1024 the input is read
// 8 times, not 32. Only its staging and its store depend on the layout:
// - staging: a thread loads 16-byte vectors (16 int8, 8 bfloat16 or 4
//   float32 pixels of a plane row; 8 / 4 / 2 / 1-byte loads where a row is
//   not 16-byte aligned) of 4 channel planes, quantizes them in registers
//   and turns each 4 channels x 4 pixels into the K-major operand's
//   (pixel, 4 channels) words by __byte_perm (transpose4, shared with K14);
//   the next chunk is staged while this one's wgmma group runs;
// - epilogue: the sums of the kept positions transposed into a [channel]
//   [pixel] tile in shared memory, then 4 consecutive pixels of one output
//   channel a thread: one 8-byte (bfloat16) or 4-byte (int8) store.
// The weights are QConv.packed_wgmma3 ([chunk][tap][O/8][2][8][16], zeros
// in every pad), the operand of K4's stride-1 route. Where a plane row or
// the tile width is not a multiple of 4 pixels the stores go a value at a
// time.
//
// K14 (8 warps, 128 consecutive pixels of H*W x an M tile of 64 output
// channels where O <= 64, else 128, each warp 32 channels x 32 or 64
// pixels; int8 mma.sync.aligned.m16n8k32, weights CMQConv.packed_cm, the
// output channels padded to 32 and the input channels to 32):
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
// Rows of the packing past O are zero-filled in the kernel. The s32 sums do
// not depend on their order, so both are exact against their plain versions
// whatever the tile order. The TPU kernels' KP = round_up(9C, 32), 128-lane
// row pitch and row tiles were Mosaic's constraints and have no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_wgmma.cuh"
#include "q8_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TP = 128;               // K14: pixels per block
constexpr int KQ = 32;                // K14: input channels per k-step
constexpr int KC1 = 64;               // K14: input channels per stage
constexpr int PLANE1 = TP + 8;        // 136 words, 8 mod 32
constexpr int WROW1 = KC1 / 4 + 4;    // 20 words

__device__ __forceinline__ void mma_s8(int32_t* d, const uint32_t* a,
                                       const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}


// ---------------------------------------------------------------------------
// K14: 1x1 over 1-3 sections
// ---------------------------------------------------------------------------

constexpr int NT1 = 256;              // K14 threads: 8 warps
constexpr int RAWP = TP / 4 + 4;      // 36 words: one int8 channel row of
                                      // 128 pixels as cp.async lands it
constexpr int EPW = (TP + 8) / 2;     // 68 words: a bf16 row of the epilogue
                                      // tile (an int8 row takes 36)

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
            cp_async_zfill<16>(dst + r * WROW1 + 4 * j,
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
            cp_async_zfill<16>(dst + cl * RAWP + 4 * j, ok ? src + pix : (const char*)w,
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

// K13's tiles: BN = 24, 48, 64 or 128 output channels, 256 positions.
template <int IN>
cudaError_t launch_cm_tile(int bn, int mi, const void* x, const void* w,
                           const float* s_w, const float* bias, void* y,
                           int B, int H, int W, int C, int O, int tw,
                           float s_in, float inv_s_in, float inv_out, int act,
                           int out_mode, int gin, cudaStream_t stream) {
#define LC(BN, MI) launch_wgmma<BN, MI, 16, 1, 3, IN>(                        \
        x, w, s_w, bias, y, B, H, W, C, O, tw, s_in, inv_s_in, inv_out, act, \
        out_mode, gin, stream)
    if (bn == 24 && mi == 2) return LC(24, 2);
    if (bn == 48 && mi == 2) return LC(48, 2);
    if (bn == 64 && mi == 2) return LC(64, 2);
    if (bn == 128 && mi == 2) return LC(128, 2);
#undef LC
    return cudaErrorInvalidValue;
}

}  // namespace

// K13. x (B, C, H, W) int8 (in_type 0), float32 (1) or bfloat16 (2); w
// QConv.packed_wgmma3 ([ceil(C / 32)][9][ceil(O / 8)][2][8][16] int8); s_w,
// bias (O,) float32; y (B, O, H, W) int8 at 1 / inv_out (out_mode 0) or
// bfloat16 (2); (bn, mi) the tile (24, 2), (48, 2), (64, 2) or (128, 2), tw
// its row width (at least two rows of tw + 2 positions in 128 mi); act 0
// none, 1 SiLU, 2 ReLU. A staging load is 16 bytes, or the largest of 8, 4,
// 2, 1 that divides W * size and x's address. Returns a cudaError_t.
extern "C" int conv3x3_cmajor_q8(const void* x, const void* w, const float* s_w,
                                 const float* bias, void* y, int B, int C, int H,
                                 int W, int O, int in_type, int out_mode, int bn,
                                 int mi, int tw, float s_in, float inv_s_in,
                                 float inv_out, int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    if (in_type < 0 || in_type > 2 || (out_mode != OUT_I8 && out_mode != OUT_BF16))
        return (int)cudaErrorInvalidValue;
    const int es = in_type == IN_F32 ? 4 : in_type == IN_BF16 ? 2 : 1;
    int gin = 16;
    while (gin > es && (((long long)W * es) % gin || (uintptr_t)x % gin))
        gin /= 2;
    if ((uintptr_t)x % es) return (int)cudaErrorInvalidValue;
#define LT(IN) launch_cm_tile<IN>(bn, mi, x, w, s_w, bias, y, B, H, W, C, O, tw, \
                                  s_in, inv_s_in, inv_out, act, out_mode, gin,  \
                                  stream)
    if (in_type == IN_I8) return (int)LT(IN_I8);
    if (in_type == IN_F32) return (int)LT(IN_F32);
    return (int)LT(IN_BF16);
#undef LT
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
