// Kernels of the int8 neck region, for Hopper.
//
// K7 dwconv5x5_q8 replaces rep_yolo_tpu/ops/pallas/conv_flat.py:conv5x5_flat_q8
// where the neck calls it: GSConv's 5x5 depthwise conv, which the TPU ran as a
// block-diagonal dense 5x5 on its matrix unit (neck_flat.py:flat_conv with
// DW5_DENSE). The arithmetic is that dense kernel's: the folded weights are
// quantized per output channel (zeros off the diagonal change no maximum and
// add nothing to a sum), the int8 products sum exactly in s32, and the
// epilogue is K4's (q8_common.cuh). Only the diagonal is computed here.
// Bound: bytes (25 int8 multiply-adds per output byte). The block and thread
// shapes are K12's (below): 32 channels a block, one a lane, five output
// columns a thread walking the staged rows, the tile staged by 16-byte loads.
// A depthwise conv sums over taps, not channels, so a thread packs the four
// int8 inputs of taps 0-3 of a kernel row into one word in registers (a byte
// permute, then one funnel shift a column) and takes that row's sum as one
// __dp4a with its packed weights plus one multiply-add for tap 4.
//
// K8 spp_pools_q8 replaces rep_yolo_tpu/ops/pallas/neck_flat.py:spp_pools_flat:
// SPPCSPC's stride-1 max pyramid, emitting the concat [x, mp5, mp9, mp13]
// (pads are -inf). A k x k max with -inf pads is the horizontal k-window max
// of the vertical k-window max, each window clipped to the map, and the
// windows nest (9 = 5 and rows +-3..4, 13 = 9 and rows +-5..6); so this
// equals the chained 5 o 5 and 5 o 5 o 5 of the TPU kernel bit for bit, as
// max is exact, and the scale is unchanged. -128, the least int8, stands
// for the -inf pad: it moves no max. A block takes th output rows by tw
// output columns by cw 4-channel words of one image in two passes and one
// barrier: a column pass, a thread a column of the tile and its 6-column
// halo and a word, reads the band's th + 12 rows straight from the map and
// writes the vertical maxima v5, v9, v13 of its th rows to shared memory
// (and the x section); a row pass, a thread 5 output columns of a row and
// a word, takes their horizontal windows and writes mp5, mp9, mp13. Each
// word is widened to two words of sign-extended 16-bit pairs, on which a
// three-way max is one instruction (__vimax3_s16x2; a bytewise __vmaxs4 is
// six). Lanes run across the words, so a warp reads and writes runs of a
// pixel's channels. One tile, picked in spp_dims: 4 rows by 8 words (4
// where the map has fewer than 8), as wide as the map or, where that tile
// would take over half an SM's shared memory, column tiles: 320 blocks, two
// an SM, at the served (4, 20, 20, 512). (5 x 8 was faster there in an A/B
// but gives 256 blocks.) -DSPP_TH and -DSPP_LGW set another tile for
// pool_ab.py's A/B only. Bound: bytes (the map read once, four times its
// size written); the halo rows are read again, from L2.
//
// K12 dwconv5x5_f32w_q8 replaces rep_yolo_tpu/ops/pallas/neck_flat.py:
// dwconv5x5_flat_q8 (kernel _dw5_kernel), the exact-weight depthwise 5x5 that
// the neck runs when its block-diagonal dense route is off (set_dw5_dense
// (False) there, Q8Region(dw5_dense=False) here). The weights stay float32,
// with the input's per-channel scale folded in, and the sum runs in float32
// on the raw int8 values, in _dw5_kernel's order: for each kernel row u the
// five taps left to right, then that row added to the accumulator; then the
// bias and the activation, float32 out or an int8 requant. Every product and
// sum is an explicitly rounded operation (and the file is compiled with
// --fmad=false), so the outputs equal the plain version's bit for bit but for
// SiLU's expf. Bound: bytes (int8 in, int8 or f32 out, the weights); the
// float32 products and sums (50 a value) come next. A block of 4 warps
// stages a (ty + 4) x 24 pixel tile of 32 channels by 16-byte loads (16
// channels of a pixel a load, all of a thread's loads before its stores;
// byte loads where C is not a multiple of 16); a thread owns one channel of
// 5 adjacent output columns, its 25 weights in registers, and walks down the
// tile's input rows: each input row is read once (9 bytes, each turned into
// float32 once) and feeds the five output rows it belongs to, whose sums stay
// in registers until their fifth row arrives. The tile height (16, 8, 4, 2
// or 1 rows, chosen by the wrapper: ops/kernels/neck_flat.dw5_tile) is the
// tallest that still gives four blocks an SM, so the small maps spread over
// the card.
//
// Layout: channels-last int8 (B, H, W, C); C a multiple of 4 for K8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K7 and K12: depthwise 5x5, stride 1, pad 2, on one staging and walk
// ---------------------------------------------------------------------------

constexpr int FW_NX = 5;                  // output columns a thread
constexpr int FW_SX = 4;                  // column strips (warps) a block
constexpr int FW_TX = FW_NX * FW_SX;      // output columns a block
constexpr int FW_C = 32;                  // channels a block, one a lane
constexpr int FW_THREADS = 32 * FW_SX;
constexpr int FW_RX = FW_TX + 4;          // staged columns
constexpr int FW_TY = 16;                 // output rows a block, at most
constexpr int FW_ITEMS = (FW_TY + 4) * FW_RX * 2;   // 16-byte loads, at most
constexpr int FW_IPT = (FW_ITEMS + FW_THREADS - 1) / FW_THREADS;

// Stages the (ty + 4) x FW_RX pixel tile at (ty0 - 2, tx0 - 2) of x (B, H,
// W, C) int8, channels c0..c0 + FW_C - 1, into s_x (FW_C bytes a pixel),
// zeros outside the map and past C. VEC: C % 16 == 0 and x 16-byte aligned,
// so a pixel's 32 channels are two 16-byte loads, every load of the thread
// issued before its first store; else byte loads.
template <bool VEC>
__device__ __forceinline__ void dw5_stage(uint8_t* s_x, const int8_t* __restrict__ x,
                                          int b, int H, int W, int C, int ty0,
                                          int tx0, int c0, int nr) {
    const int tid = threadIdx.x;
    if (VEC) {
        const int items = nr * FW_RX * 2;
        uint4 v[FW_IPT];
#pragma unroll
        for (int it = 0; it < FW_IPT; ++it) {
            const int e = tid + it * FW_THREADS;
            const int p = e >> 1, cc = c0 + 16 * (e & 1);
            const int iy = ty0 - 2 + p / FW_RX, ix = tx0 - 2 + p % FW_RX;
            v[it] = make_uint4(0, 0, 0, 0);
            if (e < items && cc < C && iy >= 0 && iy < H && ix >= 0 && ix < W)
                v[it] = *reinterpret_cast<const uint4*>(
                    x + (((long long)b * H + iy) * W + ix) * C + cc);
        }
#pragma unroll
        for (int it = 0; it < FW_IPT; ++it) {
            const int e = tid + it * FW_THREADS;
            if (e < items) reinterpret_cast<uint4*>(s_x)[e] = v[it];
        }
    } else {
        for (int i = tid; i < nr * FW_RX * FW_C; i += FW_THREADS) {
            const int c = i % FW_C, p = i / FW_C;
            const int iy = ty0 - 2 + p / FW_RX, ix = tx0 - 2 + p % FW_RX;
            int8_t v = 0;
            if (c0 + c < C && iy >= 0 && iy < H && ix >= 0 && ix < W)
                v = x[(((long long)b * H + iy) * W + ix) * C + c0 + c];
            s_x[i] = (uint8_t)v;
        }
    }
}

// K7. x (B, H, W, C) int8; w (25, C) int8, tap u * 5 + v, per-channel
// scales s_w; bias (C,); y (B, H, W, C) f32 (F32_OUT) or int8 at
// 1 / inv_out. A block: ty <= FW_TY output rows x FW_TX columns x FW_C
// channels; a thread: one channel, FW_NX adjacent columns, walking the
// ty + 4 staged input rows. Input row r adds its kernel-row-u sum to output
// row r - u, so five rows of s32 sums are in flight (slot = row % 5). A
// row sum is one __dp4a (taps 0-3: the four input bytes packed by a byte
// permute and funnel shifts) and one multiply-add (tap 4), exact in s32.
template <bool F32_OUT, bool VEC>
__global__ void __launch_bounds__(FW_THREADS)
dwconv5x5_q8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ s_w, const float* __restrict__ bias,
                    void* __restrict__ y, int H, int W, int C, int ty, int tiles_x,
                    float s_in, float inv_out, int act) {
    __shared__ __align__(16) uint8_t s_x[(FW_TY + 4) * FW_RX * FW_C];
    const int ty0 = (blockIdx.x / tiles_x) * ty;
    const int tx0 = (blockIdx.x % tiles_x) * FW_TX;
    const int c0 = blockIdx.y * FW_C, b = blockIdx.z;
    const int tid = threadIdx.x, nr = ty + 4;
    dw5_stage<VEC>(s_x, x, b, H, W, C, ty0, tx0, c0, nr);
    __syncthreads();

    const int lane = tid & 31, lx0 = (tid >> 5) * FW_NX;
    const int c = c0 + lane, cl = min(c, C - 1);
    int32_t w4[5], w1[5];                  // a kernel row: taps 0-3 packed, tap 4
#pragma unroll
    for (int u = 0; u < 5; ++u) {
        uint32_t pk = 0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
            pk |= (uint32_t)(uint8_t)w[(long long)(u * 5 + v) * C + cl] << (8 * v);
        w4[u] = (int32_t)pk;
        w1[u] = w[(long long)(u * 5 + 4) * C + cl];
    }
    const float sws = __fmul_rn(s_w[cl], s_in), bc = bias[cl];
    int32_t acc[5][FW_NX];
    for (int r5 = 0; r5 < nr; r5 += 5) {
#pragma unroll
        for (int rr = 0; rr < 5; ++rr) {
            const int r = r5 + rr;              // staged input row
            if (r >= nr) break;
            const int8_t* px = reinterpret_cast<const int8_t*>(s_x)
                               + (r * FW_RX + lx0) * FW_C + lane;
            int32_t xv[FW_NX + 4];
#pragma unroll
            for (int q = 0; q < FW_NX + 4; ++q) xv[q] = px[q * FW_C];
            // xp[q]: the bytes of input columns q..q+3
            uint32_t xp[FW_NX];
            xp[0] = __byte_perm(__byte_perm(xv[0], xv[1], 0x0040),
                                __byte_perm(xv[2], xv[3], 0x0040), 0x5410);
#pragma unroll
            for (int q = 1; q < FW_NX; ++q)
                xp[q] = __funnelshift_r(xp[q - 1], (uint32_t)xv[q + 3], 8);
#pragma unroll
            for (int u = 0; u < 5; ++u) {
                const int ly = r - u;           // the output row it feeds
                if (ly < 0 || ly >= ty) continue;
                const int sl = (rr - u + 5) % 5;
#pragma unroll
                for (int xo = 0; xo < FW_NX; ++xo) {
                    const int32_t row = __dp4a((int32_t)xp[xo], w4[u],
                                               w1[u] * xv[xo + 4]);
                    acc[sl][xo] = u == 0 ? row : acc[sl][xo] + row;
                }
            }
            // output row r - 4 has all five row sums
            const int oy = ty0 + r - 4;
            if (r < 4 || r - 4 >= ty || oy >= H || c >= C) continue;
            const long long row_off = ((long long)b * H + oy) * W;
#pragma unroll
            for (int xo = 0; xo < FW_NX; ++xo) {
                const int ox = tx0 + lx0 + xo;
                if (ox >= W) break;
                const float yv = epi_s(acc[(rr + 1) % 5][xo], sws, bc, act);
                const long long o = (row_off + ox) * C + c;
                if (F32_OUT)
                    static_cast<float*>(y)[o] = yv;
                else
                    static_cast<int8_t*>(y)[o] = (int8_t)quant1(yv, inv_out);
            }
        }
    }
}

template <bool F32_OUT, bool VEC>
cudaError_t launch_dw(const int8_t* x, const int8_t* w, const float* s_w,
                      const float* bias, void* y, int B, int H, int W, int C,
                      int ty, float s_in, float inv_out, int act,
                      cudaStream_t stream) {
    const int tiles_x = (W + FW_TX - 1) / FW_TX;
    dim3 grid(tiles_x * ((H + ty - 1) / ty), (C + FW_C - 1) / FW_C, B);
    dwconv5x5_q8_kernel<F32_OUT, VEC><<<grid, FW_THREADS, 0, stream>>>(
        x, w, s_w, bias, y, H, W, C, ty, tiles_x, s_in, inv_out, act);
    return cudaGetLastError();
}

// The float32 value of a staged int8 byte b: 2^23 + (b ^ 0x80) is
// 2^23 + 128 + x exactly, so one logic op and one exact add.
__device__ __forceinline__ float byte_to_float(uint32_t b) {
    return __fadd_rn(__int_as_float(0x4B000000u | (b ^ 0x80u)), -8388736.0f);
}

// K12. x (B, H, W, C) int8; w (25, C) f32, tap u * 5 + v; bias (C,); y (B,
// H, W, C) f32 (F32_OUT) or int8 at 1 / inv_out. The block and thread
// shapes and the walk are K7's; the sums are float32, each kernel row's
// five taps left to right, then the row added to the accumulator.
template <bool F32_OUT, bool VEC>
__global__ void __launch_bounds__(FW_THREADS)
dwconv5x5_f32w_kernel(const int8_t* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, void* __restrict__ y,
                      int H, int W, int C, int ty, int tiles_x, float inv_out,
                      int act) {
    __shared__ __align__(16) uint8_t s_x[(FW_TY + 4) * FW_RX * FW_C];
    const int ty0 = (blockIdx.x / tiles_x) * ty;
    const int tx0 = (blockIdx.x % tiles_x) * FW_TX;
    const int c0 = blockIdx.y * FW_C, b = blockIdx.z;
    const int tid = threadIdx.x, nr = ty + 4;
    dw5_stage<VEC>(s_x, x, b, H, W, C, ty0, tx0, c0, nr);
    __syncthreads();

    const int lane = tid & 31, lx0 = (tid >> 5) * FW_NX;
    const int c = c0 + lane, cl = min(c, C - 1);
    float wr[25];
#pragma unroll
    for (int t = 0; t < 25; ++t) wr[t] = w[(long long)t * C + cl];
    const float bc = bias[cl];
    float acc[5][FW_NX];
    for (int r5 = 0; r5 < nr; r5 += 5) {
#pragma unroll
        for (int rr = 0; rr < 5; ++rr) {
            const int r = r5 + rr;              // staged input row
            if (r >= nr) break;
            const uint8_t* px = s_x + (r * FW_RX + lx0) * FW_C + lane;
            float xv[FW_NX + 4];
#pragma unroll
            for (int q = 0; q < FW_NX + 4; ++q) xv[q] = byte_to_float(px[q * FW_C]);
#pragma unroll
            for (int u = 0; u < 5; ++u) {
                const int ly = r - u;           // the output row it feeds
                if (ly < 0 || ly >= ty) continue;
                const int sl = (rr - u + 5) % 5;
#pragma unroll
                for (int xo = 0; xo < FW_NX; ++xo) {
                    float row = __fmul_rn(wr[u * 5], xv[xo]);
#pragma unroll
                    for (int v = 1; v < 5; ++v)
                        row = __fadd_rn(row, __fmul_rn(wr[u * 5 + v], xv[xo + v]));
                    acc[sl][xo] = u == 0 ? row : __fadd_rn(acc[sl][xo], row);
                }
            }
            // output row r - 4 has all five row sums
            const int oy = ty0 + r - 4;
            if (r < 4 || r - 4 >= ty || oy >= H || c >= C) continue;
            const long long row_off = ((long long)b * H + oy) * W;
#pragma unroll
            for (int xo = 0; xo < FW_NX; ++xo) {
                const int ox = tx0 + lx0 + xo;
                if (ox >= W) break;
                float yv = __fadd_rn(acc[(rr + 1) % 5][xo], bc);
                if (act) {
                    const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-yv)));
                    yv = __fmul_rn(yv, sig);
                }
                const long long o = (row_off + ox) * C + c;
                if (F32_OUT)
                    static_cast<float*>(y)[o] = yv;
                else
                    static_cast<int8_t*>(y)[o] = (int8_t)quant1(yv, inv_out);
            }
        }
    }
}

template <bool F32_OUT, bool VEC>
cudaError_t launch_dw_f32w(const int8_t* x, const float* w, const float* bias,
                           void* y, int B, int H, int W, int C, int ty,
                           float inv_out, int act, cudaStream_t stream) {
    const int tiles_x = (W + FW_TX - 1) / FW_TX;
    dim3 grid(tiles_x * ((H + ty - 1) / ty), (C + FW_C - 1) / FW_C, B);
    dwconv5x5_f32w_kernel<F32_OUT, VEC><<<grid, FW_THREADS, 0, stream>>>(
        x, w, bias, y, H, W, C, ty, tiles_x, inv_out, act);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8: the SPP max pyramid [x, mp5, mp9, mp13]
// ---------------------------------------------------------------------------

constexpr int SPP_R = 6;                  // the 13-window's reach
constexpr int SPP_QS = 5;                 // output columns a thread, row pass
constexpr int SPP_THREADS = 256;
constexpr size_t SPP_SMEM = 232448 / 2;   // a block's at most: two an SM
#ifndef SPP_TH
#define SPP_TH 4                          // output rows a block
#endif
#ifndef SPP_LGW
#define SPP_LGW 3                         // log2 of its channel words
#endif
constexpr uint32_t SPP_PAD = 0x80808080u; // four int8 -128s: move no max

// Four int8 channels <-> two words of sign-extended 16-bit pairs (channels
// 0, 2 and 1, 3), on which a three-way max is one instruction on this card
// (VIMNMX3.S16x2; __vmaxs4 on the bytes is six).
template <uint32_t S>
__device__ __forceinline__ uint32_t prmt_sext(uint32_t v) {
    uint32_t r;
    asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(v), "n"(S));
    return r;
}

__device__ __forceinline__ uint2 widen(uint32_t v) {
    return make_uint2(prmt_sext<0xA280>(v), prmt_sext<0xB391>(v));
}

__device__ __forceinline__ uint32_t narrow(uint2 v) {
    return __byte_perm(v.x, v.y, 0x6240);
}

__device__ __forceinline__ uint2 max3(uint2 a, uint2 b, uint2 c) {
    return make_uint2(__vimax3_s16x2(a.x, b.x, c.x),
                      __vimax3_s16x2(a.y, b.y, c.y));
}

__device__ __forceinline__ uint2 max5(uint2 a, uint2 b, uint2 c, uint2 d,
                                      uint2 e) {
    return max3(max3(a, b, c), d, e);
}

// x (B, H, W, cw) and y (B, H, W, 4 cw) in 4-byte words. Block (chunk,
// band, b * col_tiles + ct): words chunk * CW .. + CW - 1 of output rows
// band * TH .. + TH - 1 and columns ct * tw .. + tw - 1, clipped to the map.
// Shared memory: the vertical maxima v5, v9, v13 of the tile's TH rows over
// its NU = TW + 12 columns (TW = tw rounded up to SPP_QS), rows VS words of
// uint2 apart (NU rounded up to odd: no bank conflict between rows).
template <int TH, int LGW>
__global__ void __launch_bounds__(SPP_THREADS)
spp_pools_q8_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                    int H, int W, int cw, int tw, int col_tiles) {
    constexpr int CW = 1 << LGW;
    constexpr int NR = TH + 2 * SPP_R;       // rows a column pass reads
    extern __shared__ int4 smem4[];
    const int b = blockIdx.z / col_tiles;
    const int ct = blockIdx.z - b * col_tiles;
    const int c0 = blockIdx.x * CW;
    const int r0 = blockIdx.y * TH, n = min(TH, H - r0);
    const int q0 = ct * tw, m = min(tw, W - q0);
    const int strips = (tw + SPP_QS - 1) / SPP_QS;
    const int NU = strips * SPP_QS + 2 * SPP_R;
    const int VS = (NU | 1) * CW;
    uint2* V5 = (uint2*)smem4;
    uint2* V9 = V5 + TH * VS;
    uint2* V13 = V9 + TH * VS;
    const size_t img = (size_t)b * H * W;
    const uint32_t* xb = x + img * cw + c0;
    uint32_t* yb = y + img * 4 * cw + c0;

    // column pass: a thread a column and word of the tile and its halo,
    // straight from the map (out of it: -128), down the band's NR rows; it
    // writes the x section of the tile's own pixels
    for (int i = threadIdx.x; i < NU * CW; i += SPP_THREADS) {
        const int u = i >> LGW, w = i & (CW - 1);
        const int q = q0 - SPP_R + u;
        const bool live = q >= 0 && q < W && c0 + w < cw;
        const uint32_t* src = xb + (size_t)(live ? q : 0) * cw + w;
        uint32_t raw[NR];
        uint2 v[NR];
#pragma unroll
        for (int k = 0; k < NR; ++k) {
            const int r = r0 - SPP_R + k;
            raw[k] = live && r >= 0 && r < H ? src[(size_t)r * W * cw] : SPP_PAD;
        }
#pragma unroll
        for (int k = 0; k < NR; ++k) v[k] = widen(raw[k]);
#pragma unroll
        for (int k = 0; k < TH; ++k) {      // the windows nest: 5 in 9 in 13
            const uint2 m5 = max5(v[k + 4], v[k + 5], v[k + 6], v[k + 7],
                                  v[k + 8]);
            const uint2 m9 = max5(m5, v[k + 2], v[k + 3], v[k + 9], v[k + 10]);
            const uint2 m13 = max5(m9, v[k], v[k + 1], v[k + 11], v[k + 12]);
            V5[k * VS + i] = m5;
            V9[k * VS + i] = m9;
            V13[k * VS + i] = m13;
        }
        if (live && u >= SPP_R && u < SPP_R + m) {
            uint32_t* dst = yb + ((size_t)r0 * W + q) * 4 * cw + w;
#pragma unroll
            for (int k = 0; k < TH; ++k)
                if (k < n) dst[(size_t)k * W * 4 * cw] = raw[SPP_R + k];
        }
    }
    __syncthreads();

    // row pass: a thread SPP_QS output columns of a row and word
    for (int i = threadIdx.x; i < strips * TH * CW; i += SPP_THREADS) {
        const int w = i & (CW - 1), t = i >> LGW;
        const int k = t % TH, s = t / TH;
        if (k >= n || c0 + w >= cw) continue;
        const int p0 = s * SPP_QS;
        uint2 h5[SPP_QS + 4], h9[SPP_QS + 8], h13[SPP_QS + 12];
#pragma unroll
        for (int j = 0; j < SPP_QS + 12; ++j) {
            const int o = k * VS + (p0 + j) * CW + w;
            if (j >= 4 && j < SPP_QS + 8) h5[j - 4] = V5[o];
            if (j >= 2 && j < SPP_QS + 10) h9[j - 2] = V9[o];
            h13[j] = V13[o];
        }
        uint32_t* dst = yb + ((size_t)(r0 + k) * W + q0 + p0) * 4 * cw + w;
#pragma unroll
        for (int j = 0; j < SPP_QS; ++j) {
            if (p0 + j >= m) break;
            const uint2 o5 = max5(h5[j], h5[j + 1], h5[j + 2], h5[j + 3],
                                  h5[j + 4]);
            const uint2 o9 = max5(max5(h9[j], h9[j + 1], h9[j + 2], h9[j + 3],
                                       h9[j + 4]),
                                  h9[j + 5], h9[j + 6], h9[j + 7], h9[j + 8]);
            const uint2 o13 = max5(
                max5(max5(h13[j], h13[j + 1], h13[j + 2], h13[j + 3],
                          h13[j + 4]),
                     h13[j + 5], h13[j + 6], h13[j + 7], h13[j + 8]),
                h13[j + 9], h13[j + 10], h13[j + 11], h13[j + 12]);
            uint32_t* o = dst + (size_t)j * 4 * cw;
            o[cw] = narrow(o5);
            o[2 * cw] = narrow(o9);
            o[3 * cw] = narrow(o13);
        }
    }
}

// The shared memory of one block in bytes.
inline size_t spp_bytes(int th, int tw, int lgw) {
    const int nu = (tw + SPP_QS - 1) / SPP_QS * SPP_QS + 2 * SPP_R;
    return (size_t)3 * th * ((nu | 1) << lgw) * sizeof(uint2);
}

// K8's launch on a (B, H, W) map of cw words a pixel: SPP_TH rows by tw
// columns by 2^lgw words a block, tw = W halved until the block's shared
// memory is at most SPP_SMEM; false if the grid is too large.
struct SppDims {
    int lgw, tw, col_tiles;
    dim3 grid;
    size_t smem;
};

bool spp_dims(int B, int H, int W, int cw, SppDims* d) {
    d->lgw = cw >= (1 << SPP_LGW) ? SPP_LGW : 2;
    d->tw = W;
    while (d->tw > 1 && spp_bytes(SPP_TH, d->tw, d->lgw) > SPP_SMEM)
        d->tw = (d->tw + 1) / 2;
    d->col_tiles = (W + d->tw - 1) / d->tw;
    d->grid = dim3((cw + (1 << d->lgw) - 1) >> d->lgw, (H + SPP_TH - 1) / SPP_TH,
                   B * d->col_tiles);
    d->smem = spp_bytes(SPP_TH, d->tw, d->lgw);
    return d->grid.y <= 65535 && (long long)B * d->col_tiles <= 65535;
}

template <int LGW>
cudaError_t launch_spp(const uint32_t* x, uint32_t* y, int H, int W, int cw,
                       const SppDims& d, cudaStream_t stream) {
    cudaError_t err = set_smem(spp_pools_q8_kernel<SPP_TH, LGW>, d.smem);
    if (err != cudaSuccess) return err;
    spp_pools_q8_kernel<SPP_TH, LGW><<<d.grid, SPP_THREADS, d.smem, stream>>>(
        x, y, H, W, cw, d.tw, d.col_tiles);
    return cudaGetLastError();
}

}  // namespace

// The depthwise 5x5's launch checks: ty, the output rows a block (16, 8, 4,
// 2 or 1, ops/kernels/neck_flat.dw5_tile), and the grid's limits.
static bool dw5_args_ok(int B, int ty) {
    return ty >= 1 && ty <= FW_TY && (ty & (ty - 1)) == 0 && B <= 65535;
}

// x (B, H, W, C) int8; w (25, C) int8; s_w, bias (C,) f32; y (B, H, W, C)
// f32 (f32_out) or int8 at 1 / inv_out; ty output rows a block. Returns a
// cudaError_t.
extern "C" int dwconv5x5_q8(const int8_t* x, const int8_t* w, const float* s_w,
                            const float* bias, void* y, int B, int H, int W, int C,
                            int ty, int f32_out, float s_in, float inv_out, int act,
                            void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
    if (!dw5_args_ok(B, ty)) return (int)cudaErrorInvalidValue;
    const bool vec = C % 16 == 0 && (uintptr_t)x % 16 == 0;
#define LD(F, V) launch_dw<F, V>(x, w, s_w, bias, y, B, H, W, C, ty, s_in, \
                                 inv_out, act, stream)
    if (f32_out) return (int)(vec ? LD(true, true) : LD(true, false));
    return (int)(vec ? LD(false, true) : LD(false, false));
#undef LD
}

// x (B, H, W, C) int8; w (25, C) f32; bias (C,) f32; y (B, H, W, C) f32
// (f32_out) or int8 at 1 / inv_out; ty as K7's. Returns a cudaError_t.
extern "C" int dwconv5x5_f32w_q8(const int8_t* x, const float* w, const float* bias,
                                 void* y, int B, int H, int W, int C, int ty,
                                 int f32_out, float inv_out, int act,
                                 void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
    if (!dw5_args_ok(B, ty)) return (int)cudaErrorInvalidValue;
    const bool vec = C % 16 == 0 && (uintptr_t)x % 16 == 0;
#define LD(F, V) launch_dw_f32w<F, V>(x, w, bias, y, B, H, W, C, ty, inv_out, \
                                      act, stream)
    if (f32_out) return (int)(vec ? LD(true, true) : LD(true, false));
    return (int)(vec ? LD(false, true) : LD(false, false));
#undef LD
}

// x (B, H, W, 4*cw) int8 as words, 4-byte aligned; y (B, H, W, 16*cw).
// Returns a cudaError_t.
extern "C" int spp_pools_q8(const void* x, void* y, int B, int H, int W, int cw,
                            void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || cw <= 0) return 0;
    SppDims d;
    if (!spp_dims(B, H, W, cw, &d) || ((uintptr_t)x | (uintptr_t)y) % 4 != 0)
        return (int)cudaErrorInvalidValue;
    const uint32_t* xw = (const uint32_t*)x;
    uint32_t* yw = (uint32_t*)y;
    if (d.lgw == SPP_LGW)
        return (int)launch_spp<SPP_LGW>(xw, yw, H, W, cw, d, stream);
    return (int)launch_spp<2>(xw, yw, H, W, cw, d, stream);
}

// The launch spp_pools_q8 makes on such a map: dims = grid x, y, z, block
// x, y, z, dynamic shared memory. Returns a cudaError_t.
extern "C" int spp_pools_q8_dims(int B, int H, int W, int cw, int* dims) {
    SppDims d;
    if (B <= 0 || H <= 0 || W <= 0 || cw <= 0 || !spp_dims(B, H, W, cw, &d))
        return (int)cudaErrorInvalidValue;
    const int out[7] = {(int)d.grid.x, (int)d.grid.y, (int)d.grid.z,
                        SPP_THREADS, 1, 1, (int)d.smem};
    for (int i = 0; i < 7; ++i) dims[i] = out[i];
    return 0;
}
