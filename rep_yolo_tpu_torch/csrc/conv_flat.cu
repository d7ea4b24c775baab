// Int8 convolutions of the int8 backbone region, for Hopper (sm_90a).
//
// K4 conv3x3_q8 replaces rep_yolo_tpu/ops/pallas/conv_flat.py:conv3x3_flat_q8
// (kernels _conv3_flat_q8_kernel / _pipe / _whole) and the stem's s2d form
// (nn/blocks.py:_stem_fast_q8): a 3x3 conv, stride 1 or 2, zero pad 1.
// K5 conv1x1_q8 replaces conv_flat.py:conv1x1_flat_q8 (_conv1_flat_q8_kernel,
// _conv1_pool_flat_q8_kernel): a 1x1 conv over 1-3 input sections (a concat
// that is never materialised), optionally followed by a 2x2/s2 max pool.
// K4's stride-1 wgmma core with 5x5 taps (KS = 5, halo 2) replaces the dense
// case of conv_flat.py:conv5x5_flat_q8 (_conv5_flat_q8_kernel / _whole), the
// route ops/kernels/conv_flat.py:dense5_route picks ("wgmma" on int8 input,
// "wgmma_f32" on float32 input as K4's); float32 maps of C % 4 or off 16
// bytes take the dp4a kernel, templated on its tap count.
// K4 and K5 also carry the pixel-major contract of conv_pm.py:conv3x3_pm_q8
// and conv1x1_pm_q8 (ops/kernels/conv_pm.py): pixel-major (B, H*W, C) is
// this NHWC layout, so those rows need only ReLU (q8_common.cuh), a bfloat16
// store beside the float32 and int8 ones, and float input for K4 and K5.
//
// Layout: channels-last int8 (B, H, W, C), C a multiple of 4. K4 also takes
// float32 input (any C) and quantizes it while staging it, padding the
// channels to a multiple of 4 with zeros (exact: the weights there are 0);
// K5 takes float32 sections whose channels are multiples of 4.
//
// Epilogue (q8_common.cuh), in the JAX package's operation order and
// rounding: y = acc * (s_w * s_in) + bias, SiLU or ReLU, then int8 at
// clip(rint(y * (1/out_scale))), float32, or bfloat16 rounded once from the
// float32 value (the JAX y.astype(bf16)). With the pool, the max of the
// window's four f32 values is requantized: requant is monotone, so this equals
// conv, requant, then pool. The s32 sums are exact in any order, and the
// float32 input is quantized by the same quant1, so every K4 route gives the
// same values bit for bit.
//
// Bound on this card: at the served shapes the int8 work is 2 * MACs ops over
// the 1,979 TOP/s of the int8 tensor cores, and the bytes are the int8
// activations; bytes bound every K5 call and most K4 calls.
//
// K4 has two designs and four routes; the wrapper
// (ops/kernels/conv_flat.py:k4_route) picks one by shapes, dtype and address
// alone, and a failed launch raises (nothing retries on another route):
// - "wgmma" (conv_q8_wgmma_kernel, S = 1, VEC 16 / 8 / 4): a stride-1 3x3
//   on int8 input, on the int8 tensor cores: the DER blocks' st1-st6, the
//   neck's stride-1 3x3s, the xla_q8 blocks' int8 3x3s;
// - "wgmma_s2" (S = 2): a stride-2 3x3 on int8 input, the PAN's two GSConv
//   downsamples;
// - "wgmma_f32" (S = 1, VEC 0): a stride-1 3x3 on float32 input with C a
//   multiple of 4 at a 16-byte-aligned address, quantized while staging:
//   the xla_q8 blocks' four st1s;
// - "dp4a" (conv3x3_q8_kernel): everything else, the float32 stem (C = 3,
//   stride 2) and float32 maps of C % 4 or off 16 bytes.
//
// K4 (dp4a): the weights arrive packed by the wrapper, per block of TO = 32
// output channels and chunk of KC input channels, as [tap][KC/4][TO] words,
// so a block stages them with one contiguous copy. A block of 4 warps
// computes 128 output pixels x 32 output channels; a thread holds 4 pixels x
// 8 channels of s32 sums. Per chunk of KC input channels the block stages the
// halo'd input tile and the weights in shared memory; each step of the inner
// loop is 4 input words (one per pixel, consecutive lanes on consecutive
// words) and 8 weight words (two broadcast 16-byte loads) for 32 dp4a. The
// input tile is stored pixel-major with an odd word pitch, so both the
// staging writes and the lane reads are free of bank conflicts. The dp4a
// pipe runs at about 1/16 of the int8 tensor cores.
//
// K4 at stride 2 also runs on int8 input: the PAN downsamples of the neck
// (neck_flat.py:conv3x3s2_flat_q8, which the TPU reached by space-to-depth
// and a stride-1 kernel on a {-1, 0} tap lattice). Output pixel (i, j) reads
// input rows 2i-1..2i+1 and columns 2j-1..2j+1: pad 1 on top and left, which
// for even H, W is the lattice's SAME conv; Ho = (H - 1) / 2 + 1 as
// F.conv2d(stride=2, padding=1).
//
// K4 (int8 tensor cores, the three wgmma routes) and the dense 5x5 run
// conv_wgmma.cuh's conv_q8_wgmma_kernel, which describes the design: the
// taps as descriptor offsets into input staged once per 32 input channels
// (stride 2: four row / column parity planes), weights
// QConv.packed_wgmma3 / packed_wgmma5. Here: the tiles. BN = 24, 48, 64 or
// 128 output channels a block, the smallest that holds O (128 above it: four
// stages of 256 channels' nine taps would not fit; stride 2 stops at 64, its
// four planes making a stage about 57 KB; the 5x5 at 64, 25 taps of
// weights a stage), narrower down to 64 where that grid is under two blocks
// an SM (the 5x5: 24 where it fills under half the SMs). MI = 2 (256
// positions a block) at every BN: with one 64-row tile a warpgroup (K5's
// MI = 1 at BN 64 / 128), ptxas serialized the nine taps' wgmmas (C7515).
//
// K5 (int8 tensor cores): an implicit GEMM on wgmma.mma_async
// m64nNk32.s32.s8.s8 (wgmma.cuh), pixels on M and output channels on N, both
// operands K-major in shared memory without swizzle.
// - An NHWC pixel's channels are contiguous and so are the rows of
//   QConv.w_q, so neither operand needs a transpose: 16 channels of a pixel
//   are one 16-byte core-matrix row, copied as they are by cp.async (16, 8
//   or 4 bytes a copy, the largest that divides every section's channels
//   and address). Float32 sections go through registers instead: four
//   16-byte loads, quantized at s_in, one 16-byte store.
// - K is each section's channels padded to a multiple of 16 (a group), the
//   groups of the sections in order, padded to an even count (a k32 step is
//   two groups). The packed weights (QConv.packed_wgmma, [step][O/8][2][8]
//   [16]) are zero in every pad, so whatever the staged bytes there hold
//   adds nothing.
// - A block holds BN = 24, 48, 64, 128 or 256 output channels, the smallest
//   that holds O (256 above it), so the input is staged once for O <= 256
//   and twice at O = 512 (the dp4a design restaged it for every 32); where
//   that grid would be under two blocks an SM (the 20 / 40-pixel maps),
//   narrower tiles down to 64. Two warpgroups of MI x 64 rows: MB = 128 MI
//   = 256 rows for BN <= 48, else 128 (s32 accumulators: BN / 2 registers
//   a 64-row tile; at 256 rows the epilogue's tile held the 64 / 128-channel
//   tiles to one block an SM, and they ran slower).
// - A ring of four stages of KS k32 steps (2 for BN <= 48, else 4): a
//   chunk's input and weights are copied two chunks ahead, while the current
//   chunk's wgmma group runs; cp.async.wait_group 1, wgmma.wait_group 1 and
//   one barrier a chunk. A block takes min(4, chunks) stages of shared
//   memory, so the thin 1x1s fit several blocks an SM.
// - With the pool, the rows of a block are pooled pixels' 2x2 windows (row
//   4 q + j is position j of pooled pixel q), so a window is four adjacent
//   rows of the block's sums.
// - Epilogue: the s32 sums to shared memory (the only unrolled part), then
//   the float epilogue (and the pool's max) a value a thread, consecutive
//   threads on consecutive channels, into a tile in the output type, then
//   16-byte stores (a block that holds all O writes one contiguous range of
//   y). Bound at the thin maps: the epilogue's expf and reciprocal, a value
//   each, on the special-function units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "conv_wgmma.cuh"
#include "q8_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TO = 32;         // output channels per block
constexpr int OPT = 8;         // output channels per thread (one warp's share)
constexpr int PPT = 4;         // pixels per thread
constexpr int NTHREADS = 128;  // 4 warps
constexpr int TILE_H = 8;      // K4 output tile: 8 rows x 16 columns
constexpr int TILE_W = 16;

__device__ __forceinline__ int odd_pitch(int kp) { return kp | 1; }

// Writes the thread's 8 channels of one output pixel.
__device__ __forceinline__ void store8(void* y, long long pix, int O, int og0,
                                       const float* v, float inv_out, int out_mode) {
    if (out_mode == OUT_BF16) {
        __nv_bfloat16* dst = (__nv_bfloat16*)y + pix * O + og0;
        if (og0 + OPT <= O && (O % 8) == 0) {
            *(uint4*)dst = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                      pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
        } else {
            for (int o = 0; o < OPT; ++o)
                if (og0 + o < O) dst[o] = __float2bfloat16_rn(v[o]);
        }
    } else if (out_mode == OUT_F32) {
        float* dst = (float*)y + pix * O + og0;
        if (og0 + OPT <= O && (O % 4) == 0) {
            ((float4*)dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
            ((float4*)dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
            for (int o = 0; o < OPT; ++o)
                if (og0 + o < O) dst[o] = v[o];
        }
    } else {
        int8_t* dst = (int8_t*)y + pix * O + og0;
        if (og0 + OPT <= O && (O % 8) == 0) {
            uint32_t lo = 0, hi = 0;
            for (int o = 0; o < 4; ++o)
                lo |= ((uint32_t)(quant1(v[o], inv_out) & 0xff)) << (8 * o);
            for (int o = 0; o < 4; ++o)
                hi |= ((uint32_t)(quant1(v[4 + o], inv_out) & 0xff)) << (8 * o);
            *(uint2*)dst = make_uint2(lo, hi);
        } else {
            for (int o = 0; o < OPT; ++o)
                if (og0 + o < O) dst[o] = (int8_t)quant1(v[o], inv_out);
        }
    }
}

// ---------------------------------------------------------------------------
// K4: KS x KS conv (KS = 3 or 5), stride S, pad KS / 2
// ---------------------------------------------------------------------------

template <int KS, int S>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_q8_kernel(const void* __restrict__ x, const int32_t* __restrict__ wpk,
                  const float* __restrict__ s_w, const float* __restrict__ bias,
                  void* __restrict__ y, int H, int W, int C, int C4, int KC,
                  int Ho, int Wo, int O, int tiles_x, float s_in, float inv_s_in,
                  float inv_out, int act, int f32_in, int out_mode) {
    constexpr int NTAP = KS * KS;
    constexpr int RH = (TILE_H - 1) * S + KS;
    constexpr int RW = (TILE_W - 1) * S + KS;
    constexpr int RA = RH * RW;
    extern __shared__ int4 smem4[];
    int32_t* smem = (int32_t*)smem4;
    const int kp = KC / 4;
    const int pitch = odd_pitch(kp);
    int32_t* s_x = smem;                                   // [RA][pitch]
    int32_t* s_wt = smem + ((RA * pitch + 3) & ~3);        // [NTAP][kp][TO]

    const int tile = blockIdx.x, ob = blockIdx.y, b = blockIdx.z;
    const int ty0 = (tile / tiles_x) * TILE_H, tx0 = (tile % tiles_x) * TILE_W;
    const int iy0 = ty0 * S - KS / 2, ix0 = tx0 * S - KS / 2;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 4, c = lane & 15;      // pixel j: row r + 2j, col c
    const int nchunks = C4 / KC;

    int32_t acc[PPT][OPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
        for (int o = 0; o < OPT; ++o) acc[j][o] = 0;

    for (int ch = 0; ch < nchunks; ++ch) {
        __syncthreads();
        for (int idx = threadIdx.x; idx < RA * kp; idx += NTHREADS) {
            const int pix = idx / kp, p = idx - pix * kp;
            const int ry = pix / RW, rx = pix - ry * RW;
            const int iy = iy0 + ry, ix = ix0 + rx;
            int32_t v = 0;
            if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
                const long long base = ((long long)b * H + iy) * W + ix;
                if (f32_in) {
                    const float* xf = (const float*)x + base * C;
                    const int c0 = ch * KC + 4 * p;
                    uint32_t pack = 0;
                    for (int q = 0; q < 4; ++q)
                        if (c0 + q < C)
                            pack |= ((uint32_t)(quant1(xf[c0 + q], inv_s_in) & 0xff))
                                    << (8 * q);
                    v = (int32_t)pack;
                } else {
                    v = ((const int32_t*)x)[base * (C4 / 4) + ch * kp + p];
                }
            }
            s_x[pix * pitch + p] = v;
        }
        const int nw = NTAP * kp * TO / 4;
        const int4* src = (const int4*)(wpk + (long long)(ob * nchunks + ch) * NTAP * kp * TO);
        for (int i = threadIdx.x; i < nw; i += NTHREADS) ((int4*)s_wt)[i] = src[i];
        __syncthreads();

#pragma unroll 1
        for (int tap = 0; tap < NTAP; ++tap) {
            const int ky = tap / KS, kx = tap - KS * ky;
            const int32_t* xa = s_x + ((r * S + ky) * RW + c * S + kx) * pitch;
            const int32_t* wa = s_wt + tap * kp * TO + warp * OPT;
            for (int p = 0; p < kp; ++p) {
                int32_t a[PPT];
#pragma unroll
                for (int j = 0; j < PPT; ++j) a[j] = xa[(2 * j * S * RW) * pitch + p];
                const int4 w0 = ((const int4*)(wa + p * TO))[0];
                const int4 w1 = ((const int4*)(wa + p * TO))[1];
                const int32_t wr[OPT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                for (int j = 0; j < PPT; ++j)
#pragma unroll
                    for (int o = 0; o < OPT; ++o) acc[j][o] = __dp4a(a[j], wr[o], acc[j][o]);
            }
        }
    }

    const int og0 = ob * TO + warp * OPT;
    if (og0 >= O) return;
    float sw[OPT], bb[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
        sw[o] = og0 + o < O ? s_w[og0 + o] : 0.0f;
        bb[o] = og0 + o < O ? bias[og0 + o] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        const int oy = ty0 + r + 2 * j, ox = tx0 + c;
        if (oy >= Ho || ox >= Wo) continue;
        float v[OPT];
#pragma unroll
        for (int o = 0; o < OPT; ++o) v[o] = epi(acc[j][o], sw[o], s_in, bb[o], act);
        store8(y, ((long long)b * Ho + oy) * Wo + ox, O, og0, v, inv_out, out_mode);
    }
}

// ---------------------------------------------------------------------------
// K5: 1x1 conv over up to 3 sections, optional 2x2/s2 max pool, on wgmma
// ---------------------------------------------------------------------------

struct Sections {
    const void* x[3];      // (B, H, W, C_s) int8 or float32
    int c[3];              // channels of each section
    int g[4];              // first 16-channel group of each section; g[3]: all
};

// One block: MB = 128 MI rows (pixels; with the pool, pooled pixel q's 2x2
// window as rows 4 q .. 4 q + 3) x BN output channels from n0 = BN
// blockIdx.y. A stage holds NG = 2 KS groups of 16 channels, each a plane
// of MB 16-byte rows (pitch PL = MB + 1 rows: conflict-free staging
// stores), then the weights of its KS k32 steps, BN x 32 bytes each. VEC:
// 16, 8 or 4 (int8, bytes a cp.async) or 0 (float32 through registers).
template <int BN, int MI, int KS, int VEC>
__global__ void __launch_bounds__(WG_NT, (BN * MI <= 128) ? 2 : 1)
conv1x1_q8_wgmma_kernel(Sections secs, const uint8_t* __restrict__ w,
                        const float* __restrict__ s_w,
                        const float* __restrict__ bias, void* __restrict__ y,
                        long long rows, int H, int W, int O, int og,
                        int nsteps, int pool, float s_in, float inv_s_in,
                        float inv_out, int act, int out_mode) {
    constexpr int MB = 128 * MI, NG = 2 * KS, PL = MB + 1;
    constexpr int ABYTES = NG * PL * 16;
    constexpr int STAGE = ABYTES + KS * BN * 32;
    constexpr int IPT = MB * NG / WG_NT;          // staging rows a thread
    extern __shared__ __align__(128) uint8_t smem[];
    float* s_sw = reinterpret_cast<float*>(smem);
    float* s_b = s_sw + BN;
    uint8_t* ring = smem + epi_bytes(BN);
    const int tid = threadIdx.x, wg = tid >> 7;
    const long long r0 = (long long)blockIdx.x * MB;
    const int j0 = blockIdx.y * (BN / 8), n0 = 8 * j0;
    const int nchunks = (nsteps + KS - 1) / KS;

    for (int i = tid; i < BN; i += WG_NT) {      // s_w * s_in, the bias
        s_sw[i] = n0 + i < O ? __fmul_rn(s_w[n0 + i], s_in) : 0.0f;
        s_b[i] = n0 + i < O ? bias[n0 + i] : 0.0f;
    }
    // this thread stages group gi of every chunk for rows tid / NG + it
    // WG_NT / NG (consecutive lanes: consecutive 16 bytes of a pixel)
    const int gi = tid % NG;
    int pix[IPT];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
        const long long r = r0 + tid / NG + it * (WG_NT / NG);
        if (r >= rows) {
            pix[it] = -1;
        } else if (pool) {
            const int H2 = H / 2, W2 = W / 2;
            const long long q = r >> 2;
            const int j = (int)(r & 3);
            const long long qb = q / ((long long)H2 * W2);
            const int rem = (int)(q - qb * H2 * W2);
            const int qy = rem / W2, qx = rem - qy * W2;
            pix[it] = (int)((qb * H + 2 * qy + (j >> 1)) * W + 2 * qx + (j & 1));
        } else {
            pix[it] = (int)r;
        }
    }

    auto stage_in = [&](int ch, int st) {
        const int gg = ch * NG + gi;
        if (gg >= secs.g[3]) return;
        const int s = (gg >= secs.g[1]) + (gg >= secs.g[2]);
        const int cs = secs.c[s], c0 = (gg - secs.g[s]) * 16;
        uint8_t* dst = ring + st * STAGE + gi * PL * 16;
#pragma unroll
        for (int it = 0; it < IPT; ++it) {
            if (pix[it] < 0) continue;
            uint8_t* d = dst + (tid / NG + it * (WG_NT / NG)) * 16;
            if constexpr (VEC == 0) {
                const float* src = static_cast<const float*>(secs.x[s])
                                   + (long long)pix[it] * cs + c0;
                uint32_t q[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    q[k] = 0;
                    if (c0 + 4 * k < cs) {
                        const float4 f = reinterpret_cast<const float4*>(src)[k];
                        q[k] = (quant1(f.x, inv_s_in) & 0xff)
                               | (quant1(f.y, inv_s_in) & 0xff) << 8
                               | (quant1(f.z, inv_s_in) & 0xff) << 16
                               | (uint32_t)(quant1(f.w, inv_s_in) & 0xff) << 24;
                    }
                }
                *reinterpret_cast<uint4*>(d) = make_uint4(q[0], q[1], q[2], q[3]);
            } else {
                const uint8_t* src = static_cast<const uint8_t*>(secs.x[s])
                                     + (long long)pix[it] * cs + c0;
                if constexpr (VEC == 16) {
                    cp_async16(d, src);
                } else {
#pragma unroll
                    for (int k = 0; k < 16 / VEC; ++k) {
                        if (c0 + k * VEC >= cs) break;
                        if constexpr (VEC == 8)
                            cp_async8(d + 8 * k, src + 8 * k);
                        else
                            cp_async4(d + 4 * k, src + 4 * k);
                    }
                }
            }
        }
    };
    auto weights = [&](int ch, int st) {
        uint8_t* d = ring + st * STAGE + ABYTES;
        for (int e = tid; e < KS * BN * 2; e += WG_NT) {
            const int q = e & 15, jj = (e >> 4) % (BN / 8);
            const int ks = (e >> 4) / (BN / 8);
            if (j0 + jj < og)
                cp_async16(d + (ks * (BN / 8) + jj) * 256 + q * 16,
                           w + ((long long)(ch * KS + ks) * og + j0 + jj) * 256
                               + q * 16);
        }
    };

    int32_t acc[MI][BN / 2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0;

    // chunk 0 staged, chunk 1's copies in flight
    stage_in(0, 0);
    weights(0, 0);
    cp_async_commit();
    if (nchunks > 1) {
        stage_in(1, 1);
        weights(1, 1);
        cp_async_commit();
        cp_async_wait<1>();
    } else {
        cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    for (int ch = 0; ch < nchunks; ++ch) {
        const int st = ch % NS;
        const uint32_t a0 = smem_addr(ring + st * STAGE), b0 = a0 + ABYTES;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        wgmma_fence();
        // every chunk runs KS steps: the packed weights are zero past K
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            const uint64_t db = gmma_desc(b0 + ks * BN * 32, 128, 256);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                const int m = 2 * ks * PL + (wg * MI + i) * 64;
                wgmma_s8<BN>(acc[i], gmma_desc(a0 + m * 16, PL * 16, 128), db);
            }
        }
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        // while they run: chunk ch + 2 into the stage chunk ch - 2 used
        // (its products were waited for, and the block passed a barrier
        // since)
        // (ptxas 12.9 segfaults on an unconditional cp.async.wait_group 1
        // followed by the proxy fence and wgmma.wait_group here)
        if (ch + 2 < nchunks) {
            stage_in(ch + 2, (ch + 2) % NS);
            weights(ch + 2, (ch + 2) % NS);
            cp_async_commit();
            cp_async_wait<1>();      // chunk ch + 1 has landed
        } else {
            cp_async_wait<0>();
        }
        fence_proxy_async();
        wgmma_wait<1>();             // chunk ch - 1's products are done
        __syncthreads();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
    __syncthreads();

    // epilogue, three passes over shared memory: the s32 sums into a tile
    // [MB][PW]; the float epilogue (pooled: with the max of rows 4 q ..
    // 4 q + 3) into the out tile; one run of rows to y
    constexpr int PW = sums_pitch(BN);
    int32_t* sums = reinterpret_cast<int32_t*>(ring);
    wg_sums<BN, MI>(acc, sums, PW, tid);
    __syncthreads();
    const int nc = min(BN, O - n0);
    const int es = out_bytes(out_mode);
    const long long o0 = pool ? r0 / 4 : r0;
    const int nrow = (int)min((long long)(pool ? MB / 4 : MB),
                              (pool ? rows / 4 : rows) - o0);
    // float32 without the pool: in place (each value over its own sum);
    // else a contiguous [nrow][nc] tile after the sums
    const bool in_place = es == 4 && !pool;
    uint8_t* out = in_place ? ring : ring + MB * PW * 4;
    const int opitch = in_place ? PW * 4 : nc * es;       // bytes a row
    wg_epilogue(sums, PW, pool, s_sw, s_b, out, opitch, nrow, nc, act,
                inv_out, out_mode, tid);
    __syncthreads();
    // y's rows from o0 on (16-byte aligned: o0 is a multiple of 32)
    uint8_t* yb = static_cast<uint8_t*>(y) + (o0 * O + n0) * es;
    wg_store(out, opitch, nc * es, O * es, 1, nrow, (n0 * es) % 16 == 0,
             [](int) { return 0; }, [&](int) { return yb; }, tid);
}

template <int KS, int S>
cudaError_t launch3(const void* x, const int32_t* wpk, const float* s_w,
                    const float* bias, void* y, int B, int H, int W, int C, int C4,
                    int KC, int Ho, int Wo, int O, float s_in, float inv_s_in,
                    float inv_out, int act, int f32_in, int out_mode,
                    cudaStream_t stream) {
    constexpr int RA = ((TILE_H - 1) * S + KS) * ((TILE_W - 1) * S + KS);
    const int kp = KC / 4;
    const size_t bytes = (size_t)(((RA * (kp | 1) + 3) & ~3) + KS * KS * kp * TO) * 4;
    cudaError_t err = set_smem(conv3x3_q8_kernel<KS, S>, bytes);
    if (err != cudaSuccess) return err;
    const int tiles_x = (Wo + TILE_W - 1) / TILE_W;
    const int tiles = tiles_x * ((Ho + TILE_H - 1) / TILE_H);
    dim3 grid(tiles, (O + TO - 1) / TO, B);
    conv3x3_q8_kernel<KS, S><<<grid, NTHREADS, bytes, stream>>>(
        x, wpk, s_w, bias, y, H, W, C, C4, KC, Ho, Wo, O, tiles_x, s_in, inv_s_in,
        inv_out, act, f32_in, out_mode);
    return cudaGetLastError();
}

template <int BN, int MI, int KS, int VEC>
cudaError_t launch1(const Sections& secs, const void* w, const float* s_w,
                    const float* bias, void* y, long long rows, int H, int W,
                    int O, int pool, float s_in, float inv_s_in, float inv_out,
                    int act, int out_mode, cudaStream_t stream) {
    constexpr int MB = 128 * MI;
    constexpr int STAGE = 2 * KS * (MB + 1) * 16 + KS * BN * 32;
    const int nsteps = (secs.g[3] + 1) / 2;
    const int nchunks = (nsteps + KS - 1) / KS;
    const int es = out_bytes(out_mode);
    const int tile = MB * sums_pitch(BN) * 4
                     + (es == 4 && !pool ? 0 : (pool ? MB / 4 : MB) * BN * es);
    const int smem = epi_bytes(BN) + std::max(std::min(NS, nchunks) * STAGE,
                                              tile);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    auto kernel = conv1x1_q8_wgmma_kernel<BN, MI, KS, VEC>;
    static bool allowed = false;      // the attribute once, at its maximum
    if (!allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return err;
        allowed = true;
    }
    dim3 grid((unsigned)((rows + MB - 1) / MB), (O + BN - 1) / BN);
    kernel<<<grid, WG_NT, smem, stream>>>(
        secs, (const uint8_t*)w, s_w, bias, y, rows, H, W, O, (O + 7) / 8,
        nsteps, pool, s_in, inv_s_in, inv_out, act, out_mode);
    return cudaGetLastError();
}

template <int VEC>
cudaError_t launch1_tile(int bn, int mi, const Sections& secs, const void* w,
                         const float* s_w, const float* bias, void* y,
                         long long rows, int H, int W, int O, int pool,
                         float s_in, float inv_s_in, float inv_out, int act,
                         int out_mode, cudaStream_t stream) {
#define L1(BN, MI, KS) launch1<BN, MI, KS, VEC>(secs, w, s_w, bias, y, rows, H, \
                                               W, O, pool, s_in, inv_s_in,    \
                                               inv_out, act, out_mode, stream)
    if (bn == 24 && mi == 2) return L1(24, 2, 2);
    if (bn == 48 && mi == 2) return L1(48, 2, 2);
    if (bn == 64 && mi == 1) return L1(64, 1, 4);
    if (bn == 128 && mi == 1) return L1(128, 1, 4);
    if (bn == 256 && mi == 1) return L1(256, 1, 4);
#undef L1
    return cudaErrorInvalidValue;
}

// K4's and the dense 5x5's wgmma tiles: 3x3 at stride 1 up to BN 128,
// stride 2 up to 64 (four stages of four planes and 128 channels' nine taps
// would not fit), 5x5 up to 64 (a stage holds 25 taps of weights).
template <int VEC, int S, int KS>
cudaError_t launch_tile(int bn, int mi, const void* x, const void* w,
                        const float* s_w, const float* bias, void* y, int B,
                        int H, int W, int C, int O, int tw, float s_in,
                        float inv_s_in, float inv_out, int act, int out_mode,
                        cudaStream_t stream) {
#define LW(BN, MI) launch_wgmma<BN, MI, VEC, S, KS, NHWC>(                   \
        x, w, s_w, bias, y, B, H, W, C, O, tw, s_in, inv_s_in, inv_out, act, \
        out_mode, 0, stream)
    if (bn == 24 && mi == 2) return LW(24, 2);
    if (bn == 48 && mi == 2) return LW(48, 2);
    if (bn == 64 && mi == 2) return LW(64, 2);
    if constexpr (S == 1 && KS == 3)
        if (bn == 128 && mi == 2) return LW(128, 2);
#undef LW
    return cudaErrorInvalidValue;
}
}  // namespace

// x (B, H, W, C) f32 (f32_in) or (B, H, W, C4) int8; wpk packed words; y
// (B, Ho, Wo, O) int8 (out_mode 0), f32 (1) or bf16 (2); ks 3 (stride 1 or
// 2) or 5 (stride 1); act 0 none, 1 SiLU, 2 ReLU. Returns a cudaError_t.
extern "C" int conv3x3_q8(const void* x, const int32_t* wpk, const float* s_w,
                          const float* bias, void* y, int B, int H, int W, int C,
                          int C4, int KC, int ks, int stride, int O, int f32_in,
                          int out_mode, float s_in, float inv_s_in, float inv_out,
                          int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    if (KC <= 0 || KC % 4 || KC > 64 || C4 % KC ||
        (out_mode != OUT_I8 && out_mode != OUT_F32 && out_mode != OUT_BF16) ||
        !((ks == 3 && (stride == 1 || stride == 2)) || (ks == 5 && stride == 1)))
        return (int)cudaErrorInvalidValue;
    const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
#define L3(KS, S) launch3<KS, S>(x, wpk, s_w, bias, y, B, H, W, C, C4, KC, Ho, Wo, \
                                 O, s_in, inv_s_in, inv_out, act, f32_in, out_mode, \
                                 stream)
    if (ks == 5) return (int)L3(5, 1);
    return (int)(stride == 1 ? L3(3, 1) : L3(3, 2));
#undef L3
}

// xs: n_in (<= 3) (B, H, W, C_s) sections, C_s a multiple of 4, int8 (vec
// 16, 8 or 4: the bytes of a copy, dividing every C_s and section address)
// or float32 (vec 0, 16-byte aligned); w K5's packed bytes
// (QConv.packed_wgmma); y (B, H, W, O) or, with pool, (B, H/2, W/2, O),
// 16-byte aligned, int8 (out_mode 0), f32 (1) or bf16 (2); (bn, mi) the tile
// (24, 2), (48, 2), (64, 1), (128, 1) or (256, 1). Returns a cudaError_t.
extern "C" int conv1x1_q8(const void* x0, const void* x1, const void* x2,
                          int c0, int c1, int c2, int n_in, const void* w,
                          const float* s_w, const float* bias, void* y, int B,
                          int H, int W, int bn, int mi, int vec, int O,
                          int pool, int out_mode, float s_in, float inv_s_in,
                          float inv_out, int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    const long long rows = (long long)B * H * W;
    if (n_in < 1 || n_in > 3 || rows >= (1LL << 31) ||
        (out_mode != OUT_I8 && out_mode != OUT_F32 && out_mode != OUT_BF16) ||
        (pool && (H % 2 || W % 2)) || ((uintptr_t)y & 15) ||
        (vec != 0 && vec != 4 && vec != 8 && vec != 16))
        return (int)cudaErrorInvalidValue;
    const void* xp[3] = {x0, x1, x2};
    const int cs[3] = {c0, c1, c2};
    Sections secs;
    int g = 0;
    for (int s = 0; s < 3; ++s) {
        secs.g[s] = g;
        secs.x[s] = s < n_in ? xp[s] : nullptr;
        secs.c[s] = s < n_in ? cs[s] : 0;
        if (s >= n_in) continue;
        const int align = vec ? vec : 16;
        if (cs[s] <= 0 || cs[s] % 4 || (vec && cs[s] % vec) ||
            ((uintptr_t)xp[s] % align))
            return (int)cudaErrorInvalidValue;
        g += (cs[s] + 15) / 16;
    }
    secs.g[3] = g;
#define LT(V) launch1_tile<V>(bn, mi, secs, w, s_w, bias, y, rows, H, W, O, \
                              pool, s_in, inv_s_in, inv_out, act, out_mode,  \
                              stream)
    switch (vec) {
        case 16: return (int)LT(16);
        case 8: return (int)LT(8);
        case 4: return (int)LT(4);
        default: return (int)LT(0);
    }
#undef LT
}

// K4 and the dense 5x5 on wgmma: x (B, H, W, C), int8 (vec 16, 8 or 4: C a
// multiple of vec and x vec-byte aligned) or, at stride 1, float32 (vec 0:
// C a multiple of 4, x 16-byte aligned, quantized at 1 / inv_s_in while
// staging); ks 3 at stride 1 or 2 (pad 1), or 5 at stride 1 (pad 2); w
// QConv.packed_wgmma3 / packed_wgmma5; y (B, Ho, Wo, O), 16-byte aligned,
// int8 (out_mode 0), f32 (1) or bf16 (2); (bn, mi) the tile (24, 2),
// (48, 2), (64, 2) or, for a 3x3 at stride 1, (128, 2); tw the row width (at
// least ks - 1 rows of tw + ks - 1, stride 2 two of tw + 1, positions in
// 128 mi); act 0 none, 1 SiLU, 2 ReLU. Returns a cudaError_t.
extern "C" int conv_q8_wgmma(const void* x, const void* w, const float* s_w,
                             const float* bias, void* y, int B, int H, int W,
                             int C, int O, int ks, int stride, int bn, int mi,
                             int vec, int tw, int out_mode, float s_in,
                             float inv_s_in, float inv_out, int act,
                             void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    const int align = vec ? vec : 16;
    if (C <= 0 || (long long)B * H * W >= (1LL << 31) ||
        (out_mode != OUT_I8 && out_mode != OUT_F32 && out_mode != OUT_BF16) ||
        ((uintptr_t)y & 15) || !((ks == 3 && (stride == 1 || stride == 2)) ||
                                 (ks == 5 && stride == 1)) ||
        (vec != 0 && vec != 4 && vec != 8 && vec != 16) ||
        (vec == 0 && stride != 1) || C % (vec ? vec : 4) ||
        ((uintptr_t)x % align))
        return (int)cudaErrorInvalidValue;
#define LW(V, S, KS) launch_tile<V, S, KS>(bn, mi, x, w, s_w, bias, y, B, H, W, \
                                           C, O, tw, s_in, inv_s_in, inv_out,  \
                                           act, out_mode, stream)
    if (stride == 2) {
        switch (vec) {
            case 16: return (int)LW(16, 2, 3);
            case 8: return (int)LW(8, 2, 3);
            default: return (int)LW(4, 2, 3);
        }
    }
    if (ks == 5) {
        switch (vec) {
            case 16: return (int)LW(16, 1, 5);
            case 8: return (int)LW(8, 1, 5);
            case 4: return (int)LW(4, 1, 5);
            default: return (int)LW(0, 1, 5);
        }
    }
    switch (vec) {
        case 16: return (int)LW(16, 1, 3);
        case 8: return (int)LW(8, 1, 3);
        case 4: return (int)LW(4, 1, 3);
        default: return (int)LW(0, 1, 3);
    }
#undef LW
}
