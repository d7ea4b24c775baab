// Int8 convolutions of the int8 backbone region, for Hopper (sm_90a).
//
// K4 conv3x3_q8 replaces rep_yolo_tpu/ops/pallas/conv_flat.py:conv3x3_flat_q8
// (kernels _conv3_flat_q8_kernel / _pipe / _whole) and the stem's s2d form
// (nn/blocks.py:_stem_fast_q8): a 3x3 conv, stride 1 or 2, zero pad 1.
// K5 conv1x1_q8 replaces conv_flat.py:conv1x1_flat_q8 (_conv1_flat_q8_kernel,
// _conv1_pool_flat_q8_kernel): a 1x1 conv over 1-3 input sections (a concat
// that is never materialised), optionally followed by a 2x2/s2 max pool.
// K4 with 5x5 taps (KS = 5, halo 2, stride 1) replaces the dense case of
// conv_flat.py:conv5x5_flat_q8 (_conv5_flat_q8_kernel / _whole): the dp4a
// kernel, templated on its tap count.
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
// - "wgmma" (conv3x3_q8_wgmma_kernel, S = 1, VEC 16 / 8 / 4): a stride-1 3x3
//   on int8 input, on the int8 tensor cores: the DER blocks' st1-st6, the
//   neck's stride-1 3x3s, the xla_q8 blocks' int8 3x3s;
// - "wgmma_s2" (S = 2): a stride-2 3x3 on int8 input, the PAN's two GSConv
//   downsamples;
// - "wgmma_f32" (S = 1, VEC 0): a stride-1 3x3 on float32 input with C a
//   multiple of 4 at a 16-byte-aligned address, quantized while staging:
//   the xla_q8 blocks' four st1s;
// - "dp4a" (conv3x3_q8_kernel): everything else, the float32 stem (C = 3,
//   stride 2) and the dense 5x5.
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
// K4 (int8 tensor cores, the three wgmma routes): an implicit GEMM on
// wgmma.mma_async m64nNk32.s32.s8.s8, pixels on M, output channels on N,
// both operands K-major in shared memory without swizzle, as K5 below.
// - A block computes th output rows x tw columns over MB = 128 MI
//   positions m = r sw + c (c >= tw, the sw - tw last positions a row, are
//   computed and dropped, as K10 in conv_kernel.cu). tw (k4_route) is the
//   width that wastes the fewest positions over the map, with at least two
//   rows a tile.
// - Per chunk of 32 input channels (two 16-channel groups) the block stages
//   its input once: 16 channels of a pixel are one 16-byte core-matrix row,
//   each group a plane of pl rows (k4_pitch: the staging stores of a
//   quarter-warp fall on distinct banks). Pixels outside the image are
//   staged as zeros in every chunk, so a reused stage holds no stale halo
//   (the border taps' weights are not 0). Channels past C in the last chunk
//   are not staged: the packed weights (QConv.packed_wgmma3,
//   [chunk][tap][O/8][2][8][16]) are zero there, and past O.
// - Stride 1: the halo'd tile, (th + 2) x sw pixels with sw = tw + 2; tap
//   (u, v) is a descriptor offset: position m reads staged position
//   m + u sw + v. Int8 pixels are copied as they are by cp.async (16, 8 or
//   4 bytes a copy, VEC, the largest that divides C and x's address), the
//   out-of-image ones by its zero-filling form (src-size 0); float32 pixels
//   (VEC 0) go through registers as K5's float sections, four 16-byte loads
//   a position, quant1 at 1 / s_in, one 16-byte store, zeros stored outside
//   the image; a thread issues all its loads of a chunk before its first
//   store, so their latencies overlap.
// - Stride 2: output (i, j) reads input (2 i + u - 1, 2 j + v - 1). The
//   input is staged split into four planes by row and column parity, each
//   (th + 1) x sw positions with sw = tw + 1; tap (u, v) reads plane
//   (u != 1, v != 1) at position m + (u > 0) sw + (v > 0). So each tap is
//   again one descriptor offset and a chunk does 9 C of K work, as at
//   stride 1 (the TPU's space-to-depth lattice would run 16 taps over 4 C
//   channels). A thread walks the input tile in raster order (coalesced
//   reads), each pixel by the zero-filling cp.async into its plane.
// - A chunk is nine k32 steps, one a tap, on one staged stage; its weights
//   (9 x BN x 32 bytes) are staged beside it.
// - BN = 24, 48, 64 or 128 output channels a block, the smallest that holds
//   O (128 above it: four stages of 256 channels' nine taps would not fit;
//   stride 2 stops at 64, its four planes making a stage about 57 KB),
//   narrower down to 64 where that grid is under two blocks an SM. MI = 2
//   (256 positions a block) at every BN: with one 64-row tile a warpgroup
//   (K5's MI = 1 at BN 64 / 128), ptxas serialized the nine taps' wgmmas
//   (C7515). K5's ring of four stages, its wait shape and its three-pass
//   epilogue (wg_sums / wg_epilogue / wg_store, shared by both kernels).
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

#include "q8_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TO = 32;         // output channels per block
constexpr int OPT = 8;         // output channels per thread (one warp's share)
constexpr int PPT = 4;         // pixels per thread
constexpr int NTHREADS = 128;  // 4 warps
constexpr int TILE_H = 8;      // K4 output tile: 8 rows x 16 columns
constexpr int TILE_W = 16;

// Output types (the wrappers' out_mode).
constexpr int OUT_I8 = 0;
constexpr int OUT_F32 = 1;
constexpr int OUT_BF16 = 2;

__device__ __forceinline__ int odd_pitch(int kp) { return kp | 1; }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

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
// The wgmma kernels' shared parts (K4 on wgmma, K5)
// ---------------------------------------------------------------------------

constexpr int WG_NT = 256;     // two warpgroups
constexpr int NS = 4;          // stages of the ring
constexpr int SMEM_MAX = 232448;

// Bytes of an output value, by out_mode.
__host__ __device__ __forceinline__ int out_bytes(int out_mode) {
    return out_mode == OUT_F32 ? 4 : out_mode == OUT_BF16 ? 2 : 1;
}

// Pitch (words) of the s32 sums tile, off 0 and 16 words mod 32: a warp's
// 8-byte stores take two wavefronts.
__host__ __device__ constexpr int sums_pitch(int bn) {
    return (bn % 32 == 8 || bn % 32 == 24) ? bn : bn + 8;
}

// Bytes of the per-channel scale and bias at the front of shared memory.
__host__ __device__ constexpr int epi_bytes(int bn) {
    return (8 * bn + 127) / 128 * 128;
}

// Epilogue pass 1: the warpgroups' s32 fragments into sums[m][pw], m the
// block's row (MB = 128 MI rows).
template <int BN, int MI>
__device__ __forceinline__ void wg_sums(int32_t (&acc)[MI][BN / 2],
                                        int32_t* sums, int pw, int tid) {
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = (wg * MI + i) * 64 + warp * 16 + g4 + 8 * h;
#pragma unroll
            for (int jn = 0; jn < BN / 8; ++jn)
                *reinterpret_cast<int2*>(sums + m * pw + 8 * jn + 2 * t4) =
                    make_int2(acc[i][4 * jn + 2 * h], acc[i][4 * jn + 2 * h + 1]);
        }
}

// Epilogue pass 2 (kept out of the unrolled code): rows 0 .. nrow - 1 and
// columns 0 .. nc - 1 of the sums (pooled: row r the max over sums rows
// 4 r .. 4 r + 3) through the float epilogue, in the output type, into out
// (opitch bytes a row). A thread keeps one column, its scale and bias in
// registers, and steps over rows; consecutive threads take consecutive
// columns.
__device__ __forceinline__ void wg_epilogue(const int32_t* sums, int pw,
                                            int pool, const float* s_sw,
                                            const float* s_b, uint8_t* out,
                                            int opitch, int nrow, int nc,
                                            int act, float inv_out,
                                            int out_mode, int tid) {
    const int es = out_bytes(out_mode);
    const int rstep = WG_NT / nc, c = tid % nc;
    if (tid >= rstep * nc) return;
    const float sws = s_sw[c], bc = s_b[c];
#pragma unroll 4
    for (int r = tid / nc; r < nrow; r += rstep) {
        const int32_t* sr = sums + (pool ? 4 * r : r) * pw + c;
        float v = epi_s(sr[0], sws, bc, act);
        if (pool) {
#pragma unroll
            for (int j = 1; j < 4; ++j)
                v = fmaxf(v, epi_s(sr[j * pw], sws, bc, act));
        }
        uint8_t* d = out + r * opitch + c * es;
        if (out_mode == OUT_F32)
            *reinterpret_cast<float*>(d) = v;
        else if (out_mode == OUT_BF16)
            *reinterpret_cast<__nv_bfloat16*>(d) = __float2bfloat16_rn(v);
        else
            *reinterpret_cast<int8_t*>(d) = (int8_t)quant1(v, inv_out);
    }
}

// Epilogue pass 3: runs of out rows to y. Run s (< nrun) is out rows
// first(s) .. first(s) + len - 1 (opitch bytes apart, rowb bytes used each),
// written from dst(s) on, ystride bytes apart. al16: every run starts on a
// 16-byte boundary in out and in y. Where the rows of a run are contiguous on
// both sides (a block that holds all O channels), a run is one range copied
// by 16 bytes; else rows by 16 bytes where rows and strides allow, else
// bytes.
template <typename First, typename Dst>
__device__ __forceinline__ void wg_store(const uint8_t* out, int opitch,
                                         int rowb, int ystride, int nrun,
                                         int len, bool al16, First first,
                                         Dst dst, int tid) {
    if (opitch == rowb && ystride == rowb && al16) {
        const int total = len * rowb, per = (total + 15) / 16;
        for (int idx = tid; idx < nrun * per; idx += WG_NT) {
            const int s = idx / per, f = 16 * (idx - s * per);
            uint8_t* d = dst(s);
            const uint8_t* src = out + first(s) * opitch;
            if (f + 16 <= total)
                *reinterpret_cast<uint4*>(d + f) =
                    *reinterpret_cast<const uint4*>(src + f);
            else
                for (int q = f; q < total; ++q) d[q] = src[q];
        }
    } else if (al16 && rowb % 16 == 0 && opitch % 16 == 0 &&
               ystride % 16 == 0) {
        const int per = rowb / 16, n = len * per;
        for (int idx = tid; idx < nrun * n; idx += WG_NT) {
            const int s = idx / n, rem = idx - s * n;
            const int r = rem / per, k = rem - r * per;
            *reinterpret_cast<uint4*>(dst(s) + (long long)r * ystride + 16 * k) =
                *reinterpret_cast<const uint4*>(out + (first(s) + r) * opitch
                                                + 16 * k);
        }
    } else {
        const int n = len * rowb;
        for (int idx = tid; idx < nrun * n; idx += WG_NT) {
            const int s = idx / n, rem = idx - s * n;
            const int r = rem / rowb, k = rem - r * rowb;
            dst(s)[(long long)r * ystride + k] =
                out[(first(s) + r) * opitch + k];
        }
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

// ---------------------------------------------------------------------------
// K4 on wgmma: 3x3, pad 1; stride 1 on int8 or float32 input, stride 2 on
// int8 input
// ---------------------------------------------------------------------------

// The plane pitch (16-byte rows) of a K4 stage. Stride 1: the taps reach
// MB + 2 sw + 2 staged positions, rounded up to 4 mod 8, so a quarter-warp's
// staging stores (four pixels x the two groups) fall on distinct banks.
// Stride 2: MB + sw + 1, rounded up to 2 mod 8: the two groups then sit 2
// and the two column-parity planes 4 rows (mod 8) apart, so four adjacent
// input pixels x the two groups fall on distinct banks.
__host__ __device__ __forceinline__ int k4_pitch(int mb, int sw, int s) {
    const int p = s == 1 ? mb + 2 * sw + 2 : mb + sw + 1;
    return p + (((s == 1 ? 4 : 2) - p) & 7);
}

// x (B, H, W, C): int8 (VEC 16, 8 or 4, the bytes of a cp.async; C a
// multiple of VEC) or float32 (VEC 0, stride 1; C a multiple of 4); w
// QConv.packed_wgmma3: [chunk][tap][og][2][8][16] (chunk = 32 input
// channels, two groups of 16; zeros past C and past O). grid (tiles,
// ceil(O / BN), B). A block computes output rows [y0, y0 + th) x columns
// [x0, x0 + tw) of the (Ho, Wo) map for BN output channels over MB = 128 MI
// positions m = r sw + c (c < tw and r < th kept). A stage holds NP planes
// of the chunk's two groups, each group a plane of pl 16-byte rows, then the
// chunk's weights, 9 taps x BN x 32 bytes.
// - S = 1 (sw = tw + 2, NP = 1): staged position p = rr sw + cc holds pixel
//   (y0 - 1 + rr, x0 - 1 + cc); tap (u, v) reads position m + u sw + v.
// - S = 2 (sw = tw + 1, NP = 4): output (i, j) reads input (2 i + u - 1,
//   2 j + v - 1). Plane (a, b) (index 2 a + b) holds the input pixels of row
//   parity a and column parity b: its position rr sw + cc holds input
//   (2 (y0 - 1 + rr) + a, 2 (x0 - 1 + cc) + b). Tap (u, v) reads plane
//   (u != 1, v != 1) at position m + (u > 0) sw + (v > 0).
// Pixels outside the image are staged as zeros in every chunk (cp.async's
// zero fill; for float32 stored zeros), so a reused stage holds no stale
// halo: the border taps' weights are not 0.
template <int BN, int MI, int VEC, int S>
__global__ void __launch_bounds__(WG_NT, (BN * MI <= 128) ? 2 : 1)
conv3x3_q8_wgmma_kernel(const void* __restrict__ x,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ s_w,
                        const float* __restrict__ bias, void* __restrict__ y,
                        int H, int W, int Ho, int Wo, int C, int O, int og,
                        int nchunks, int tw, int th, int tiles_x, float s_in,
                        float inv_s_in, float inv_out, int act,
                        int out_mode) {
    static_assert(S == 1 || VEC != 0, "float32 input at stride 1 only");
    constexpr int MB = 128 * MI, CB = VEC ? VEC : 16, P = 16 / CB;
    constexpr int NP = S == 1 ? 1 : 4;
    // stride 1: copies a thread, (th + 2) sw <= 2 MB staged positions
    // (th >= 2) x two groups x P copies, over WG_NT threads
    constexpr int IPT = S == 1 ? 2 * P * MI : 1;
    constexpr int PPI = WG_NT / (2 * P);          // positions an iteration
    extern __shared__ __align__(128) uint8_t smem[];
    float* s_sw = reinterpret_cast<float*>(smem);
    float* s_b = s_sw + BN;
    uint8_t* ring = smem + epi_bytes(BN);
    const int sw = tw + 3 - S, pl = k4_pitch(MB, sw, S);
    const int abytes = NP * 2 * pl * 16, stage = abytes + 9 * BN * 32;
    const int tid = threadIdx.x, wg = tid >> 7;
    const int y0 = (blockIdx.x / tiles_x) * th;
    const int x0 = (blockIdx.x % tiles_x) * tw;
    const int j0 = blockIdx.y * (BN / 8), n0 = 8 * j0, b = blockIdx.z;

    for (int i = tid; i < BN; i += WG_NT) {      // s_w * s_in, the bias
        s_sw[i] = n0 + i < O ? __fmul_rn(s_w[n0 + i], s_in) : 0.0f;
        s_b[i] = n0 + i < O ? bias[n0 + i] : 0.0f;
    }
    // this thread copies CB bytes at byte cofs of a chunk's 32 (group
    // cofs / 16) for staged positions tid / (2 P) + it PPI (consecutive
    // lanes: consecutive bytes of a pixel, then the next pixel)
    const int cofs = (tid % (2 * P)) * CB;
    int pix[IPT];          // pixel index, -1 outside the image, -2 no copy
    if constexpr (S == 1) {
        const int npos = (th + 2) * sw;
#pragma unroll
        for (int it = 0; it < IPT; ++it) {
            const int p = tid / (2 * P) + it * PPI;
            const int rr = p / sw, cc = p - rr * sw;
            const int iy = y0 - 1 + rr, ix = x0 - 1 + cc;
            pix[it] = p >= npos ? -2
                      : (iy >= 0 && iy < H && ix >= 0 && ix < W)
                          ? (b * H + iy) * W + ix : -1;
        }
    }

    auto stage_in = [&](int ch, int st) {
        const int c0 = ch * 32 + cofs;
        if (c0 >= C) return;     // past C: zero weights, any bytes will do
        uint8_t* dst = ring + st * stage + (cofs >> 4) * pl * 16 + (cofs & 15);
        if constexpr (S == 2) {
            // the input rows 2 (y0 - 1) .. 2 (y0 + th) + 1 and columns
            // 2 (x0 - 1) .. 2 (x0 - 1 + sw) - 1, in raster order, each
            // pixel into its plane
            const int rw = 2 * sw, npix = 2 * (th + 1) * rw;
            const int8_t* xi = static_cast<const int8_t*>(x);
#pragma unroll 1
            for (int p = tid / (2 * P); p < npix; p += PPI) {
                const int ri = p / rw, ci = p - ri * rw;
                const int iy = 2 * (y0 - 1) + ri, ix = 2 * (x0 - 1) + ci;
                const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
                const int q = ((ri & 1) * 2 + (ci & 1)) * 2 * pl
                              + (ri >> 1) * sw + (ci >> 1);
                cp_async_zfill<CB>(
                    dst + q * 16,
                    in ? xi + ((long long)(b * H + iy) * W + ix) * C + c0
                       : xi, in);
            }
        } else if constexpr (VEC == 0) {
            // float32: every load of the chunk issued first (16-byte loads,
            // four a staged position), then quantized at s_in and stored,
            // 16 bytes a position (zeros outside the image)
            float4 f[IPT][4];
#pragma unroll
            for (int it = 0; it < IPT; ++it)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    f[it][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                    if (pix[it] >= 0 && c0 + 4 * k < C)
                        f[it][k] = reinterpret_cast<const float4*>(
                            static_cast<const float*>(x)
                            + (long long)pix[it] * C + c0)[k];
                }
#pragma unroll
            for (int it = 0; it < IPT; ++it) {
                if (pix[it] == -2) continue;
                uint32_t q[4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    q[k] = (quant1(f[it][k].x, inv_s_in) & 0xff)
                           | (quant1(f[it][k].y, inv_s_in) & 0xff) << 8
                           | (quant1(f[it][k].z, inv_s_in) & 0xff) << 16
                           | (uint32_t)(quant1(f[it][k].w, inv_s_in) & 0xff)
                                 << 24;
                *reinterpret_cast<uint4*>(dst + (tid / (2 * P) + it * PPI)
                                          * 16) =
                    make_uint4(q[0], q[1], q[2], q[3]);
            }
        } else {
#pragma unroll
            for (int it = 0; it < IPT; ++it) {
                if (pix[it] == -2) continue;
                const bool in = pix[it] >= 0;
                const int8_t* xi = static_cast<const int8_t*>(x);
                cp_async_zfill<CB>(dst + (tid / (2 * P) + it * PPI) * 16,
                                   in ? xi + (long long)pix[it] * C + c0 : xi,
                                   in);
            }
        }
    };
    auto weights = [&](int ch, int st) {
        uint8_t* d = ring + st * stage + abytes;
        for (int e = tid; e < 9 * BN * 2; e += WG_NT) {
            const int q = e & 15, jj = (e >> 4) % (BN / 8);
            const int tap = (e >> 4) / (BN / 8);
            if (j0 + jj < og)
                cp_async16(d + (tap * (BN / 8) + jj) * 256 + q * 16,
                           w + ((long long)(ch * 9 + tap) * og + j0 + jj) * 256
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
        const uint32_t a0 = smem_addr(ring + st * stage), b0 = a0 + abytes;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        wgmma_fence();
        // the nine taps, one k32 step each (both groups of the chunk)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int u = tap / 3, v = tap % 3;
            const int shift = S == 1 ? u * sw + v
                              : ((u != 1) * 2 + (v != 1)) * 2 * pl
                                    + (u > 0) * sw + (v > 0);
            const uint64_t db = gmma_desc(b0 + tap * BN * 32, 128, 256);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                const int m = (wg * MI + i) * 64 + shift;
                wgmma_s8<BN>(acc[i], gmma_desc(a0 + m * 16, pl * 16, 128), db);
            }
        }
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        // K5's wait shape (see there); the float32 staging's st.shared
        // reach the tensor cores through the proxy fence below
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

    // epilogue as K5's: the sums; the float epilogue of the positions of
    // the rows inside the map (the dropped ones too, in place for
    // float32); then tile row r's columns inside the map, one run each
    constexpr int PW = sums_pitch(BN);
    int32_t* sums = reinterpret_cast<int32_t*>(ring);
    wg_sums<BN, MI>(acc, sums, PW, tid);
    __syncthreads();
    const int nc = min(BN, O - n0);
    const int es = out_bytes(out_mode);
    const int nr = min(th, Ho - y0), nx = min(tw, Wo - x0);
    const bool in_place = es == 4;
    uint8_t* out = in_place ? ring : ring + MB * PW * 4;
    const int opitch = in_place ? PW * 4 : nc * es;
    wg_epilogue(sums, PW, 0, s_sw, s_b, out, opitch, nr * sw, nc, act,
                inv_out, out_mode, tid);
    __syncthreads();
    const long long ystride = (long long)O * es;
    uint8_t* yb = static_cast<uint8_t*>(y)
                  + ((((long long)b * Ho + y0) * Wo + x0) * O + n0) * es;
    const bool al16 = ((long long)x0 * O + n0) * es % 16 == 0
                      && (Wo * ystride) % 16 == 0 && (sw * opitch) % 16 == 0;
    wg_store(out, opitch, nc * es, (int)ystride, nr, nx, al16,
             [&](int s) { return s * sw; },
             [&](int s) { return yb + s * Wo * ystride; }, tid);
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

template <int BN, int MI, int VEC, int S>
cudaError_t launch3w(const void* x, const void* w, const float* s_w,
                     const float* bias, void* y, int B, int H, int W, int C,
                     int O, int tw, float s_in, float inv_s_in, float inv_out,
                     int act, int out_mode, cudaStream_t stream) {
    constexpr int MB = 128 * MI;
    const int sw = tw + 3 - S, th = MB / sw;
    if (tw < 1 || th < 2) return cudaErrorInvalidValue;
    const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
    const int stage = (S == 1 ? 2 : 8) * k4_pitch(MB, sw, S) * 16 + 9 * BN * 32;
    const int nchunks = (C + 31) / 32;
    const int es = out_bytes(out_mode);
    const int tile = MB * sums_pitch(BN) * 4 + (es == 4 ? 0 : MB * BN * es);
    const int smem = epi_bytes(BN) + std::max(std::min(NS, nchunks) * stage,
                                              tile);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    auto kernel = conv3x3_q8_wgmma_kernel<BN, MI, VEC, S>;
    static bool allowed = false;      // the attribute once, at its maximum
    if (!allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return err;
        allowed = true;
    }
    const int tiles_x = (Wo + tw - 1) / tw;
    dim3 grid(tiles_x * ((Ho + th - 1) / th), (O + BN - 1) / BN, B);
    kernel<<<grid, WG_NT, smem, stream>>>(
        x, (const uint8_t*)w, s_w, bias, y, H, W, Ho, Wo, C, O, (O + 7) / 8,
        nchunks, tw, th, tiles_x, s_in, inv_s_in, inv_out, act, out_mode);
    return cudaGetLastError();
}

// Stride 2 stops at BN 64: four stages of four planes and 128 channels'
// nine taps would not fit.
template <int VEC, int S>
cudaError_t launch3w_tile(int bn, int mi, const void* x, const void* w,
                          const float* s_w, const float* bias, void* y, int B,
                          int H, int W, int C, int O, int tw, float s_in,
                          float inv_s_in, float inv_out, int act,
                          int out_mode, cudaStream_t stream) {
#define L3W(BN, MI) launch3w<BN, MI, VEC, S>(x, w, s_w, bias, y, B, H, W, C, \
                                             O, tw, s_in, inv_s_in, inv_out, \
                                             act, out_mode, stream)
    if (bn == 24 && mi == 2) return L3W(24, 2);
    if (bn == 48 && mi == 2) return L3W(48, 2);
    if (bn == 64 && mi == 2) return L3W(64, 2);
    if constexpr (S == 1)
        if (bn == 128 && mi == 2) return L3W(128, 2);
#undef L3W
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

// K4 on wgmma: x (B, H, W, C), int8 (vec 16, 8 or 4: C a multiple of vec
// and x vec-byte aligned) or, at stride 1, float32 (vec 0: C a multiple of
// 4, x 16-byte aligned, quantized at 1 / inv_s_in while staging); stride 1
// or 2, pad 1; w QConv.packed_wgmma3; y (B, Ho, Wo, O), 16-byte aligned,
// int8 (out_mode 0), f32 (1) or bf16 (2); (bn, mi) the tile (24, 2),
// (48, 2), (64, 2) or, at stride 1, (128, 2); tw the row width (at least
// two rows of tw + 2, stride 2 tw + 1, positions in 128 mi); act 0 none,
// 1 SiLU, 2 ReLU. Returns a cudaError_t.
extern "C" int conv3x3_q8_wgmma(const void* x, const void* w, const float* s_w,
                                const float* bias, void* y, int B, int H,
                                int W, int C, int O, int stride, int bn,
                                int mi, int vec, int tw, int out_mode,
                                float s_in, float inv_s_in, float inv_out,
                                int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    const int align = vec ? vec : 16;
    if (C <= 0 || (long long)B * H * W >= (1LL << 31) ||
        (out_mode != OUT_I8 && out_mode != OUT_F32 && out_mode != OUT_BF16) ||
        ((uintptr_t)y & 15) || (stride != 1 && stride != 2) ||
        (vec != 0 && vec != 4 && vec != 8 && vec != 16) ||
        (vec == 0 && stride != 1) || C % (vec ? vec : 4) ||
        ((uintptr_t)x % align))
        return (int)cudaErrorInvalidValue;
#define LW(V, S) launch3w_tile<V, S>(bn, mi, x, w, s_w, bias, y, B, H, W, C, \
                                     O, tw, s_in, inv_s_in, inv_out, act,   \
                                     out_mode, stream)
    if (stride == 2) {
        switch (vec) {
            case 16: return (int)LW(16, 2);
            case 8: return (int)LW(8, 2);
            default: return (int)LW(4, 2);
        }
    }
    switch (vec) {
        case 16: return (int)LW(16, 1);
        case 8: return (int)LW(8, 1);
        case 4: return (int)LW(4, 1);
        default: return (int)LW(0, 1);
    }
#undef LW
}
