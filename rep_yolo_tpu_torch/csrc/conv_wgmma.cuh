// The int8 wgmma convolution core shared by conv_flat.cu (K4 conv3x3_q8, K5
// conv1x1_q8, the dense 5x5 conv5x5_q8) and conv_cmajor_q8.cu (K13
// conv3x3_cmajor_q8): the epilogue passes of both wgmma kernels, and the
// KS x KS implicit GEMM conv_q8_wgmma_kernel with its launcher.
//
// conv_q8_wgmma_kernel<BN, MI, VEC, S, KS, CM>: pixels on M, output channels
// on N, both operands K-major in shared memory without swizzle
// (wgmma.mma_async m64nNk32.s32.s8.s8, wgmma.cuh). Per chunk of 32 input
// channels (two 16-channel groups) a block stages its input once: 16
// channels of a pixel are one 16-byte core-matrix row, each group a plane of
// pl rows (k4_pitch). A block computes th output rows x tw columns over
// MB = 128 MI positions m = r sw + c (c >= tw, the last sw - tw positions of
// a row, are computed and dropped).
// - S = 1: the halo'd tile, (th + KS - 1) x sw staged positions with
//   sw = tw + KS - 1, staged position p = rr sw + cc holding pixel
//   (y0 - KS/2 + rr, x0 - KS/2 + cc); tap (u, v) is a descriptor offset:
//   position m reads staged position m + u sw + v. KS = 3 (K4, K13) or 5
//   (the dense 5x5); a tile has at least KS - 1 rows, so the staged tile is
//   at most 2 MB positions.
// - S = 2 (KS = 3, NHWC int8): four row / column parity planes of
//   (th + 1) x sw positions, sw = tw + 1; tap (u, v) reads plane
//   (u != 1, v != 1) at position m + (u > 0) sw + (v > 0).
// - The input: CM = NHWC, channels-last int8 copied as it lies by cp.async
//   (VEC 16, 8 or 4 bytes a copy, the zero-filling form outside the image)
//   or float32 (VEC 0) through registers, quantized at s_in; CM = IN_I8,
//   IN_F32 or IN_BF16, NCHW (K13): a thread loads 4 channel planes' 16-byte
//   vectors of one tile row (aligned to the plane row, VP = 16 / size
//   pixels; loads of gin bytes where a row is not 16-byte aligned),
//   quantizes them in registers (qwords), turns each 4 channels x 4 pixels
//   into 4 words of (pixel, 4 channels) by __byte_perm (transpose4) and
//   stores each word into its position's 16-byte row. Pixels outside the
//   image are staged as zeros in every chunk (the border taps' weights are
//   not 0); channels past C are not staged, their packed weights are 0.
// - Weights: QConv.packed_wgmma3 / packed_wgmma5, [chunk][tap][O/8][2][8]
//   [16] (zeros in every pad), KS^2 x BN x 32 bytes a chunk, by cp.async
//   beside the input.
// - A ring of ring_stages(KS) stages: chunk ch + D (D = stages - 2) is
//   staged while chunk ch's wgmma group runs; cp.async.wait_group D - 1,
//   wgmma.wait_group 1 and one barrier a chunk. KS = 3 takes four stages
//   (D = 2); KS = 5 three (D = 1): a chunk's 25 taps of weights, 25 BN 32
//   bytes, would not fit four stages at BN 64.
// - Epilogue, NHWC: the s32 sums to shared memory ([m][channel], wg_sums),
//   the float epilogue a value a thread, consecutive threads on consecutive
//   channels (wg_epilogue), then runs of 16-byte stores (wg_store). NCHW:
//   the sums of the kept positions transposed and compacted into
//   [channel][r tw + c] (wg_sums_cm), then a thread takes 4 consecutive
//   pixels of one channel: one 16-byte shared load, the float epilogue, one
//   8-byte (bfloat16) or 4-byte (int8) store where W and tw are multiples
//   of 4 (cm_store).
//
// The s32 sums are exact in any order and the epilogue is q8_common.cuh's,
// so every route and tile equals its plain version bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "q8_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int WG_NT = 256;     // two warpgroups
constexpr int NS = 4;          // stages of K5's ring
constexpr int SMEM_MAX = 232448;
constexpr int NHWC = -1;       // conv_q8_wgmma_kernel's CM for NHWC input

// Stages of conv_q8_wgmma_kernel's ring, by tap count.
__host__ __device__ constexpr int ring_stages(int ks) {
    return ks == 3 ? 4 : 3;
}

// Bytes of an output value, by out_mode.
__host__ __device__ __forceinline__ int out_bytes(int out_mode) {
    return out_mode == OUT_F32 ? 4 : out_mode == OUT_BF16 ? 2 : 1;
}

// Pitch (words) of the s32 sums tile, off 0 and 16 words mod 32: a warp's
// 8-byte stores take two wavefronts.
__host__ __device__ constexpr int sums_pitch(int bn) {
    return (bn % 32 == 8 || bn % 32 == 24) ? bn : bn + 8;
}

// Pitch (words) of one channel of the NCHW sums tile over n positions: a
// multiple of 4 (16-byte loads), 4 mod 16, so the 4 lanes of a fragment
// quad (channels 2 apart) land 8 banks apart.
__host__ __device__ constexpr int cm_pitch(int n) {
    return ((n + 3) & ~3) + ((4 - ((n + 3) & ~3)) & 15);
}

// Bytes of the per-channel scale and bias at the front of shared memory.
__host__ __device__ constexpr int epi_bytes(int bn) {
    return (8 * bn + 127) / 128 * 128;
}

// The plane pitch (16-byte rows) of a stage. Stride 1: the taps reach
// MB + (KS - 1)(sw + 1) staged positions, rounded up to 4 mod 8, so a
// quarter-warp's staging stores (four pixels x the two groups) fall on
// distinct banks. Stride 2: MB + sw + 1, rounded up to 2 mod 8: the two
// groups then sit 2 and the two column-parity planes 4 rows (mod 8) apart,
// so four adjacent input pixels x the two groups fall on distinct banks.
__host__ __device__ __forceinline__ int k4_pitch(int mb, int sw, int s,
                                                 int ks) {
    const int p = s == 1 ? mb + (ks - 1) * (sw + 1) : mb + sw + 1;
    return p + (((s == 1 ? 4 : 2) - p) & 7);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// The 4 x 4 byte transpose: w[c] holds pixels 0..3 of channel c (byte j =
// pixel j); p[j] gets channels 0..3 of pixel j (byte c = channel c).
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

// 16 bytes of one channel's consecutive pixels as words of four int8 pixels
// (byte j = pixel j), quantized at 1 / inv_s unless already int8: 4 words
// (int8), 2 (bfloat16) or 1 (float32).
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

// The 16 bytes of a plane row from pixel col0 on (col0 a multiple of
// 16 / ES), as loads of gin bytes (16, or 8 / 4 / 2 / 1 where the row is not
// 16-byte aligned; gin >= ES): a load wholly outside [0, W) reads nothing
// and leaves zeros (W ES is a multiple of gin).
template <int ES>
__device__ __forceinline__ uint4 load_vec(const char* row, int col0, int W,
                                          int gin) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const char* src = row + (long long)col0 * ES;
    if (gin == 16) {
        if (col0 >= 0 && col0 < W)
            return __ldg(reinterpret_cast<const uint4*>(src));
    } else if (gin == 8) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const int c = col0 + p * 8 / ES;
            if (c >= 0 && c < W) {
                const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + p);
                w[2 * p] = v.x;
                w[2 * p + 1] = v.y;
            }
        }
    } else if (gin == 4) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const int c = col0 + p * 4 / ES;
            if (c >= 0 && c < W)
                w[p] = __ldg(reinterpret_cast<const uint32_t*>(src) + p);
        }
    } else if (gin == 2) {
#pragma unroll
        for (int p = 0; p < 8; ++p) {
            const int c = col0 + p * 2 / ES;
            if (c >= 0 && c < W)
                w[p >> 1] |= (uint32_t)__ldg(reinterpret_cast<const uint16_t*>(src)
                                             + p) << (16 * (p & 1));
        }
    } else {
#pragma unroll
        for (int p = 0; p < 16; ++p) {
            const int c = col0 + p;
            if (c >= 0 && c < W)
                w[p >> 2] |= (uint32_t)__ldg(reinterpret_cast<const uint8_t*>(src)
                                             + p) << (8 * (p & 3));
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
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

// Epilogue pass 1 for NCHW output: the fragments of the kept positions
// (m = r sw + c, r < th, c < tw) into sums[channel][r tw + c], pm words a
// channel (cm_pitch(th tw)).
template <int BN, int MI>
__device__ __forceinline__ void wg_sums_cm(int32_t (&acc)[MI][BN / 2],
                                           int32_t* sums, int pm, int sw,
                                           int tw, int th, int tid) {
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = (wg * MI + i) * 64 + warp * 16 + g4 + 8 * h;
            const int r = m / sw, c = m - r * sw;
            if (r >= th || c >= tw) continue;
            int32_t* s = sums + r * tw + c + 2 * t4 * pm;
#pragma unroll
            for (int jn = 0; jn < BN / 8; ++jn) {
                s[8 * jn * pm] = acc[i][4 * jn + 2 * h];
                s[(8 * jn + 1) * pm] = acc[i][4 * jn + 2 * h + 1];
            }
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

// Epilogue pass 2 for NCHW output: y (B, O, Ho, Wo), bfloat16 or int8 at
// 1 / inv_out; yb the element index of (b, n0, y0, x0). A thread takes 4
// consecutive kept positions k .. k + 3 (k = r tw + c) of one channel from
// sums[channel][k] (one 16-byte load), consecutive threads the next 4, and
// stores them at once where W and tw are multiples of 4 (then the four are
// one row's, 4-aligned), else one by one.
__device__ __forceinline__ void cm_store(const int32_t* sums, int pm,
                                         const float* s_sw, const float* s_b,
                                         void* y, long long yb, long long HWo,
                                         int Wo, int nc, int nr, int nx,
                                         int tw, int act, float inv_out,
                                         int out_mode, int tid) {
    const int ng = (nr * tw + 3) >> 2;
    const bool vec = (Wo & 3) == 0 && (tw & 3) == 0;
    const bool bf16 = out_mode == OUT_BF16;
    for (int e = tid; e < nc * ng; e += WG_NT) {
        const int c = e / ng, k = 4 * (e - c * ng);
        const int4 s4 = *reinterpret_cast<const int4*>(sums + c * pm + k);
        const float sws = s_sw[c], bc = s_b[c];
        const float v[4] = {epi_s(s4.x, sws, bc, act), epi_s(s4.y, sws, bc, act),
                            epi_s(s4.z, sws, bc, act), epi_s(s4.w, sws, bc, act)};
        int r = k / tw, cx = k - r * tw;
        const long long o = yb + c * HWo;
        if (vec && cx + 4 <= nx) {
            const long long i = o + (long long)r * Wo + cx;
            if (bf16) {
                *reinterpret_cast<uint2*>((__nv_bfloat16*)y + i) =
                    make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
            } else {
                uint32_t q = 0;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    q |= (uint32_t)(quant1(v[j], inv_out) & 0xff) << (8 * j);
                *reinterpret_cast<uint32_t*>((int8_t*)y + i) = q;
            }
            continue;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (r < nr && cx < nx) {
                const long long i = o + (long long)r * Wo + cx;
                if (bf16)
                    ((__nv_bfloat16*)y)[i] = __float2bfloat16_rn(v[j]);
                else
                    ((int8_t*)y)[i] = (int8_t)quant1(v[j], inv_out);
            }
            if (++cx == tw) {
                cx = 0;
                ++r;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The KS x KS conv on wgmma (K4's wgmma routes, the dense 5x5, K13)
// ---------------------------------------------------------------------------

// x: NHWC (B, H, W, C) (CM = NHWC): int8 (VEC 16, 8 or 4, the bytes of a
// cp.async; C a multiple of VEC) or float32 (VEC 0, stride 1; C a multiple
// of 4); or NCHW (B, C, H, W) (CM = IN_I8, IN_F32 or IN_BF16; stride 1,
// KS = 3; gin the bytes of a staging load). w QConv.packed_wgmma3 /
// packed_wgmma5: [chunk][tap][og][2][8][16]. grid (tiles, ceil(O / BN), B).
// A stage holds NP planes of the chunk's two groups, each group a plane of pl
// 16-byte rows, then the chunk's weights, KS^2 taps x BN x 32 bytes.
template <int BN, int MI, int VEC, int S, int KS, int CM>
__global__ void __launch_bounds__(WG_NT, (BN * MI <= 128) ? 2 : 1)
conv_q8_wgmma_kernel(const void* __restrict__ x,
                     const uint8_t* __restrict__ w,
                     const float* __restrict__ s_w,
                     const float* __restrict__ bias, void* __restrict__ y,
                     int H, int W, int Ho, int Wo, int C, int O, int og,
                     int nchunks, int tw, int th, int tiles_x, float s_in,
                     float inv_s_in, float inv_out, int act, int out_mode,
                     int gin) {
    static_assert(S == 1 || (VEC != 0 && KS == 3 && CM == NHWC),
                  "stride 2: a 3x3 on NHWC int8 input");
    static_assert(CM == NHWC || KS == 3, "NCHW input: a 3x3");
    constexpr int MB = 128 * MI, CB = VEC ? VEC : 16, P = 16 / CB;
    constexpr int NP = S == 1 ? 1 : 4;
    constexpr int NTAP = KS * KS, R = KS / 2;
    constexpr int NSTG = ring_stages(KS), D = NSTG - 2;
    // NHWC stride 1: copies a thread, (th + KS - 1) sw <= 2 MB staged
    // positions (th >= KS - 1) x two groups x P copies, over WG_NT threads
    constexpr int IPT = S == 1 ? 2 * P * MI : 1;
    constexpr int PPI = WG_NT / (2 * P);          // positions an iteration
    // NCHW: items (4 channels x a 16-byte vector of a tile row) a thread
    // holds in registers at once
    constexpr int CIPT = 2;
    extern __shared__ __align__(128) uint8_t smem[];
    float* s_sw = reinterpret_cast<float*>(smem);
    float* s_b = s_sw + BN;
    uint8_t* ring = smem + epi_bytes(BN);
    const int sw = S == 1 ? tw + KS - 1 : tw + 1, pl = k4_pitch(MB, sw, S, KS);
    const int abytes = NP * 2 * pl * 16, stage = abytes + NTAP * BN * 32;
    const int tid = threadIdx.x, wg = tid >> 7;
    const int y0 = (blockIdx.x / tiles_x) * th;
    const int x0 = (blockIdx.x % tiles_x) * tw;
    const int j0 = blockIdx.y * (BN / 8), n0 = 8 * j0, b = blockIdx.z;

    for (int i = tid; i < BN; i += WG_NT) {      // s_w * s_in, the bias
        s_sw[i] = n0 + i < O ? __fmul_rn(s_w[n0 + i], s_in) : 0.0f;
        s_b[i] = n0 + i < O ? bias[n0 + i] : 0.0f;
    }
    // NHWC: this thread copies CB bytes at byte cofs of a chunk's 32 (group
    // cofs / 16) for staged positions tid / (2 P) + it PPI (consecutive
    // lanes: consecutive bytes of a pixel, then the next pixel)
    const int cofs = (tid % (2 * P)) * CB;
    int pix[IPT];          // pixel index, -1 outside the image, -2 no copy
    if constexpr (S == 1 && CM == NHWC) {
        const int npos = (th + KS - 1) * sw;
#pragma unroll
        for (int it = 0; it < IPT; ++it) {
            const int p = tid / (2 * P) + it * PPI;
            const int rr = p / sw, cc = p - rr * sw;
            const int iy = y0 - R + rr, ix = x0 - R + cc;
            pix[it] = p >= npos ? -2
                      : (iy >= 0 && iy < H && ix >= 0 && ix < W)
                          ? (b * H + iy) * W + ix : -1;
        }
    }

    auto stage_in = [&](int ch, int st) {
        if constexpr (CM != NHWC) {
            // NCHW: items e = q + 8 (rr + (th + 2) v): channel quad q of the
            // chunk (consecutive lanes), tile row rr, the row's v-th 16-byte
            // vector from column a0 on; all of a pass's loads first, then
            // quantized, transposed and stored a word a pixel
            constexpr int ES = CM == IN_F32 ? 4 : CM == IN_BF16 ? 2 : 1;
            constexpr int VP = 16 / ES;
            const int c0 = ch * 32, nr2 = th + 2;
            const int a0 = (x0 - 1) & -VP;
            const int nv = (((x0 + tw) & -VP) - a0) / VP + 1;
            const int nitems = 8 * nr2 * nv;
            const char* xb = static_cast<const char*>(x)
                             + (long long)b * C * H * W * ES;
            uint8_t* dst = ring + st * stage;
#pragma unroll 1
            for (int e0 = 0; e0 < nitems; e0 += CIPT * WG_NT) {
                uint4 raw[CIPT][4];
#pragma unroll
                for (int it = 0; it < CIPT; ++it) {
                    const int e = e0 + tid + it * WG_NT;
                    const int q = e & 7, t = e >> 3, v = t / nr2;
                    const int iy = y0 - 1 + t - v * nr2;
                    const bool row = e < nitems && iy >= 0 && iy < H;
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int c = c0 + 4 * q + k;
                        raw[it][k] = make_uint4(0u, 0u, 0u, 0u);
                        if (row && c < C)
                            raw[it][k] = load_vec<ES>(
                                xb + ((long long)c * H + iy) * W * ES,
                                a0 + v * VP, W, gin);
                    }
                }
#pragma unroll
                for (int it = 0; it < CIPT; ++it) {
                    const int e = e0 + tid + it * WG_NT;
                    const int q = e & 7, t = e >> 3, v = t / nr2;
                    const int rr = t - v * nr2;
                    if (e >= nitems || c0 + 4 * q >= C) continue;
                    uint32_t cw[4][VP / 4];
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        qwords<CM>(raw[it][k], inv_s_in, cw[k]);
                    // staged column of the vector's first pixel
                    const int cc0 = a0 + v * VP - (x0 - 1);
                    uint8_t* d = dst + (q >> 2) * pl * 16 + (q & 3) * 4
                                 + rr * sw * 16;
#pragma unroll
                    for (int wi = 0; wi < VP / 4; ++wi) {
                        const uint32_t in4[4] = {cw[0][wi], cw[1][wi],
                                                 cw[2][wi], cw[3][wi]};
                        uint32_t p[4];
                        transpose4(in4, p);
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const int cc = cc0 + 4 * wi + j;
                            if (cc >= 0 && cc < sw)
                                *reinterpret_cast<uint32_t*>(d + cc * 16) = p[j];
                        }
                    }
                }
            }
        } else {
            const int c0 = ch * 32 + cofs;
            if (c0 >= C) return;     // past C: zero weights, any bytes will do
            uint8_t* dst = ring + st * stage + (cofs >> 4) * pl * 16
                           + (cofs & 15);
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
                // float32: every load of the chunk issued first (16-byte
                // loads, four a staged position), then quantized at s_in and
                // stored, 16 bytes a position (zeros outside the image)
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
                                       in ? xi + (long long)pix[it] * C + c0
                                          : xi,
                                       in);
                }
            }
        }
    };
    auto weights = [&](int ch, int st) {
        uint8_t* d = ring + st * stage + abytes;
        for (int e = tid; e < NTAP * BN * 2; e += WG_NT) {
            const int q = e & 15, jj = (e >> 4) % (BN / 8);
            const int tap = (e >> 4) / (BN / 8);
            if (j0 + jj < og)
                cp_async16(d + (tap * (BN / 8) + jj) * 256 + q * 16,
                           w + ((long long)(ch * NTAP + tap) * og + j0 + jj)
                                   * 256 + q * 16);
        }
    };

    int32_t acc[MI][BN / 2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0;

    // chunks 0 .. D - 1 staged, the last of them in flight
    stage_in(0, 0);
    weights(0, 0);
    cp_async_commit();
    if (D > 1 && nchunks > 1) {
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
        const int st = ch % NSTG;
        const uint32_t a0 = smem_addr(ring + st * stage), b0 = a0 + abytes;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        wgmma_fence();
        // the taps, one k32 step each (both groups of the chunk)
#pragma unroll
        for (int tap = 0; tap < NTAP; ++tap) {
            const int u = tap / KS, v = tap % KS;
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
        // while they run: chunk ch + D into the stage chunk ch + D - NSTG
        // used (its products were waited for, and the block passed a
        // barrier since). K5's wait shape (ptxas 12.9 segfaults on an
        // unconditional cp.async.wait_group 1 followed by the proxy fence
        // and wgmma.wait_group here); the register staging's st.shared
        // reach the tensor cores through the proxy fence below
        if (ch + D < nchunks) {
            stage_in(ch + D, (ch + D) % NSTG);
            weights(ch + D, (ch + D) % NSTG);
            cp_async_commit();
            cp_async_wait<D - 1>();  // chunk ch + 1 has landed
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

    const int nc = min(BN, O - n0);
    const int nr = min(th, Ho - y0), nx = min(tw, Wo - x0);
    int32_t* sums = reinterpret_cast<int32_t*>(ring);
    if constexpr (CM != NHWC) {
        // NCHW: the kept positions' sums by channel, then 4 pixels a thread
        const int pm = cm_pitch(th * tw);
        wg_sums_cm<BN, MI>(acc, sums, pm, sw, tw, th, tid);
        __syncthreads();
        cm_store(sums, pm, s_sw, s_b, y,
                 (((long long)b * O + n0) * Ho + y0) * Wo + x0,
                 (long long)Ho * Wo, Wo, nc, nr, nx, tw, act, inv_out,
                 out_mode, tid);
    } else {
        // as K5's: the sums; the float epilogue of the positions of the
        // rows inside the map (the dropped ones too, in place for float32);
        // then tile row r's columns inside the map, one run each
        constexpr int PW = sums_pitch(BN);
        wg_sums<BN, MI>(acc, sums, PW, tid);
        __syncthreads();
        const int es = out_bytes(out_mode);
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
                          && (Wo * ystride) % 16 == 0
                          && (sw * opitch) % 16 == 0;
        wg_store(out, opitch, nc * es, (int)ystride, nr, nx, al16,
                 [&](int s) { return s * sw; },
                 [&](int s) { return yb + s * Wo * ystride; }, tid);
    }
}

// A launch of conv_q8_wgmma_kernel; a tile of fewer than KS - 1 (stride 2:
// 2) rows of tw columns in 128 MI positions, or one whose shared memory
// (the ring's min(stages, chunks) stages, or the epilogue's tiles) is over
// SMEM_MAX, is refused.
template <int BN, int MI, int VEC, int S, int KS, int CM>
cudaError_t launch_wgmma(const void* x, const void* w, const float* s_w,
                         const float* bias, void* y, int B, int H, int W,
                         int C, int O, int tw, float s_in, float inv_s_in,
                         float inv_out, int act, int out_mode, int gin,
                         cudaStream_t stream) {
    constexpr int MB = 128 * MI;
    const int sw = S == 1 ? tw + KS - 1 : tw + 1, th = MB / sw;
    if (tw < 1 || th < (S == 1 ? KS - 1 : 2)) return cudaErrorInvalidValue;
    const int stage = (S == 1 ? 2 : 8) * k4_pitch(MB, sw, S, KS) * 16
                      + KS * KS * BN * 32;
    const int nchunks = (C + 31) / 32;
    const int es = out_bytes(out_mode);
    const int tile = CM == NHWC
        ? MB * sums_pitch(BN) * 4 + (es == 4 ? 0 : MB * BN * es)
        : BN * cm_pitch(th * tw) * 4;
    const int smem = epi_bytes(BN)
        + std::max(std::min(ring_stages(KS), nchunks) * stage, tile);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
    auto kernel = conv_q8_wgmma_kernel<BN, MI, VEC, S, KS, CM>;
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
        nchunks, tw, th, tiles_x, s_in, inv_s_in, inv_out, act, out_mode,
        gin);
    return cudaGetLastError();
}

}  // namespace
