// Channel-major convolutions of the DER blocks' "bf16" deploy path, for
// Hopper (sm_90a).
//
// K10 conv3x3_cmajor replaces rep_yolo_tpu/ops/pallas/conv_kernel.py:
// conv3x3_cmajor (kernel _conv3_kernel): a 3x3 stride-1 conv with zero
// padding 1, then bias and SiLU (or no activation).
// K11 conv1x1_cmajor replaces conv_kernel.py:conv1x1_cmajor (_conv1_kernel):
// a 1x1 conv with the same epilogue, over 1-3 input sections (the DER
// block's concat [x1, x4_1, x4_3] is read section by section and never
// materialised).
//
// Layout: NCHW (B, C, H, W) in, (B, O, H, W) out, in x's dtype (bfloat16
// or float32). The sums are float32; the epilogue y = acc + bias, then
// y * sigmoid(y) with expf, is float32 and rounds once (the JAX _epilogue).
// The weights arrive packed once per model by the wrapper
// (ops/kernels/conv_kernel.py) in the order the kernels read them.
//
// What bounds them on this card: a 3x3 does 18 C O FLOPs a pixel against
// 2 (C + O) bytes, 216 FLOP/byte at the DER's thinnest (24 -> 24, 48 -> 48
// at 320 / 160 px) and up to 1150 at l7 (256 -> 256 at 40 px), against the
// 295 FLOP/byte at which the bf16 tensor cores (989 TFLOP/s) rather than
// HBM (3.35 TB/s) set the floor; the 1x1s do 2 C O against 2 (C + O), 16-340
// FLOP/byte, bound by their bytes but for l7 cv1 (768 -> 512). So the thin
// maps need the input read about once and whole sectors written, and the
// wide ones (128-512 channels at 80 / 40 px) the tensor cores' wgmma rate.
//
// bfloat16: implicit GEMMs on wgmma.mma_async m64nNk16 (float32
// accumulators), pixels on M and output channels on N, both operands read
// by the tensor cores from shared memory through descriptors without
// swizzle (a core matrix is 8 rows x 16 bytes stored as 128 contiguous
// bytes). Two warpgroups a block, each MI x 64 positions by BN channels.
// - Pixels on M, because N may be any multiple of 8: O = 24 / 48 pad
//   nothing, and one block holds up to 128 (3x3) or 256 (1x1) output
//   channels, so l7 cv1's O = 512 stages its input twice (32 channels a
//   block, as before: 16 times). Output channels on M would waste most of
//   a 64-row tile at O = 24 / 48.
// - The input is staged K-major, one 16-byte row per pixel holding 8
//   channels: a thread loads 16 bytes (8 pixels of one channel) of 8
//   channels and transposes them with __byte_perm. A pixel being 16 bytes,
//   a 3x3 tap's shift is a descriptor offset: the block computes its tile
//   over the halo'd row width SW = TW + 2 (two extra positions a row,
//   computed and dropped), and position m reads staged position
//   m + u SW + v for tap (u, v). The halo'd tile is staged once per 16
//   input channels for all nine taps and all BN output channels.
// - The weights, packed as [k16 step][O / 8][2][8 o][8 k] (B's core
//   matrices in order), come in by 16-byte cp.async.
// - A ring of four stages: a chunk's input is loaded into registers two
//   chunks ahead and stored to its stage one chunk ahead, its weights
//   copied two chunks ahead, all while the current chunk's wgmma group
//   runs; wgmma.wait_group 1 and one block barrier a chunk free the stage
//   that the chunk three back used.
// - Epilogue: bias and SiLU in float32 on the accumulators, one rounding,
//   the tile in shared memory, then 16-byte stores of 8 consecutive pixels
//   of one output channel.
// - Tiles are fixed per shape by the C entries (not timed). 3x3: BN = 24 /
//   48 over 256 positions, two blocks an SM; 64 over 512; 128 over 256
//   (larger O in tiles of 128). 1x1: BN = 24 / 48 over 256 pixels with 32
//   input channels a chunk, two blocks an SM; 64 / 128 over 256 and 256
//   over 128 with 64 channels a chunk. The 3x3 row width TW (a multiple of
//   8, at most 96) is the one that wastes the fewest positions. Maps whose
//   W (3x3) or H*W (1x1) is not a multiple of 8, or unaligned tensors,
//   take the same kernels with scalar loads and stores.
// - What holds it back: at the wide shapes every block stages the weights
//   of its BN channels anew from L2 for its 128-512 positions (two
//   warpgroups' float32 accumulators cap the tile at 256 x 128); at the thin
//   ones the float32 SiLU (expf and an IEEE division a value), the staging
//   transposes and the products each take a like share and overlap little
//   (a split measured once and not kept; a committed script that splits
//   the time is the first step of ROADMAP.md §B, "Ported, not yet fast",
//   the K10 / K11 item).
//
// float32: FFMA; a thread holds 8 output channels x 4 pixels (weights
// broadcast per warp, pixels on consecutive lanes), as K4 does with dp4a.
//
// The TPU kernel's 128-lane padded width, the flattened-row lane slabs and
// the row tiles were Mosaic's constraints and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

constexpr int NT = 128;        // float32 kernels: 4 warps
constexpr int BM = 32;         // float32 kernels: output channels per block
constexpr int TH = 8;          // float32 3x3 output tile: 8 rows x 16 columns
constexpr int TW = 16;
constexpr int SH = TH + 2;     // the halo'd input tile
constexpr int SW = TW + 2;
constexpr int TP = 128;        // float32 1x1: pixels per block

__device__ __forceinline__ float epilogue(float acc, float b, int act) {
    float y = acc + b;
    return act ? y / (1.0f + expf(-y)) : y;
}

// Channel c of image b among up to three sections (c < C0 + C1 + C2).
template <typename T>
__device__ __forceinline__ const T* section_plane(
        const T* x0, const T* x1, const T* x2, int C0, int C1, int C2, int b,
        int c, long long HW) {
    if (c < C0) return x0 + ((long long)b * C0 + c) * HW;
    c -= C0;
    if (c < C1) return x1 + ((long long)b * C1 + c) * HW;
    return x2 + ((long long)b * C2 + (c - C1)) * HW;
}

// ---------------------------------------------------------------------------
// bfloat16, wgmma
// ---------------------------------------------------------------------------

constexpr int WG_NT = 256;              // threads a block: two warpgroups
constexpr int NS = 4;                   // stages of the ring

// Row j of the transpose of 8 channels x 8 pixels: pixel j's 8 channels
// as 16 bytes. v[4 i + q]: channel i, pixels 2q (low half) and 2q + 1.
__device__ __forceinline__ void store_row(uint8_t* dst, const uint32_t* v,
                                          int j) {
    uint32_t p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        p[q] = __byte_perm(v[8 * q + j / 2], v[8 * q + 4 + j / 2],
                           (j & 1) ? 0x7632 : 0x5410);
    *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
}

// 8 consecutive bfloat16 of a plane from pixel p on (zeros past n, or for
// a null plane) as four words of pixel pairs.
template <bool VEC>
__device__ __forceinline__ void load8(const uint16_t* plane, long long p,
                                      long long n, uint32_t* v) {
    if (VEC) {
        uint4 q = make_uint4(0, 0, 0, 0);
        if (plane && p >= 0 && p < n)
            q = *reinterpret_cast<const uint4*>(plane + p);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const long long a = p + 2 * k;
            const uint32_t lo = (plane && a >= 0 && a < n) ? plane[a] : 0;
            const uint32_t hi =
                (plane && a + 1 >= 0 && a + 1 < n) ? plane[a + 1] : 0;
            v[k] = lo | (hi << 16);
        }
    }
}

// x (B, C, H, W) bfloat16; w [ceil(C / 16)][9][og][2][8][8] (k = 16 chunk
// + 8 half + last index, o = 8 group + the 8 o); grid (tiles, ceil(O / BN),
// B). A block computes output rows [y0, y0 + th) x columns [x0, x0 + tw)
// for BN output channels, over MB = 128 MI positions m = r sw + c (c < tw
// and r < th kept). Shared memory per stage: the input, two planes of 8
// channels x pl pixels (16 bytes each), staged rows y0 - 1 .. y0 + th, columns
// x0 - 1 .. x0 + tw; then the weights of the chunk's 9 taps, BN x 32 bytes
// each.
template <int BN, int MI, int MINB, bool VEC>
__global__ void __launch_bounds__(WG_NT, MINB)
conv3x3_wgmma_kernel(const uint16_t* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int C, int H, int W,
                     int O, int og, int nchunks, int tw, int th, int tiles_x,
                     int act) {
    constexpr int MB = 128 * MI;
    extern __shared__ __align__(128) uint8_t smem[];
    const int sw = tw + 2, pl = MB + 2 * sw + 2;
    const int abytes = 2 * pl * 16, stage = abytes + 9 * BN * 32;
    const int y0 = (blockIdx.x / tiles_x) * th;
    const int x0 = (blockIdx.x % tiles_x) * tw;
    const int j0 = blockIdx.y * (BN / 8), b = blockIdx.z;
    const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const long long HW = (long long)H * W;
    const uint16_t* xb = x + (long long)b * C * HW;

    // this thread's staging item: plane g (8 channels) x staged row rr x
    // 8 pixels from image column xs (rows fastest across lanes)
    const int nr = th + 2, nk = tw / 8 + 2;
    const bool has_item = tid < 2 * nr * nk;
    const int rr = tid % nr, kq = (tid / nr) % nk, g = tid / (nr * nk);
    const int gy = y0 - 1 + rr, xs = x0 - 8 + 8 * kq;
    const bool row_in = has_item && gy >= 0 && gy < H;
    uint32_t v[32];

    auto load = [&](int ch) {
        const int c0 = ch * 16 + g * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint16_t* plane = (row_in && c0 + i < C)
                ? xb + (long long)(c0 + i) * HW + (long long)gy * W : nullptr;
            load8<VEC>(plane, xs, W, v + 4 * i);
        }
    };
    auto store = [&](int s) {
        if (!has_item) return;
        uint8_t* a = smem + s * stage + g * pl * 16;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int cc = 8 * kq + j - 7;
            if (cc >= 0 && cc < sw) store_row(a + (rr * sw + cc) * 16, v, j);
        }
    };
    auto weights = [&](int ch, int s) {
        uint8_t* d = smem + s * stage + abytes;
        for (int e = tid; e < 9 * BN * 2; e += WG_NT) {
            const int q = e & 15, jj = (e >> 4) % (BN / 8);
            const int tap = (e >> 4) / (BN / 8);
            if (j0 + jj < og)
                cp_async16(d + (tap * (BN / 8) + jj) * 256 + q * 16,
                           w + ((long long)(ch * 9 + tap) * og + j0 + jj) * 128
                               + q * 8);
        }
    };

    float acc[MI][BN / 2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0.0f;

    // chunk 0 staged; chunk 1's input in registers, its weights in flight
    load(0);
    weights(0, 0);
    cp_async_commit();
    store(0);
    if (nchunks > 1) {
        load(1);
        weights(1, 1);
        cp_async_commit();
        cp_async_wait<1>();
    } else {
        cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    for (int ch = 0; ch < nchunks; ++ch) {
        const int s = ch % NS;
        const uint32_t a0 = smem_addr(smem + s * stage), b0 = a0 + abytes;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int shift = (tap / 3) * sw + tap % 3;
            const uint64_t db = gmma_desc(b0 + tap * BN * 32, 128, 256);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                const int m = (wg * MI + i) * 64 + shift;
                wgmma<BN>(acc[i], gmma_desc(a0 + m * 16, pl * 16, 128), db);
            }
        }
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        // while they run: chunk ch + 1's input from registers to its
        // stage, chunk ch + 2's loads and weights into the stage chunk
        // ch - 2 used (its products were waited for, and the block passed
        // a barrier since)
        if (ch + 1 < nchunks) store((ch + 1) % NS);
        if (ch + 2 < nchunks) {
            load(ch + 2);
            weights(ch + 2, (ch + 2) % NS);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        fence_proxy_async();
        // chunk ch - 1's products are done: its stage takes chunk ch + 3
        wgmma_wait<1>();
        __syncthreads();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
    __syncthreads();

    // epilogue: the tile [BN][th][tw] in shared memory (plane pitch np,
    // 8 mod 32: conflict-free writes), then 16-byte rows of 8 pixels
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(smem);
    const int np = (th * tw + 31) / 32 * 32 + 8;
    const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = (wg * MI + i) * 64 + warp * 16 + g4 + 8 * h;
            const int r = m / sw, c = m - r * sw;
            if (r >= th || c >= tw) continue;
#pragma unroll
            for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2) {
                    const int n = 8 * jn + 2 * t4 + e2, o = 8 * j0 + n;
                    const float bo = o < O ? bias[o] : 0.0f;
                    e[n * np + r * tw + c] = __float2bfloat16_rn(
                        epilogue(acc[i][4 * jn + 2 * h + e2], bo, act));
                }
        }
    __syncthreads();
    const int rows8 = tw / 8, per_n = th * rows8;
    for (int idx = tid; idx < BN * per_n; idx += WG_NT) {
        const int n = idx / per_n, rem = idx - n * per_n;
        const int r = rem / rows8, c = 8 * (rem - r * rows8);
        const int o = 8 * j0 + n, oy = y0 + r, ox = x0 + c;
        if (o >= O || oy >= H || ox >= W) continue;
        const __nv_bfloat16* src = e + n * np + r * tw + c;
        __nv_bfloat16* dst = y + ((long long)b * O + o) * HW
                             + (long long)oy * W + ox;
        if (VEC) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
        } else {
            for (int q = 0; q < 8 && ox + q < W; ++q) dst[q] = src[q];
        }
    }
}

// Sections x0..x2 (B, C_s, H, W) bfloat16; w [ceil(Ct / 16)][og][2][8][8]
// (k = 16 step + 8 half + last index); grid (ceil(HW / MB), ceil(O / BN),
// B). A block computes MB = 128 MI consecutive pixels for BN output
// channels; a stage holds 16 KS input channels, 2 KS planes of MB pixels
// (pitch MB + 1: conflict-free staging stores), and their weights.
template <int BN, int MI, int KS, int MINB, bool VEC>
__global__ void __launch_bounds__(WG_NT, MINB)
conv1x1_wgmma_kernel(const uint16_t* __restrict__ x0,
                     const uint16_t* __restrict__ x1,
                     const uint16_t* __restrict__ x2, int C0, int C1, int C2,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int HW, int O, int og,
                     int ksteps, int act) {
    constexpr int MB = 128 * MI, PL = MB + 1, NP = 2 * KS;
    constexpr int ABYTES = NP * PL * 16;
    constexpr int STAGE = ABYTES + KS * BN * 32;
    constexpr int NI = NP * MB / 8;                 // staging items
    constexpr int IPT = (NI + WG_NT - 1) / WG_NT;   // a thread
    extern __shared__ __align__(128) uint8_t smem[];
    const int p0 = blockIdx.x * MB, j0 = blockIdx.y * (BN / 8);
    const int b = blockIdx.z;
    const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int Ct = C0 + C1 + C2;
    const int nchunks = (ksteps + KS - 1) / KS;
    uint32_t v[IPT][32];

    // item e: plane g = e % NP (channels across lanes) x 8 pixels from
    // p0 + 8 (e / NP)
    auto load = [&](int ch) {
#pragma unroll
        for (int it = 0; it < IPT; ++it) {
            const int e = tid + it * WG_NT;
            const int c0 = ch * 16 * KS + 8 * (e % NP);
            const long long p = p0 + 8 * (e / NP);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const uint16_t* plane = (e < NI && c0 + i < Ct)
                    ? section_plane(x0, x1, x2, C0, C1, C2, b, c0 + i,
                                    (long long)HW)
                    : nullptr;
                load8<VEC>(plane, p, HW, v[it] + 4 * i);
            }
        }
    };
    auto store = [&](int s) {
#pragma unroll
        for (int it = 0; it < IPT; ++it) {
            const int e = tid + it * WG_NT;
            if (e >= NI) continue;
            uint8_t* a =
                smem + s * STAGE + ((e % NP) * PL + 8 * (e / NP)) * 16;
#pragma unroll
            for (int j = 0; j < 8; ++j) store_row(a + j * 16, v[it], j);
        }
    };
    auto weights = [&](int ch, int s) {
        uint8_t* d = smem + s * STAGE + ABYTES;
        const int nks = min(KS, ksteps - ch * KS);
        for (int e = tid; e < nks * BN * 2; e += WG_NT) {
            const int q = e & 15, jj = (e >> 4) % (BN / 8);
            const int ks = (e >> 4) / (BN / 8);
            if (j0 + jj < og)
                cp_async16(d + (ks * (BN / 8) + jj) * 256 + q * 16,
                           w + ((long long)(ch * KS + ks) * og + j0 + jj) * 128
                               + q * 8);
        }
    };

    float acc[MI][BN / 2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0.0f;

    // chunk 0 staged; chunk 1's input in registers, its weights in flight
    load(0);
    weights(0, 0);
    cp_async_commit();
    store(0);
    if (nchunks > 1) {
        load(1);
        weights(1, 1);
        cp_async_commit();
        cp_async_wait<1>();
    } else {
        cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    for (int ch = 0; ch < nchunks; ++ch) {
        const int s = ch % NS;
        const int nks = min(KS, ksteps - ch * KS);
        const uint32_t a0 = smem_addr(smem + s * STAGE), b0 = a0 + ABYTES;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            if (ks >= nks) break;
            const uint64_t db = gmma_desc(b0 + ks * BN * 32, 128, 256);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                const int m = 2 * ks * PL + (wg * MI + i) * 64;
                wgmma<BN>(acc[i], gmma_desc(a0 + m * 16, PL * 16, 128), db);
            }
        }
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
        // while they run: chunk ch + 1's input from registers to its
        // stage, chunk ch + 2's loads and weights into the stage chunk
        // ch - 2 used (its products were waited for, and the block passed
        // a barrier since)
        if (ch + 1 < nchunks) store((ch + 1) % NS);
        if (ch + 2 < nchunks) {
            load(ch + 2);
            weights(ch + 2, (ch + 2) % NS);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        fence_proxy_async();
        // chunk ch - 1's products are done: its stage takes chunk ch + 3
        wgmma_wait<1>();
        __syncthreads();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) reg_fence(acc[i][k]);
    __syncthreads();

    // epilogue: the tile [BN][MB] (pitch MB + 8), then 16-byte rows
    constexpr int MP = MB + 8;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(smem);
    const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = (wg * MI + i) * 64 + warp * 16 + g4 + 8 * h;
#pragma unroll
            for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2) {
                    const int n = 8 * jn + 2 * t4 + e2, o = 8 * j0 + n;
                    const float bo = o < O ? bias[o] : 0.0f;
                    e[n * MP + m] = __float2bfloat16_rn(
                        epilogue(acc[i][4 * jn + 2 * h + e2], bo, act));
                }
        }
    __syncthreads();
    for (int idx = tid; idx < BN * (MB / 8); idx += WG_NT) {
        const int n = idx / (MB / 8), m = 8 * (idx - n * (MB / 8));
        const int o = 8 * j0 + n;
        const long long p = p0 + m;
        if (o >= O || p >= HW) continue;
        const __nv_bfloat16* src = e + n * MP + m;
        __nv_bfloat16* dst = y + ((long long)b * O + o) * HW + p;
        if (VEC) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
        } else {
            for (int q = 0; q < 8 && p + q < HW; ++q) dst[q] = src[q];
        }
    }
}

// ---------------------------------------------------------------------------
// float32, FFMA
// ---------------------------------------------------------------------------

constexpr int OPT = 8;          // output channels per thread (a warp's share)
constexpr int PPT = 4;          // pixels per thread
constexpr int KCF3 = 8;         // 3x3: input channels per chunk
constexpr int KCF1 = 16;        // 1x1: input channels per chunk

// x (B, C, H, W); w (Opad / 32, Cp, 9, 32), Cp = C rounded up to 8.
template <int ACT>
__global__ void __launch_bounds__(NT)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int C, int H, int W, int O, int Cp, int tiles_x) {
    __shared__ float s_x[KCF3 * SH * SW];
    __shared__ __align__(16) float s_w[KCF3 * 9 * BM];

    const int ob = blockIdx.y, b = blockIdx.z;
    const int ty0 = (blockIdx.x / tiles_x) * TH;
    const int tx0 = (blockIdx.x % tiles_x) * TW;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int r = lane >> 4, cc = lane & 15;     // pixel j: row r + 2j
    const long long HW = (long long)H * W;
    const float* xb = x + (long long)b * C * HW;
    const float* wb = w + (long long)ob * Cp * 9 * BM;

    float acc[PPT][OPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
        for (int o = 0; o < OPT; ++o) acc[j][o] = 0.0f;

    for (int c0 = 0; c0 < Cp; c0 += KCF3) {
        __syncthreads();
        for (int e = tid; e < KCF3 * SH * SW; e += NT) {
            const int c = e / (SH * SW), rem = e - c * (SH * SW);
            const int rr = rem / SW, q = rem - rr * SW;
            const int gy = ty0 - 1 + rr, gx = tx0 - 1 + q;
            float v = 0.0f;
            if (c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
                v = xb[(long long)(c0 + c) * HW + (long long)gy * W + gx];
            s_x[e] = v;
        }
        const float4* src = reinterpret_cast<const float4*>(
            wb + (long long)c0 * 9 * BM);
        for (int e = tid; e < KCF3 * 9 * BM / 4; e += NT)
            reinterpret_cast<float4*>(s_w)[e] = src[e];
        __syncthreads();
        for (int c = 0; c < KCF3; ++c)
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                const int u = tap / 3, v = tap - 3 * u;
                const float4* wp = reinterpret_cast<const float4*>(
                    s_w + (c * 9 + tap) * BM + warp * OPT);
                const float4 w0 = wp[0], w1 = wp[1];
                const float wv[OPT] = {w0.x, w0.y, w0.z, w0.w,
                                       w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                for (int j = 0; j < PPT; ++j) {
                    const float xv = s_x[c * SH * SW + (r + 2 * j + u) * SW
                                         + cc + v];
#pragma unroll
                    for (int o = 0; o < OPT; ++o)
                        acc[j][o] = fmaf(xv, wv[o], acc[j][o]);
                }
            }
    }

    const int ox = tx0 + cc;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        const int oy = ty0 + r + 2 * j;
        if (oy >= H || ox >= W) continue;
#pragma unroll
        for (int o = 0; o < OPT; ++o) {
            const int oc = ob * BM + warp * OPT + o;
            if (oc < O)
                y[((long long)b * O + oc) * HW + (long long)oy * W + ox] =
                    epilogue(acc[j][o], bias[oc], ACT);
        }
    }
}

// Sections x0..x2 (B, C_s, H, W); w (Opad / 32, Cp, 32), Cp = C0 + C1 + C2
// rounded up to 16; grid (ceil(HW / 128), Opad / 32, B).
template <int ACT>
__global__ void __launch_bounds__(NT)
conv1x1_f32_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                   const float* __restrict__ x2, int C0, int C1, int C2,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ y, int HW, int O, int Cp) {
    __shared__ float s_x[KCF1 * TP];
    __shared__ __align__(16) float s_w[KCF1 * BM];

    const int ob = blockIdx.y, b = blockIdx.z;
    const int p0 = blockIdx.x * TP;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int Ct = C0 + C1 + C2;
    const float* wb = w + (long long)ob * Cp * BM;

    float acc[PPT][OPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
        for (int o = 0; o < OPT; ++o) acc[j][o] = 0.0f;

    for (int c0 = 0; c0 < Cp; c0 += KCF1) {
        __syncthreads();
        for (int e = tid; e < KCF1 * TP; e += NT) {
            const int c = c0 + e / TP, pix = p0 + (e % TP);
            float v = 0.0f;
            if (c < Ct && pix < HW)
                v = section_plane(x0, x1, x2, C0, C1, C2, b, c,
                                  (long long)HW)[pix];
            s_x[e] = v;
        }
        const float4* src = reinterpret_cast<const float4*>(
            wb + (long long)c0 * BM);
        for (int e = tid; e < KCF1 * BM / 4; e += NT)
            reinterpret_cast<float4*>(s_w)[e] = src[e];
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < KCF1; ++c) {
            const float4* wp = reinterpret_cast<const float4*>(
                s_w + c * BM + warp * OPT);
            const float4 w0 = wp[0], w1 = wp[1];
            const float wv[OPT] = {w0.x, w0.y, w0.z, w0.w,
                                   w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int j = 0; j < PPT; ++j) {
                const float xv = s_x[c * TP + lane + 32 * j];
#pragma unroll
                for (int o = 0; o < OPT; ++o)
                    acc[j][o] = fmaf(xv, wv[o], acc[j][o]);
            }
        }
    }

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        const int pix = p0 + lane + 32 * j;
        if (pix >= HW) continue;
#pragma unroll
        for (int o = 0; o < OPT; ++o) {
            const int oc = ob * BM + warp * OPT + o;
            if (oc < O)
                y[((long long)b * O + oc) * HW + pix] =
                    epilogue(acc[j][o], bias[oc], ACT);
        }
    }
}

}  // namespace

namespace {

constexpr int SMEM_MAX = 232448;        // a block's shared memory on sm_90

bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// The 3x3 tile for a block of mb positions: the row width tw (a multiple
// of 8, at most 96) and th rows with th (tw + 2) <= mb and at most 256
// staging items, wasting the fewest positions over the map (the wider on
// a tie).
void pick_tile(int H, int W, int mb, int& tw, int& th, int& tx, int& ty) {
    double best = -1.0;
    for (int t = std::min((W + 7) / 8 * 8, 96); t >= 8; t -= 8) {
        const int h = std::min(mb / (t + 2), 128 / (t / 8 + 2) - 2);
        if (h < 1) continue;
        const int cx = (W + t - 1) / t, cy = (H + h - 1) / h;
        const double eff = (double)H * W / ((double)cx * cy * mb);
        if (eff > best * 1.0001) {
            best = eff;
            tw = t;
            th = h;
            tx = cx;
            ty = cy;
        }
    }
}

// Lets ``kernel`` take up to SMEM_MAX bytes of dynamic shared memory (once
// per kernel: ``done``).
template <typename K>
int allow_smem(K kernel, int smem, bool& done) {
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (done) return 0;
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    done = err == 0;
    return err;
}

template <int BN, int MI, int MINB>
int conv3x3_bf16(const void* x, const void* w, const void* bias, void* y,
                 int B, int C, int H, int W, int O, int act,
                 cudaStream_t stream) {
    constexpr int MB = 128 * MI;
    int tw = 8, th = 1, tx = 1, ty = 1;
    pick_tile(H, W, MB, tw, th, tx, ty);
    const int pl = MB + 2 * (tw + 2) + 2;
    const int stage = 2 * pl * 16 + 9 * BN * 32;
    const int np = (th * tw + 31) / 32 * 32 + 8;
    const int smem = std::max(NS * stage, BN * np * 2);
    const bool vec = W % 8 == 0 && aligned16(x) && aligned16(y);
    static bool done[2];
    auto kernel = vec ? conv3x3_wgmma_kernel<BN, MI, MINB, true>
                      : conv3x3_wgmma_kernel<BN, MI, MINB, false>;
    const int err = allow_smem(kernel, smem, done[vec]);
    if (err) return err;
    dim3 grid(tx * ty, (O + BN - 1) / BN, B);
    kernel<<<grid, WG_NT, smem, stream>>>(
        (const uint16_t*)x, (const __nv_bfloat16*)w, (const float*)bias,
        (__nv_bfloat16*)y, C, H, W, O, (O + 7) / 8, (C + 15) / 16, tw, th,
        tx, act);
    return (int)cudaGetLastError();
}

template <int BN, int MI, int KS, int MINB>
int conv1x1_bf16(const void* x0, const void* x1, const void* x2, int C0,
                 int C1, int C2, const void* w, const void* bias, void* y,
                 int B, int HW, int O, int act, cudaStream_t stream) {
    constexpr int MB = 128 * MI;
    const int stage = 2 * KS * (MB + 1) * 16 + KS * BN * 32;
    const int smem = std::max(NS * stage, BN * (MB + 8) * 2);
    const bool vec = HW % 8 == 0 && aligned16(x0) && aligned16(y)
                     && (C1 == 0 || aligned16(x1))
                     && (C2 == 0 || aligned16(x2));
    static bool done[2];
    auto kernel = vec ? conv1x1_wgmma_kernel<BN, MI, KS, MINB, true>
                      : conv1x1_wgmma_kernel<BN, MI, KS, MINB, false>;
    const int err = allow_smem(kernel, smem, done[vec]);
    if (err) return err;
    dim3 grid((HW + MB - 1) / MB, (O + BN - 1) / BN, B);
    kernel<<<grid, WG_NT, smem, stream>>>(
        (const uint16_t*)x0, (const uint16_t*)x1, (const uint16_t*)x2, C0, C1,
        C2, (const __nv_bfloat16*)w, (const float*)bias, (__nv_bfloat16*)y,
        HW, O, (O + 7) / 8, (C0 + C1 + C2 + 15) / 16, act);
    return (int)cudaGetLastError();
}

}  // namespace

// K10. x (B, C, H, W) and y (B, O, H, W) in bfloat16 (bf16 = 1) or float32;
// w packed by the wrapper for that dtype; bias (O,) float32; act 1 = SiLU.
extern "C" int conv3x3_cmajor(const void* x, const void* w, const void* bias,
                              void* y, int B, int C, int H, int W, int O,
                              int bf16, int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    if (bf16) {
        if (O <= 24) return conv3x3_bf16<24, 2, 2>(x, w, bias, y, B, C, H, W,
                                                   O, act, stream);
        if (O <= 48) return conv3x3_bf16<48, 2, 2>(x, w, bias, y, B, C, H, W,
                                                   O, act, stream);
        if (O <= 64) return conv3x3_bf16<64, 4, 1>(x, w, bias, y, B, C, H, W,
                                                   O, act, stream);
        return conv3x3_bf16<128, 2, 1>(x, w, bias, y, B, C, H, W, O, act,
                                       stream);
    }
    const int tiles_x = (W + TW - 1) / TW;
    dim3 grid(tiles_x * ((H + TH - 1) / TH), (O + BM - 1) / BM, B);
    const int Cp = (C + KCF3 - 1) / KCF3 * KCF3;
    if (act)
        conv3x3_f32_kernel<1><<<grid, NT, 0, stream>>>(
            (const float*)x, (const float*)w, (const float*)bias, (float*)y,
            C, H, W, O, Cp, tiles_x);
    else
        conv3x3_f32_kernel<0><<<grid, NT, 0, stream>>>(
            (const float*)x, (const float*)w, (const float*)bias, (float*)y,
            C, H, W, O, Cp, tiles_x);
    return (int)cudaGetLastError();
}

// K11. Sections x0..x2 (B, C_s, H, W) (C_s = 0 for an absent one), y (B, O,
// H, W), in bfloat16 (bf16 = 1) or float32.
extern "C" int conv1x1_cmajor(const void* x0, const void* x1, const void* x2,
                              int C0, int C1, int C2, const void* w,
                              const void* bias, void* y, int B, int HW, int O,
                              int bf16, int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int Ct = C0 + C1 + C2;
    if (B <= 0 || Ct <= 0 || HW <= 0 || O <= 0) return 0;
    if (bf16) {
        if (O <= 24) return conv1x1_bf16<24, 2, 2, 2>(
            x0, x1, x2, C0, C1, C2, w, bias, y, B, HW, O, act, stream);
        if (O <= 48) return conv1x1_bf16<48, 2, 2, 2>(
            x0, x1, x2, C0, C1, C2, w, bias, y, B, HW, O, act, stream);
        if (O <= 64) return conv1x1_bf16<64, 2, 4, 1>(
            x0, x1, x2, C0, C1, C2, w, bias, y, B, HW, O, act, stream);
        if (O <= 128) return conv1x1_bf16<128, 2, 4, 1>(
            x0, x1, x2, C0, C1, C2, w, bias, y, B, HW, O, act, stream);
        return conv1x1_bf16<256, 1, 4, 1>(x0, x1, x2, C0, C1, C2, w, bias, y,
                                          B, HW, O, act, stream);
    }
    dim3 grid((HW + TP - 1) / TP, (O + BM - 1) / BM, B);
    const int Kp = (Ct + 15) / 16 * 16;
    const float *a0 = (const float*)x0, *a1 = (const float*)x1,
                *a2 = (const float*)x2;
    if (act)
        conv1x1_f32_kernel<1><<<grid, NT, 0, stream>>>(
            a0, a1, a2, C0, C1, C2, (const float*)w, (const float*)bias,
            (float*)y, HW, O, Kp);
    else
        conv1x1_f32_kernel<0><<<grid, NT, 0, stream>>>(
            a0, a1, a2, C0, C1, C2, (const float*)w, (const float*)bias,
            (float*)y, HW, O, Kp);
    return (int)cudaGetLastError();
}
