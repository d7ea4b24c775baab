// Channel-major float convolutions of the DER blocks' "bf16" deploy path,
// for Hopper.
//
// K10 conv3x3_cmajor replaces rep_yolo_tpu/ops/pallas/conv_kernel.py:
// conv3x3_cmajor (kernel _conv3_kernel): a 3x3 stride-1 conv with zero
// padding 1, then bias and SiLU (or no activation).
// K11 conv1x1_cmajor replaces conv_kernel.py:conv1x1_cmajor (_conv1_kernel):
// a 1x1 conv with the same epilogue, over 1-3 input sections (the DER
// block's concat [x1, x4_1, x4_3] is read section by section and never
// materialised).
//
// Layout: NCHW (B, C, H, W), as the port's float network holds its maps;
// the output (B, O, H, W) is in x's dtype, bfloat16 or float32. The sums are
// float32; the epilogue y = acc + bias, then y * sigmoid(y), is float32 and
// rounds once to the output dtype (the JAX _epilogue). The weights arrive
// packed once per model by the wrapper (ops/kernels/conv_kernel.py), with
// the output channels padded to a multiple of BM = 32 and the input
// channels to the chunk size with zeros (exact).
//
// Both are implicit GEMMs, M = output channels, N = output pixels, K = taps
// x input channels. A block of 4 warps computes 32 output channels x 128
// pixels (3x3: an 8 x 16 tile of the map, 1x1: 128 consecutive pixels of
// H*W), staging per chunk of input channels the input tile (for the 3x3
// with its one-pixel halo, zero outside the map) and the weights in shared
// memory.
//
// - bfloat16: tensor cores, mma.sync m16n8k16 with float32 accumulation.
//   Each warp holds 32 channels x 32 pixels (2 x 4 fragments). The input
//   tile is stored as 32-bit words of channel pairs (c, c+1) of one pixel,
//   so a B fragment register is one shared load, and the plane pitch and
//   weight row pitch are padded so that fragment loads are free of bank
//   conflicts. K is padded to a multiple of 16 (C = 24 runs as 32).
// - float32: FFMA; a thread holds 8 output channels x 4 pixels (weights
//   broadcast per warp, pixels on consecutive lanes), as K4 does with dp4a.
//
// Bound on this card: at the DER shapes (C, O <= 256 at 40-320 px) each
// conv does 2 * O * k*k*C FLOPs per pixel against (C + O) * 2 bytes per
// pixel in bfloat16, 110-460 FLOP/byte, near or below the 295 FLOP/byte at
// which the bf16 tensor cores stop being the limit, so most calls are bound
// by their bytes. This simple version reads its inputs with 2- and 4-byte
// loads, re-reads the 3x3 halo (1.4x) and stages without double buffering;
// TMA and wgmma are later work. The TPU kernel's 128-lane padded width, the
// flattened-row lane slabs and the row tiles were Mosaic's constraints and
// have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per block: 4 warps
constexpr int BM = 32;         // output channels per block
constexpr int TH = 8;          // 3x3 output tile: 8 rows x 16 columns
constexpr int TW = 16;
constexpr int SH = TH + 2;     // the halo'd input tile
constexpr int SW = TW + 2;
constexpr int TP = 128;        // 1x1: pixels per block

__device__ __forceinline__ float epilogue(float acc, float b, int act) {
    float y = acc + b;
    return act ? y / (1.0f + expf(-y)) : y;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
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
// bfloat16, tensor cores
// ---------------------------------------------------------------------------

constexpr int KC3 = 16;                  // 3x3: input channels per chunk
constexpr int PLANE3 = 200;              // words per channel pair (>= SH*SW,
                                         // 8 mod 32: conflict-free B loads)
constexpr int WK3 = 9 * KC3;             // weights per channel per chunk
constexpr int WP3 = WK3 + 8;             // row pitch (bf16): 76 words

// x (B, C, H, W); w (Opad, nchunks * 144) with k = chunk*144 + tap*16 + c,
// tap = u*3 + v; grid (tiles, Opad / 32, B).
template <int ACT>
__global__ void __launch_bounds__(NT)
conv3x3_bf16_kernel(const uint16_t* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                    int C, int H, int W, int O, int nchunks, int tiles_x) {
    __shared__ uint32_t s_x[KC3 / 2 * PLANE3];
    __shared__ __align__(16) __nv_bfloat16 s_w[BM * WP3];

    const int ob = blockIdx.y, b = blockIdx.z;
    const int ty0 = (blockIdx.x / tiles_x) * TH;
    const int tx0 = (blockIdx.x % tiles_x) * TW;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long HW = (long long)H * W;
    const uint16_t* xb = x + (long long)b * C * HW;
    const long long wrow = (long long)nchunks * WK3;
    const __nv_bfloat16* wb = w + (long long)ob * BM * wrow;
    const uint32_t* s_w32 = reinterpret_cast<const uint32_t*>(s_w);

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    for (int ch = 0; ch < nchunks; ++ch) {
        const int c0 = ch * KC3;
        __syncthreads();
        for (int e = tid; e < KC3 / 2 * SH * SW; e += NT) {
            const int p = e / (SH * SW), rem = e - p * (SH * SW);
            const int r = rem / SW, q = rem - r * SW;
            const int gy = ty0 - 1 + r, gx = tx0 - 1 + q, c = c0 + 2 * p;
            uint32_t lo = 0, hi = 0;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
                const uint16_t* src = xb + (long long)c * HW
                                      + (long long)gy * W + gx;
                if (c < C) lo = src[0];
                if (c + 1 < C) hi = src[HW];
            }
            s_x[p * PLANE3 + r * SW + q] = lo | (hi << 16);
        }
        for (int e = tid; e < BM * (WK3 / 8); e += NT) {
            const int o = e / (WK3 / 8), j = e - o * (WK3 / 8);
            const uint4* src = reinterpret_cast<const uint4*>(
                wb + (long long)o * wrow + (long long)ch * WK3) + j;
            reinterpret_cast<uint4*>(s_w + o * WP3)[j] = *src;
        }
        __syncthreads();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int u = tap / 3, v = tap - 3 * u;
            uint32_t a[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t* r0 = s_w32 + (i * 16 + g) * (WP3 / 2)
                                     + tap * (KC3 / 2) + t;
                const uint32_t* r8 = r0 + 8 * (WP3 / 2);
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
                mma_bf16(acc[0][j], a[0], bf);
                mma_bf16(acc[1][j], a[1], bf);
            }
        }
    }

    const bool pairs = (W & 1) == 0;
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
                const float bo = bias[o];
                const float v0 = epilogue(acc[i][j][2 * h], bo, ACT);
                const float v1 = epilogue(acc[i][j][2 * h + 1], bo, ACT);
                __nv_bfloat16* dst = y + ((long long)b * O + o) * HW
                                     + (long long)oy * W + ox;
                if (pairs) {
                    *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v0, v1);
                } else {
                    dst[0] = __float2bfloat16_rn(v0);
                    if (ox + 1 < W) dst[1] = __float2bfloat16_rn(v1);
                }
            }
        }
}

constexpr int KC1 = 32;                  // 1x1: input channels per stage
constexpr int PLANE1 = TP + 8;           // words per channel pair (8 mod 32)
constexpr int WP1 = KC1 + 8;             // row pitch (bf16): 20 words

// Sections x0..x2 (B, C_s, H, W) with even C_s and even H*W; w (Opad, Kp),
// Kp = C0 + C1 + C2 rounded up to 16; grid (ceil(HW / 128), Opad / 32, B).
template <int ACT>
__global__ void __launch_bounds__(NT)
conv1x1_bf16_kernel(const uint16_t* __restrict__ x0,
                    const uint16_t* __restrict__ x1,
                    const uint16_t* __restrict__ x2, int C0, int C1, int C2,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, int HW, int O, int Kp) {
    __shared__ uint32_t s_x[KC1 / 2 * PLANE1];
    __shared__ __align__(16) __nv_bfloat16 s_w[BM * WP1];

    const int ob = blockIdx.y, b = blockIdx.z;
    const int p0 = blockIdx.x * TP;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int Ct = C0 + C1 + C2;
    const __nv_bfloat16* wb = w + (long long)ob * BM * Kp;
    const uint32_t* s_w32 = reinterpret_cast<const uint32_t*>(s_w);

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    for (int k0 = 0; k0 < Kp; k0 += KC1) {
        const int nk = min(KC1, Kp - k0);        // 32, or 16 at the end
        __syncthreads();
        for (int e = tid; e < nk / 2 * (TP / 2); e += NT) {
            const int p = e / (TP / 2), q = e - p * (TP / 2);
            const int c = k0 + 2 * p, pix = p0 + 2 * q;
            uint32_t lo = 0, hi = 0;            // two pixels of c, of c + 1
            if (pix < HW && c < Ct) {
                const uint16_t* src = section_plane(x0, x1, x2, C0, C1, C2, b,
                                                    c, (long long)HW) + pix;
                lo = *reinterpret_cast<const uint32_t*>(src);
                hi = *reinterpret_cast<const uint32_t*>(src + HW);
            }
            s_x[p * PLANE1 + 2 * q] = __byte_perm(lo, hi, 0x5410);
            s_x[p * PLANE1 + 2 * q + 1] = __byte_perm(lo, hi, 0x7632);
        }
        for (int e = tid; e < BM * (nk / 8); e += NT) {
            const int o = e / (nk / 8), j = e - o * (nk / 8);
            const uint4* src = reinterpret_cast<const uint4*>(
                wb + (long long)o * Kp + k0) + j;
            reinterpret_cast<uint4*>(s_w + o * WP1)[j] = *src;
        }
        __syncthreads();
        for (int kk = 0; kk < nk; kk += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t* r0 = s_w32 + (i * 16 + g) * (WP1 / 2)
                                     + kk / 2 + t;
                const uint32_t* r8 = r0 + 8 * (WP1 / 2);
                a[i][0] = r0[0];
                a[i][1] = r8[0];
                a[i][2] = r0[4];
                a[i][3] = r8[4];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint32_t* sp = s_x + (kk / 2 + t) * PLANE1
                                     + warp * 32 + j * 8 + g;
                const uint32_t bf[2] = {sp[0], sp[4 * PLANE1]};
                mma_bf16(acc[0][j], a[0], bf);
                mma_bf16(acc[1][j], a[1], bf);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int pix = p0 + warp * 32 + j * 8 + t * 2;
            if (pix >= HW) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = ob * BM + i * 16 + g + h * 8;
                if (o >= O) continue;
                const float bo = bias[o];
                __nv_bfloat16* dst = y + ((long long)b * O + o) * HW + pix;
                *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(
                    epilogue(acc[i][j][2 * h], bo, ACT),
                    epilogue(acc[i][j][2 * h + 1], bo, ACT));
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

// K10. x (B, C, H, W) and y (B, O, H, W) in bfloat16 (bf16 = 1) or float32;
// w packed by the wrapper for that dtype; bias (O,) float32; act 1 = SiLU.
extern "C" int conv3x3_cmajor(const void* x, const void* w, const void* bias,
                              void* y, int B, int C, int H, int W, int O,
                              int bf16, int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    const int tiles_x = (W + TW - 1) / TW;
    dim3 grid(tiles_x * ((H + TH - 1) / TH), (O + BM - 1) / BM, B);
    if (bf16) {
        const int nchunks = (C + KC3 - 1) / KC3;
        if (act)
            conv3x3_bf16_kernel<1><<<grid, NT, 0, stream>>>(
                (const uint16_t*)x, (const __nv_bfloat16*)w,
                (const float*)bias, (__nv_bfloat16*)y, C, H, W, O, nchunks,
                tiles_x);
        else
            conv3x3_bf16_kernel<0><<<grid, NT, 0, stream>>>(
                (const uint16_t*)x, (const __nv_bfloat16*)w,
                (const float*)bias, (__nv_bfloat16*)y, C, H, W, O, nchunks,
                tiles_x);
    } else {
        const int Cp = (C + KCF3 - 1) / KCF3 * KCF3;
        if (act)
            conv3x3_f32_kernel<1><<<grid, NT, 0, stream>>>(
                (const float*)x, (const float*)w, (const float*)bias,
                (float*)y, C, H, W, O, Cp, tiles_x);
        else
            conv3x3_f32_kernel<0><<<grid, NT, 0, stream>>>(
                (const float*)x, (const float*)w, (const float*)bias,
                (float*)y, C, H, W, O, Cp, tiles_x);
    }
    return (int)cudaGetLastError();
}

// K11. Sections x0..x2 (B, C_s, H, W) (C_s = 0 for an absent one), y (B, O,
// H, W), in bfloat16 (bf16 = 1: every C_s and H*W even) or float32.
extern "C" int conv1x1_cmajor(const void* x0, const void* x1, const void* x2,
                              int C0, int C1, int C2, const void* w,
                              const void* bias, void* y, int B, int HW, int O,
                              int bf16, int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const int Ct = C0 + C1 + C2;
    if (B <= 0 || Ct <= 0 || HW <= 0 || O <= 0) return 0;
    dim3 grid((HW + TP - 1) / TP, (O + BM - 1) / BM, B);
    const int Kp = (Ct + 15) / 16 * 16;
    if (bf16) {
        const uint16_t *a0 = (const uint16_t*)x0, *a1 = (const uint16_t*)x1,
                       *a2 = (const uint16_t*)x2;
        if (act)
            conv1x1_bf16_kernel<1><<<grid, NT, 0, stream>>>(
                a0, a1, a2, C0, C1, C2, (const __nv_bfloat16*)w,
                (const float*)bias, (__nv_bfloat16*)y, HW, O, Kp);
        else
            conv1x1_bf16_kernel<0><<<grid, NT, 0, stream>>>(
                a0, a1, a2, C0, C1, C2, (const __nv_bfloat16*)w,
                (const float*)bias, (__nv_bfloat16*)y, HW, O, Kp);
    } else {
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
    }
    return (int)cudaGetLastError();
}
