// Int8 convolutions of the int8 backbone region, for Hopper.
//
// K4 conv3x3_q8 replaces rep_yolo_tpu/ops/pallas/conv_flat.py:conv3x3_flat_q8
// (kernels _conv3_flat_q8_kernel / _pipe / _whole) and the stem's s2d form
// (nn/blocks.py:_stem_fast_q8): a 3x3 conv, stride 1 or 2, zero pad 1.
// K5 conv1x1_q8 replaces conv_flat.py:conv1x1_flat_q8 (_conv1_flat_q8_kernel,
// _conv1_pool_flat_q8_kernel): a 1x1 conv over 1-3 input sections (a concat
// that is never materialised), optionally followed by a 2x2/s2 max pool.
//
// Layout: channels-last int8 (B, H, W, C), C a multiple of 4, so a 4-channel
// pack is one 32-bit word that __dp4a multiplies against a weight pack. K4
// also takes float32 input (any C) and quantizes it while staging it, padding
// the channels to a multiple of 4 with zeros (exact: the weights there are 0).
// The weights arrive packed by the wrapper, per block of TO = 32 output
// channels and chunk of KC input channels, as [tap][KC/4][TO] words, so a
// block stages them with one contiguous copy.
//
// Both kernels: a block of 4 warps computes 128 output pixels x 32 output
// channels; a thread holds 4 pixels x 8 channels of s32 sums. Per chunk of KC
// input channels the block stages the (halo'd) input tile and the weights in
// shared memory; each step of the inner loop is 4 input words (one per pixel,
// consecutive lanes on consecutive words) and 8 weight words (two broadcast
// 16-byte loads) for 32 dp4a. The input tile is stored pixel-major with an
// odd word pitch, so both the staging writes and the lane reads are free of
// bank conflicts.
//
// Epilogue (q8_common.cuh), in the JAX package's operation order and
// rounding: y = acc * (s_w * s_in) + bias, SiLU, then int8 at
// clip(rint(y * (1/out_scale))) or float32. With the pool, the max of the
// window's four f32 values is requantized: requant is monotone, so this equals
// conv, requant, then pool.
//
// K4 at stride 2 also runs on int8 input: the PAN downsamples of the neck
// (neck_flat.py:conv3x3s2_flat_q8, which the TPU reached by space-to-depth
// and a stride-1 kernel on a {-1, 0} tap lattice). Output pixel (i, j) reads
// input rows 2i-1..2i+1 and columns 2j-1..2j+1: pad 1 on top and left, which
// for even H, W is the lattice's SAME conv.
//
// Bound on this card: at the served shapes the int8 work is 2 * MACs ops over
// the 1,979 TOP/s of the int8 tensor cores, and the bytes are the int8
// activations; this simple version runs on the dp4a integer pipe, far below
// the tensor cores (IMMA / wgmma with TMA staging is later work).

#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_common.cuh"

namespace {

constexpr int TO = 32;         // output channels per block
constexpr int OPT = 8;         // output channels per thread (one warp's share)
constexpr int PPT = 4;         // pixels per thread
constexpr int NTHREADS = 128;  // 4 warps
constexpr int TILE_H = 8;      // K4 output tile: 8 rows x 16 columns
constexpr int TILE_W = 16;

__device__ __forceinline__ int odd_pitch(int kp) { return kp | 1; }

// Writes the thread's 8 channels of one output pixel.
template <bool F32_OUT>
__device__ __forceinline__ void store8(void* y, long long pix, int O, int og0,
                                       const float* v, float inv_out) {
    if (F32_OUT) {
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
// K4: 3x3 conv, stride S, pad 1
// ---------------------------------------------------------------------------

template <int S, bool F32_IN, bool F32_OUT>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_q8_kernel(const void* __restrict__ x, const int32_t* __restrict__ wpk,
                  const float* __restrict__ s_w, const float* __restrict__ bias,
                  void* __restrict__ y, int H, int W, int C, int C4, int KC,
                  int Ho, int Wo, int O, int tiles_x, float s_in, float inv_s_in,
                  float inv_out, int act) {
    constexpr int RH = (TILE_H - 1) * S + 3;
    constexpr int RW = (TILE_W - 1) * S + 3;
    constexpr int RA = RH * RW;
    extern __shared__ int4 smem4[];
    int32_t* smem = (int32_t*)smem4;
    const int kp = KC / 4;
    const int pitch = odd_pitch(kp);
    int32_t* s_x = smem;                                   // [RA][pitch]
    int32_t* s_wt = smem + ((RA * pitch + 3) & ~3);        // [9][kp][TO]

    const int tile = blockIdx.x, ob = blockIdx.y, b = blockIdx.z;
    const int ty0 = (tile / tiles_x) * TILE_H, tx0 = (tile % tiles_x) * TILE_W;
    const int iy0 = ty0 * S - 1, ix0 = tx0 * S - 1;
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
                if (F32_IN) {
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
        const int nw = 9 * kp * TO / 4;
        const int4* src = (const int4*)(wpk + (long long)(ob * nchunks + ch) * 9 * kp * TO);
        for (int i = threadIdx.x; i < nw; i += NTHREADS) ((int4*)s_wt)[i] = src[i];
        __syncthreads();

#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
            const int ky = tap / 3, kx = tap - 3 * ky;
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
        store8<F32_OUT>(y, ((long long)b * Ho + oy) * Wo + ox, O, og0, v, inv_out);
    }
}

// ---------------------------------------------------------------------------
// K5: 1x1 conv over up to 3 sections, optional 2x2/s2 max pool
// ---------------------------------------------------------------------------

struct Sections {
    const int32_t* x[3];   // (B, H, W, C_s) int8, as words
    int c[3];              // channels of each section (multiples of KC)
    int off[3];            // first global channel of each section
    int n;
};

template <bool POOL, bool F32_OUT>
__global__ void __launch_bounds__(NTHREADS)
conv1x1_q8_kernel(Sections secs, const int32_t* __restrict__ wpk,
                  const float* __restrict__ s_w, const float* __restrict__ bias,
                  void* __restrict__ y, long long npix_out, int H, int W,
                  int Ctot, int KC, int O, float s_in, float inv_out, int act) {
    extern __shared__ int4 smem4[];
    int32_t* smem = (int32_t*)smem4;
    const int kp = KC / 4;
    const int pitch = odd_pitch(kp);
    constexpr int SLOTS = 32 * PPT;
    int32_t* s_x = smem;                                   // [SLOTS][pitch]
    int32_t* s_wt = smem + ((SLOTS * pitch + 3) & ~3);     // [kp][TO]

    const long long tile = blockIdx.x;
    const int ob = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nchunks = Ctot / KC;
    const int H2 = H / 2, W2 = W / 2;

    int32_t acc[PPT][OPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
        for (int o = 0; o < OPT; ++o) acc[j][o] = 0;

    for (int ch = 0; ch < nchunks; ++ch) {
        const int g0 = ch * KC;
        int s = 0;
        while (s + 1 < secs.n && g0 >= secs.off[s + 1]) ++s;
        const int32_t* xs = secs.x[s];
        const int cw = secs.c[s] / 4;                  // words per pixel
        const int w0 = (g0 - secs.off[s]) / 4;         // first word of the chunk
        __syncthreads();
        for (int idx = threadIdx.x; idx < SLOTS * kp; idx += NTHREADS) {
            const int slot = idx / kp, p = idx - slot * kp;
            const int j = slot >> 5, l = slot & 31;    // pixel j of lane l
            long long pix;
            bool ok;
            if (POOL) {
                const long long q = tile * 32 + l;
                ok = q < npix_out;
                const long long qb = q / ((long long)H2 * W2);
                const int rem = (int)(q - qb * H2 * W2);
                const int qy = rem / W2, qx = rem - qy * W2;
                pix = (qb * H + 2 * qy + (j >> 1)) * W + 2 * qx + (j & 1);
            } else {
                pix = tile * SLOTS + slot;
                ok = pix < npix_out;
            }
            s_x[slot * pitch + p] = ok ? xs[pix * cw + w0 + p] : 0;
        }
        const int nw = kp * TO / 4;
        const int4* src = (const int4*)(wpk + (long long)(ob * nchunks + ch) * kp * TO);
        for (int i = threadIdx.x; i < nw; i += NTHREADS) ((int4*)s_wt)[i] = src[i];
        __syncthreads();

        const int32_t* wa = s_wt + warp * OPT;
        for (int p = 0; p < kp; ++p) {
            int32_t a[PPT];
#pragma unroll
            for (int j = 0; j < PPT; ++j) a[j] = s_x[(j * 32 + lane) * pitch + p];
            const int4 wv0 = ((const int4*)(wa + p * TO))[0];
            const int4 wv1 = ((const int4*)(wa + p * TO))[1];
            const int32_t wr[OPT] = {wv0.x, wv0.y, wv0.z, wv0.w, wv1.x, wv1.y, wv1.z, wv1.w};
#pragma unroll
            for (int j = 0; j < PPT; ++j)
#pragma unroll
                for (int o = 0; o < OPT; ++o) acc[j][o] = __dp4a(a[j], wr[o], acc[j][o]);
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
    if (POOL) {
        const long long q = tile * 32 + lane;
        if (q >= npix_out) return;
        float v[OPT];
#pragma unroll
        for (int o = 0; o < OPT; ++o) {
            float m = epi(acc[0][o], sw[o], s_in, bb[o], act);
#pragma unroll
            for (int j = 1; j < PPT; ++j) m = fmaxf(m, epi(acc[j][o], sw[o], s_in, bb[o], act));
            v[o] = m;
        }
        store8<F32_OUT>(y, q, O, og0, v, inv_out);
    } else {
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
            const long long pix = tile * SLOTS + j * 32 + lane;
            if (pix >= npix_out) continue;
            float v[OPT];
#pragma unroll
            for (int o = 0; o < OPT; ++o) v[o] = epi(acc[j][o], sw[o], s_in, bb[o], act);
            store8<F32_OUT>(y, pix, O, og0, v, inv_out);
        }
    }
}

template <int S, bool F32_IN, bool F32_OUT>
cudaError_t launch3(const void* x, const int32_t* wpk, const float* s_w,
                    const float* bias, void* y, int B, int H, int W, int C, int C4,
                    int KC, int Ho, int Wo, int O, float s_in, float inv_s_in,
                    float inv_out, int act, cudaStream_t stream) {
    constexpr int RA = ((TILE_H - 1) * S + 3) * ((TILE_W - 1) * S + 3);
    const int kp = KC / 4;
    const size_t bytes = (size_t)(((RA * (kp | 1) + 3) & ~3) + 9 * kp * TO) * 4;
    cudaError_t err = set_smem(conv3x3_q8_kernel<S, F32_IN, F32_OUT>, bytes);
    if (err != cudaSuccess) return err;
    const int tiles_x = (Wo + TILE_W - 1) / TILE_W;
    const int tiles = tiles_x * ((Ho + TILE_H - 1) / TILE_H);
    dim3 grid(tiles, (O + TO - 1) / TO, B);
    conv3x3_q8_kernel<S, F32_IN, F32_OUT><<<grid, NTHREADS, bytes, stream>>>(
        x, wpk, s_w, bias, y, H, W, C, C4, KC, Ho, Wo, O, tiles_x, s_in, inv_s_in,
        inv_out, act);
    return cudaGetLastError();
}

template <bool POOL, bool F32_OUT>
cudaError_t launch1(const Sections& secs, const int32_t* wpk, const float* s_w,
                    const float* bias, void* y, int B, int H, int W, int Ctot,
                    int KC, int O, float s_in, float inv_out, int act,
                    cudaStream_t stream) {
    const int kp = KC / 4;
    const size_t bytes = (size_t)(((32 * PPT * (kp | 1) + 3) & ~3) + kp * TO) * 4;
    cudaError_t err = set_smem(conv1x1_q8_kernel<POOL, F32_OUT>, bytes);
    if (err != cudaSuccess) return err;
    const long long npix_out = POOL ? (long long)B * (H / 2) * (W / 2)
                                    : (long long)B * H * W;
    const long long per = POOL ? 32 : 32 * PPT;
    dim3 grid((unsigned)((npix_out + per - 1) / per), (O + TO - 1) / TO, 1);
    conv1x1_q8_kernel<POOL, F32_OUT><<<grid, NTHREADS, bytes, stream>>>(
        secs, wpk, s_w, bias, y, npix_out, H, W, Ctot, KC, O, s_in, inv_out, act);
    return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) f32 (f32_in) or (B, H, W, C4) int8; wpk packed words; y
// (B, Ho, Wo, O) f32 (f32_out) or int8. Returns a cudaError_t.
extern "C" int conv3x3_q8(const void* x, const int32_t* wpk, const float* s_w,
                          const float* bias, void* y, int B, int H, int W, int C,
                          int C4, int KC, int stride, int O, int f32_in, int f32_out,
                          float s_in, float inv_s_in, float inv_out, int act,
                          void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    if (KC <= 0 || KC % 4 || KC > 64 || C4 % KC || (stride != 1 && stride != 2))
        return (int)cudaErrorInvalidValue;
    const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
#define L3(S, FI, FO) launch3<S, FI, FO>(x, wpk, s_w, bias, y, B, H, W, C, C4, KC, \
                                         Ho, Wo, O, s_in, inv_s_in, inv_out, act, stream)
    if (stride == 1) {
        if (f32_in) return (int)(f32_out ? L3(1, true, true) : L3(1, true, false));
        return (int)(f32_out ? L3(1, false, true) : L3(1, false, false));
    }
    if (f32_in) return (int)(f32_out ? L3(2, true, true) : L3(2, true, false));
    return (int)(f32_out ? L3(2, false, true) : L3(2, false, false));
#undef L3
}

// xs: n_in (<= 3) int8 (B, H, W, C_s) sections; wpk packed words; y (B, H, W, O)
// or, with pool, (B, H/2, W/2, O), f32 or int8. Returns a cudaError_t.
extern "C" int conv1x1_q8(const int32_t* x0, const int32_t* x1, const int32_t* x2,
                          int c0, int c1, int c2, int n_in, const int32_t* wpk,
                          const float* s_w, const float* bias, void* y, int B, int H,
                          int W, int KC, int O, int pool, int f32_out, float s_in,
                          float inv_out, int act, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    if (n_in < 1 || n_in > 3 || KC <= 0 || KC % 4 || KC > 64 ||
        (pool && (H % 2 || W % 2)))
        return (int)cudaErrorInvalidValue;
    Sections secs;
    const int32_t* xp[3] = {x0, x1, x2};
    const int cs[3] = {c0, c1, c2};
    int off = 0;
    for (int s = 0; s < 3; ++s) {
        secs.x[s] = s < n_in ? xp[s] : nullptr;
        secs.c[s] = s < n_in ? cs[s] : 0;
        secs.off[s] = off;
        if (s < n_in) {
            if (cs[s] <= 0 || cs[s] % KC) return (int)cudaErrorInvalidValue;
            off += cs[s];
        }
    }
    secs.n = n_in;
#define L1(P, FO) launch1<P, FO>(secs, wpk, s_w, bias, y, B, H, W, off, KC, O, s_in, \
                                 inv_out, act, stream)
    if (pool) return (int)(f32_out ? L1(true, true) : L1(true, false));
    return (int)(f32_out ? L1(false, true) : L1(false, false));
#undef L1
}
