// Kernels of the int8 neck region, for Hopper.
//
// K7 dwconv5x5_q8 replaces rep_yolo_tpu/ops/pallas/conv_flat.py:conv5x5_flat_q8
// where the neck calls it: GSConv's 5x5 depthwise conv, which the TPU ran as a
// block-diagonal dense 5x5 on its matrix unit (neck_flat.py:flat_conv with
// DW5_DENSE). The arithmetic is that dense kernel's: the folded weights are
// quantized per output channel (zeros off the diagonal change no maximum and
// add nothing to a sum), the int8 products sum exactly in s32, and the
// epilogue is K4's (q8_common.cuh). Only the diagonal is computed here.
// Bound: bytes (25 int8 multiply-adds per output byte); one thread per output
// pixel and 16 channels reads a halo'd 20 x 20 tile staged in shared memory.
// No __dp4a: a depthwise conv sums over taps, not over channels, so each
// channel keeps its own s32 sum of byte products.
//
// K8 spp_pools_q8 replaces rep_yolo_tpu/ops/pallas/neck_flat.py:spp_pools_flat:
// SPPCSPC's stride-1 max pyramid, emitting the concat [x, mp5, mp9, mp13]
// (pads are -inf). Max pools compose (5 o 5 = 9, 9 o 5 = 13), so three chained
// separable 5-windows give the three maps; the scale is unchanged and the
// result exact. One block holds a whole map (H * W pixels of one 16-channel
// vector, or one 4-channel word when C is not a multiple of 16) twice in
// shared memory and takes bytewise signed maxima (__vmaxs4). Bound: bytes
// (the map read once, four times its size written).
//
// Layout: channels-last int8 (B, H, W, C), C a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K7: depthwise 5x5, stride 1, pad 2
// ---------------------------------------------------------------------------

constexpr int DW_T = 16;           // output tile: 16 x 16 pixels, one a thread
constexpr int DW_R = DW_T + 4;     // staged rows and columns (2-pixel halo)
constexpr int DW_G = 4;            // channel words (16 channels) per block
constexpr int DW_THREADS = DW_T * DW_T;

__device__ __forceinline__ int32_t sbyte(int32_t v, int q) {
    return (int32_t)(int8_t)(v >> (8 * q));
}

// x (B, H, W, 4*CW) int8 as words; w (CW, 25) words, word (g, tap) holding
// channels 4g..4g+3 at that tap; s_w, bias (4*CW,); y (B, H, W, 4*CW).
template <bool F32_OUT>
__global__ void __launch_bounds__(DW_THREADS)
dwconv5x5_q8_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                    const float* __restrict__ s_w, const float* __restrict__ bias,
                    void* __restrict__ y, int H, int W, int CW, int tiles_x,
                    float s_in, float inv_out, int act) {
    __shared__ int32_t s_x[DW_G][DW_R * DW_R];
    __shared__ int32_t s_wt[DW_G][25];
    const int tile = blockIdx.x, g0 = blockIdx.y * DW_G, b = blockIdx.z;
    const int ty0 = (tile / tiles_x) * DW_T, tx0 = (tile % tiles_x) * DW_T;
    const int ng = min(DW_G, CW - g0);

    for (int i = threadIdx.x; i < DW_R * DW_R * DW_G; i += DW_THREADS) {
        const int g = i % DW_G, pix = i / DW_G;
        const int ry = pix / DW_R, rx = pix - ry * DW_R;
        const int iy = ty0 - 2 + ry, ix = tx0 - 2 + rx;
        int32_t v = 0;
        if (g < ng && iy >= 0 && iy < H && ix >= 0 && ix < W)
            v = x[(((long long)b * H + iy) * W + ix) * CW + g0 + g];
        s_x[g][pix] = v;
    }
    for (int i = threadIdx.x; i < DW_G * 25; i += DW_THREADS) {
        const int g = i / 25, t = i - 25 * g;
        s_wt[g][t] = g < ng ? w[(long long)(g0 + g) * 25 + t] : 0;
    }
    __syncthreads();

    const int ly = threadIdx.x / DW_T, lx = threadIdx.x - ly * DW_T;
    const int oy = ty0 + ly, ox = tx0 + lx;
    if (oy >= H || ox >= W) return;
    const long long pix = ((long long)b * H + oy) * W + ox;
    for (int g = 0; g < ng; ++g) {
        int32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ky = 0; ky < 5; ++ky)
#pragma unroll
            for (int kx = 0; kx < 5; ++kx) {
                const int32_t xv = s_x[g][(ly + ky) * DW_R + lx + kx];
                const int32_t wv = s_wt[g][ky * 5 + kx];
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[q] += sbyte(xv, q) * sbyte(wv, q);
            }
        const int c0 = 4 * (g0 + g);
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = epi(acc[q], s_w[c0 + q], s_in, bias[c0 + q], act);
        if (F32_OUT) {
            *(float4*)((float*)y + pix * 4 * CW + c0) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
            uint32_t word = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                word |= ((uint32_t)(quant1(v[q], inv_out) & 0xff)) << (8 * q);
            ((uint32_t*)y)[pix * CW + g0 + g] = word;
        }
    }
}

template <bool F32_OUT>
cudaError_t launch_dw(const int32_t* x, const int32_t* w, const float* s_w,
                      const float* bias, void* y, int B, int H, int W, int CW,
                      float s_in, float inv_out, int act, cudaStream_t stream) {
    const int tiles_x = (W + DW_T - 1) / DW_T;
    dim3 grid(tiles_x * ((H + DW_T - 1) / DW_T), (CW + DW_G - 1) / DW_G, B);
    dwconv5x5_q8_kernel<F32_OUT><<<grid, DW_THREADS, 0, stream>>>(
        x, w, s_w, bias, y, H, W, CW, tiles_x, s_in, inv_out, act);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8: the SPP max pyramid [x, mp5, mp9, mp13]
// ---------------------------------------------------------------------------

constexpr int SPP_THREADS = 256;

__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
    return __vmaxs4(a, b);
}

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                      __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

// One block: vector slot p (of cv per pixel) of image b. x (B, H*W, cv) and
// y (B, H*W, 4*cv) in vectors V; the map lives in shared memory as a (the
// current pyramid level) and t (its horizontal 5-window maxima).
template <typename V>
__global__ void __launch_bounds__(SPP_THREADS)
spp_pools_q8_kernel(const V* __restrict__ x, V* __restrict__ y, int H, int W,
                    int cv) {
    extern __shared__ int4 smem4[];
    const int HW = H * W;
    V* a = (V*)smem4;
    V* t = a + HW;
    const int p = blockIdx.x, b = blockIdx.y;
    const V* xb = x + (size_t)b * HW * cv + p;
    V* yb = y + (size_t)b * HW * 4 * cv + p;
    for (int i = threadIdx.x; i < HW; i += SPP_THREADS) {
        const V v = xb[(size_t)i * cv];
        a[i] = v;
        yb[(size_t)i * 4 * cv] = v;
    }
    __syncthreads();
    for (int sec = 1; sec <= 3; ++sec) {
        for (int i = threadIdx.x; i < HW; i += SPP_THREADS) {
            const int c = i % W;
            V m = a[i];
            for (int d = -2; d <= 2; ++d)
                if (d != 0 && c + d >= 0 && c + d < W) m = vmax(m, a[i + d]);
            t[i] = m;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < HW; i += SPP_THREADS) {
            const int r = i / W;
            V m = t[i];
            for (int d = -2; d <= 2; ++d)
                if (d != 0 && r + d >= 0 && r + d < H) m = vmax(m, t[i + d * W]);
            a[i] = m;
            yb[(size_t)i * 4 * cv + sec * cv] = m;
        }
        __syncthreads();
    }
}

template <typename V>
cudaError_t launch_spp(const void* x, void* y, int B, int H, int W, int cv,
                       cudaStream_t stream) {
    const size_t bytes = (size_t)2 * H * W * sizeof(V);
    cudaError_t err = set_smem(spp_pools_q8_kernel<V>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(cv, B);
    spp_pools_q8_kernel<V><<<grid, SPP_THREADS, bytes, stream>>>(
        (const V*)x, (V*)y, H, W, cv);
    return cudaGetLastError();
}

}  // namespace

// x (B, H, W, 4*cw) int8 as words; w (cw, 25) packed words; y (B, H, W, 4*cw)
// f32 (f32_out) or int8. Returns a cudaError_t.
extern "C" int dwconv5x5_q8(const int32_t* x, const int32_t* w, const float* s_w,
                            const float* bias, void* y, int B, int H, int W, int cw,
                            int f32_out, float s_in, float inv_out, int act,
                            void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || cw <= 0) return 0;
    return (int)(f32_out ? launch_dw<true>(x, w, s_w, bias, y, B, H, W, cw, s_in,
                                           inv_out, act, stream)
                         : launch_dw<false>(x, w, s_w, bias, y, B, H, W, cw, s_in,
                                            inv_out, act, stream));
}

// x (B, H, W, 4*cw) int8 as words; y (B, H, W, 16*cw). The map (2 * H * W
// vectors) must fit a block's shared memory. Returns a cudaError_t.
extern "C" int spp_pools_q8(const void* x, void* y, int B, int H, int W, int cw,
                            void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H <= 0 || W <= 0 || cw <= 0) return 0;
    if (cw % 4 == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0) {
        if ((size_t)2 * H * W * 16 > 232448) return (int)cudaErrorInvalidValue;
        return (int)launch_spp<uint4>(x, y, B, H, W, cw / 4, stream);
    }
    if ((size_t)2 * H * W * 4 > 232448) return (int)cudaErrorInvalidValue;
    return (int)launch_spp<uint32_t>(x, y, B, H, W, cw, stream);
}
