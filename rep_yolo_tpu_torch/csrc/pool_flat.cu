// K6 max_pool2_q8: 2x2 stride-2 max pool over int8, for Hopper.
//
// Replaces rep_yolo_tpu/ops/pallas/pool_flat.py:max_pool2_flat, which pools
// the flat (B, C, H*W) int8 map with lane slices for the row pairs and 0/1
// selection-matrix dots for the column pairs (Mosaic has no strided lane
// access). Here the map is channels-last int8 (B, H, W, C), C a multiple of
// 4, read as 16-channel vectors (uint4) or, when C is not a multiple of 16
// or a pointer is off 16 bytes, as 4-channel words (uint32). Each output is
// the bytewise signed max (__vmaxs4) of its window's four vectors; the scale
// is unchanged, as max commutes with a positive dequant scale, and the
// result is exact.
//
// Bound on this card: bytes (the map read once, a quarter of it written),
// at 3.35 TB/s. At the served shapes that is 0.6-2.5 us, the order of a
// launch's own floor, so the design keeps the one round of loads short:
// - no division on the address path: the grid is (column tiles, bands of RB
//   output rows, images) and a block is (tx, ty) threads, tx across a
//   pixel's channel vectors (a loop of stride tx where the pixel has more),
//   ty across output columns, so neighbouring lanes read neighbouring
//   vectors of one input row;
// - RB output vectors a thread (4 RB loads, all issued before the first
//   max);
// - pool_dims picks ty from the shape, so that each served call is one wave
//   of at least one block an SM.
// The served calls take about what their HBM traffic takes after an L2
// flush, and about their L2 traffic when the input is L2-resident.
//
// Two build switches exist for pool_ab.py's A/B only (no path sets them):
// -DPOOL_RB=4 (four output rows a thread) and -DPOOL_EVICT_FIRST (the loads
// as ld.global.cs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
    return __vmaxs4(a, b);
}

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                      __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

#ifndef POOL_RB
#define POOL_RB 2
#endif
constexpr int RB = POOL_RB;               // output rows a thread
constexpr int THREADS = 256;              // the most a block

template <typename V>
__device__ __forceinline__ V load(const V* p) {
#ifdef POOL_EVICT_FIRST
    return __ldcs(p);
#else
    return *p;
#endif
}

// x (B, H, W, cv) and y (B, H/2, W/2, cv) in vectors V. Block (ct, band, b)
// thread (tx, ty): output column qx = ct * blockDim.y + ty, output rows
// band * RB + k (k < RB), vectors p = tx, tx + blockDim.x, ... of cv.
template <typename V>
__global__ void __launch_bounds__(THREADS)
max_pool2_q8_kernel(const V* __restrict__ x, V* __restrict__ y, int H, int W,
                    int cv) {
    const int H2 = H >> 1, W2 = W >> 1;
    const int qx = blockIdx.x * blockDim.y + threadIdx.y;
    if (qx >= W2) return;
    const int qy = blockIdx.y * RB;
    const int nr = min(RB, H2 - qy);
    const size_t row = (size_t)W * cv;          // an input row, in vectors
    const size_t orow = (size_t)W2 * cv;        // an output row
    const V* src = x + ((size_t)blockIdx.z * H + 2 * qy) * row + (size_t)2 * qx * cv;
    V* dst = y + ((size_t)blockIdx.z * H2 + qy) * orow + (size_t)qx * cv;
    for (int p = threadIdx.x; p < cv; p += blockDim.x) {
        V a[RB][4];
#pragma unroll
        for (int k = 0; k < RB; ++k) {
            if (k < nr) {
                const V* r = src + 2 * k * row + p;
                a[k][0] = load(r);
                a[k][1] = load(r + cv);
                a[k][2] = load(r + row);
                a[k][3] = load(r + row + cv);
            }
        }
#pragma unroll
        for (int k = 0; k < RB; ++k)
            if (k < nr)
                dst[k * orow + p] = vmax(vmax(a[k][0], a[k][1]),
                                         vmax(a[k][2], a[k][3]));
    }
}

// The launch of a (B, H, W) map of cv vectors a pixel: tx = min(cv, 32)
// lanes across a pixel's vectors by ty output columns, ty the power of two
// up to THREADS / tx that wastes the fewest of the W/2 columns (the widest
// of those). The served calls: 400, 400 and 200 blocks.
void pool_dims(int B, int H, int W, int cv, dim3* grid, dim3* block) {
    const int tx = cv < 32 ? cv : 32, W2 = W / 2;
    int ty = 1, best = -1;
    for (int t = 1; tx * t <= THREADS; t *= 2) {
        const int waste = (W2 + t - 1) / t * t - W2;
        if (best < 0 || waste <= best) best = waste, ty = t;
    }
    *grid = dim3((W2 + ty - 1) / ty, (H / 2 + RB - 1) / RB, B);
    *block = dim3(tx, ty);
}

// The route (16-byte vectors when cw % 4 == 0 and the map's pointers are
// 16-byte aligned, else words) and the launch; false if the grid is too
// large.
bool route(int B, int H, int W, int cw, bool aligned16, bool* vec, dim3* grid,
           dim3* block) {
    *vec = cw % 4 == 0 && aligned16;
    pool_dims(B, H, W, *vec ? cw / 4 : cw, grid, block);
    return B <= 65535 && grid->y <= 65535;
}

}  // namespace

// x (B, H, W, C) int8 as words (cw = C / 4 a pixel, 4-byte aligned); y (B,
// H/2, W/2, C). Returns a cudaError_t.
extern "C" int max_pool2_q8(const void* x, void* y, int B, int H, int W,
                            int cw, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H < 2 || W < 2 || cw <= 0) return 0;
    bool vec;
    dim3 grid, block;
    if (((uintptr_t)x | (uintptr_t)y) % 4 != 0 ||
        !route(B, H, W, cw, ((uintptr_t)x | (uintptr_t)y) % 16 == 0, &vec,
               &grid, &block))
        return (int)cudaErrorInvalidValue;
    if (vec)
        max_pool2_q8_kernel<uint4><<<grid, block, 0, stream>>>(
            (const uint4*)x, (uint4*)y, H, W, cw / 4);
    else
        max_pool2_q8_kernel<uint32_t><<<grid, block, 0, stream>>>(
            (const uint32_t*)x, (uint32_t*)y, H, W, cw);
    return (int)cudaGetLastError();
}

// The launch max_pool2_q8 makes on such a map, its pointers 16-byte aligned
// or not: dims = grid x, y, z, block x, y, z, dynamic shared memory. Returns
// a cudaError_t.
extern "C" int max_pool2_q8_dims(int B, int H, int W, int cw, int aligned16,
                                 int* dims) {
    bool vec;
    dim3 grid, block;
    if (B <= 0 || H < 2 || W < 2 || cw <= 0 ||
        !route(B, H, W, cw, aligned16 != 0, &vec, &grid, &block))
        return (int)cudaErrorInvalidValue;
    const int out[7] = {(int)grid.x, (int)grid.y, (int)grid.z, (int)block.x,
                        (int)block.y, (int)block.z, 0};
    for (int i = 0; i < 7; ++i) dims[i] = out[i];
    return 0;
}
