// K6 max_pool2_q8: 2x2 stride-2 max pool over int8, for Hopper.
//
// Replaces rep_yolo_tpu/ops/pallas/pool_flat.py:max_pool2_flat, which pools
// the flat (B, C, H*W) int8 map with lane slices for the row pairs and 0/1
// selection-matrix dots for the column pairs (Mosaic has no strided lane
// access). Here the map is channels-last int8 (B, H, W, C), C a multiple of
// 4: one thread per output pixel and 16-channel vector (4-channel word when
// C is not a multiple of 16) reads the four vectors of its window and takes
// the bytewise signed max (__vmaxs4). The scale is unchanged, as max
// commutes with a positive dequant scale; the result is exact.
//
// Bound on this card: bytes (the map read once, a quarter of it written),
// at 3.35 TB/s; neighbouring threads read neighbouring 16-byte vectors, and
// the index arithmetic is 32-bit.

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

// cv vectors V per pixel; n_out = B * (H/2) * (W/2) * cv.
template <typename V>
__global__ void max_pool2_q8_kernel(const V* __restrict__ x, V* __restrict__ y,
                                    int H, int W, int cv, int n_out) {
    const int H2 = H / 2, W2 = W / 2;
    const size_t row = (size_t)W * cv;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
         i += gridDim.x * blockDim.x) {
        const int p = i % cv;
        int q = i / cv;
        const int qx = q % W2;
        q /= W2;
        const int qy = q % H2;
        const int b = q / H2;
        const V* r0 = x + ((size_t)(b * H + 2 * qy) * W + 2 * qx) * cv + p;
        y[i] = vmax(vmax(r0[0], r0[cv]), vmax(r0[row], r0[row + cv]));
    }
}

template <typename V>
cudaError_t launch(const void* x, void* y, int B, int H, int W, int cv,
                   cudaStream_t stream) {
    const long long n = (long long)B * (H / 2) * (W / 2) * cv;
    if (n >= (1LL << 31)) return cudaErrorInvalidValue;
    const int threads = 256;
    const long long want = (n + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
    max_pool2_q8_kernel<V><<<blocks, threads, 0, stream>>>(
        (const V*)x, (V*)y, H, W, cv, (int)n);
    return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) int8 as words (cw = C / 4 per pixel); y (B, H/2, W/2, C).
// Returns a cudaError_t.
extern "C" int max_pool2_q8(const void* x, void* y, int B, int H, int W,
                            int cw, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || H < 2 || W < 2 || cw <= 0) return 0;
    if (cw % 4 == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0)
        return (int)launch<uint4>(x, y, B, H, W, cw / 4, stream);
    return (int)launch<uint32_t>(x, y, B, H, W, cw, stream);
}
