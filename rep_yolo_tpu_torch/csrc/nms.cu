// Greedy-NMS keep mask for Hopper.
//
// Replaces rep_yolo_tpu/ops/pallas/nms_kernel.py:nms_keep_pallas (kernel
// _nms_kernel), which reaches the greedy result as the fixed point of
// keep <- valid & (keep @ M == 0) over a K x K suppression matrix. Here the
// same set comes from the greedy scan itself:
//   1. nms_mask_kernel: M as bits, one 64-bit word per (row i, 64 columns):
//      bit j of row i is set iff j > i and !(IoU(i, j) <= thr). The
//      negated form makes NaN IoU (zero-area duplicates) suppress, as on
//      the TPU. Grid (words, words, B), one thread per row.
//   2. nms_scan_kernel: one warp per image walks the rows in score order;
//      a row that is valid and not yet removed is kept and ORs its mask row
//      into the removed set (the words are spread over the 32 lanes, the
//      owner lane broadcasts the word of row i). Invalid or padded slots
//      never keep and never suppress.
// The IoU uses explicitly rounded operations (and the file is compiled with
// --fmad=false) in the order of the plain version,
//   inter / ((area_i + area_j) - inter),
// so boxes exactly at the threshold decide as they do there.
//
// Bound on this card: a few KB in and out, K^2/2 IoUs of ~15 flops; at the
// served K = 1024 that is microseconds, so launch latency and the serial
// scan over K rows bound this simple version. K <= 8192 (4 words per lane):
// evaluation takes max_nms = 8192 candidates per image (rep_yolo_tpu/train/
// evaluate.py:67-81), whose mask is 8 MB per image.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BITS = 64;
constexpr int WORDS_PER_LANE = 4;
constexpr int MAX_K = 32 * WORDS_PER_LANE * BITS;   // 8192

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
    return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                unsigned long long* __restrict__ mask,
                                int K, int words, float thr) {
    __shared__ float cb[BITS][4];
    __shared__ float ca[BITS];
    const int b = blockIdx.z, rb = blockIdx.y, cblk = blockIdx.x;
    const int j0 = cblk * BITS;
    const int ncol = min(BITS, K - j0);
    const float* bb = boxes + (long long)b * K * 4;
    if ((int)threadIdx.x < ncol) {
        const float* p = bb + (long long)(j0 + threadIdx.x) * 4;
        cb[threadIdx.x][0] = p[0];
        cb[threadIdx.x][1] = p[1];
        cb[threadIdx.x][2] = p[2];
        cb[threadIdx.x][3] = p[3];
        ca[threadIdx.x] = area_of(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    const int i = rb * BITS + threadIdx.x;
    if (i >= K) return;
    unsigned long long bits = 0ull;
    if (cblk >= rb) {
        const float* p = bb + (long long)i * 4;
        const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
        const float ai = area_of(x1, y1, x2, y2);
        for (int jj = 0; jj < ncol; ++jj) {
            if (j0 + jj <= i) continue;
            const float iw = fmaxf(__fsub_rn(fminf(x2, cb[jj][2]), fmaxf(x1, cb[jj][0])), 0.0f);
            const float ih = fmaxf(__fsub_rn(fminf(y2, cb[jj][3]), fmaxf(y1, cb[jj][1])), 0.0f);
            const float inter = __fmul_rn(iw, ih);
            const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(ai, ca[jj]), inter));
            if (!(iou <= thr)) bits |= 1ull << jj;
        }
    }
    mask[((long long)b * K + i) * words + cblk] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int K, int words) {
    __shared__ uint8_t vs[MAX_K];
    const int b = blockIdx.x, lane = threadIdx.x;
    for (int i = lane; i < K; i += 32) vs[i] = valid[(long long)b * K + i];
    __syncwarp();
    const unsigned long long* mb = mask + (long long)b * K * words;
    // lane l holds the removed-set words l, l + 32, l + 64 and l + 96
    unsigned long long removed[WORDS_PER_LANE];
#pragma unroll
    for (int r = 0; r < WORDS_PER_LANE; ++r) removed[r] = 0ull;
    for (int i = 0; i < K; ++i) {
        const int wi = i / BITS;
        unsigned long long mine = removed[0];
#pragma unroll
        for (int r = 1; r < WORDS_PER_LANE; ++r)
            if (wi / 32 == r) mine = removed[r];
        const unsigned long long word = __shfl_sync(0xffffffffu, mine, wi % 32);
        const bool alive = vs[i] && !((word >> (i % BITS)) & 1ull);
        if (lane == 0) keep[(long long)b * K + i] = alive ? 1 : 0;
        if (alive) {
            const unsigned long long* row = mb + (long long)i * words;
#pragma unroll
            for (int r = 0; r < WORDS_PER_LANE; ++r)
                if (lane + 32 * r < words) removed[r] |= row[lane + 32 * r];
        }
    }
}

}  // namespace

extern "C" int nms_max_k() { return MAX_K; }

extern "C" int nms_keep(const float* boxes, const uint8_t* valid,
                        unsigned long long* mask, uint8_t* keep, int B, int K,
                        float thr, cudaStream_t stream) {
    if (B <= 0 || K <= 0) return 0;
    if (K > MAX_K) return (int)cudaErrorInvalidValue;
    const int words = (K + BITS - 1) / BITS;
    dim3 grid(words, words, B);
    nms_mask_kernel<<<grid, BITS, 0, stream>>>(boxes, mask, K, words, thr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nms_scan_kernel<<<B, 32, 0, stream>>>(mask, valid, keep, K, words);
    return (int)cudaGetLastError();
}
