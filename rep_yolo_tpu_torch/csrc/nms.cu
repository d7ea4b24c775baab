// Greedy-NMS keep mask for Hopper.
//
// Replaces rep_yolo_tpu/ops/pallas/nms_kernel.py:nms_keep_pallas (kernel
// _nms_kernel), which reaches the greedy result as the fixed point of
// keep <- valid & (keep @ M == 0) over a K x K suppression matrix. Here the
// same set comes from the greedy scan itself, over 64-row tiles:
//   1. nms_mask_kernel: M as bits, one 64-bit word per (row i, 64 columns):
//      bit j of row i is set iff j > i and !(IoU(i, j) <= thr). The
//      negated form makes NaN IoU (zero-area duplicates) suppress, as on
//      the TPU. Only the words the scan reads are computed and stored: of
//      row tile t (rows 64t..64t+63) the words t..W-1 (W = ceil(K / 64)),
//      packed tile after tile, each tile row-major (64 rows x (W - t)
//      words), so a tile is one contiguous run. A block of 256 threads
//      computes four words of one row tile (a thread one row of one word);
//      blocks left of the diagonal return at once. A thread's first pass
//      over its 64 columns decides every pair whose intersection is 0 (see
//      below) and marks the others; a second pass divides for the marked
//      columns alone, so a warp divides where its lanes' boxes overlap, not
//      wherever one of them does.
//   2. nms_scan_kernel: one block per image walks the row tiles in score
//      order. Each tile is one TMA bulk copy into shared memory, in a ring
//      of three stages with an mbarrier each, so the next two tiles are in
//      flight while this one resolves (the mask kernel's diagonal blocks
//      also store the rows' valid bits, a word a tile, copied in with tile
//      0). Warp 0 resolves a tile from its rows' diagonal words as the
//      fixed point of kept = alive & ~OR(diagonal words of the kept rows)
//      (__reduce_or_sync; as many rounds as the tile's longest chain of
//      suppressions) and lists the kept rows; then the threads OR the kept
//      rows' words right of the diagonal into the removed set in shared
//      memory (a thread a word and a quarter of the kept rows where the tile
//      is 33 words wide or less, else all of them). The serial depth is K / 64 tiles of a few rounds and two
//      barriers, not K dependent loads. Invalid or padded slots never keep
//      and never suppress.
// The IoU uses explicitly rounded operations (and the file is compiled with
// --fmad=false) in the order of the plain version,
//   inter / ((area_i + area_j) - inter),
// so boxes exactly at the threshold decide as they do there. Where inter is
// 0 (disjoint or touching boxes) the quotient is 0 / union: NaN (suppress)
// where the union is 0 or NaN, else +-0, which is <= thr iff 0 <= thr; that
// decision is taken without the division. Where thr >= 0 and both areas are
// > 0 (every box of the block and the row), the union of a zero intersection
// is > 0 and the pair never suppresses: pass 1 then computes the
// intersection alone.
//
// Bound on this card: a few KB in and out, K^2/2 IoUs of ~12 operations;
// microseconds at the served K = 1024. K <= 8192
// (evaluation's max_nms, rep_yolo_tpu/train/evaluate.py:67-81): the mask
// then holds 4.2 MB an image, a staged tile up to 64 KB and the ring 192 KB.
// The scan's floor is K / 64 resolutions of at least one round each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"   // smem_addr, fence_proxy_async

namespace {

typedef unsigned long long u64;

constexpr int BITS = 64;
constexpr int MAX_K = 8192;
constexpr int MASK_WORDS = 4;                  // words a mask block computes
constexpr int MASK_THREADS = BITS * MASK_WORDS;
constexpr int SCAN_THREADS = 128;
constexpr int STAGES = 3;                      // tiles in the scan's ring

// Words of row tile t's block in an image's packed mask: tiles 0..t-1 hold
// 64 (W - s) words each.
__host__ __device__ __forceinline__ long long tile_offset(int t, int W) {
    return (long long)BITS * ((long long)t * W - (long long)t * (t - 1) / 2);
}

// The valid bits of an image's rows, a word a tile, follow its tiles; padded
// to an even count so every copy is whole 16-byte units.
__host__ __device__ __forceinline__ int valid_words(int W) { return (W + 1) & ~1; }

__host__ __device__ __forceinline__ long long mask_words(int W) {
    return tile_offset(W, W) + valid_words(W);
}

// Shared memory of the scan: STAGES stages of 64 x W words, the valid bits,
// the removed set (W words) and a barrier a stage.
__host__ __device__ __forceinline__ int scan_smem(int W) {
    return (STAGES * BITS * W + valid_words(W) + W + STAGES) * 8;
}

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
    return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

// The intersection of row box (x1, y1, x2, y2) with column box q, and the
// union given both areas, rounded op by op as the plain version rounds them.
__device__ __forceinline__ float inter_of(float x1, float y1, float x2, float y2,
                                          const float* q) {
    const float iw = fmaxf(__fsub_rn(fminf(x2, q[2]), fmaxf(x1, q[0])), 0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(y2, q[3]), fmaxf(y1, q[1])), 0.0f);
    return __fmul_rn(iw, ih);
}

__device__ __forceinline__ float union_of(float ai, float aq, float inter) {
    return __fsub_rn(__fadd_rn(ai, aq), inter);
}

// grid (ceil(W / 4), W, B): block (g, t, b) computes words t + 4g .. + 3 of
// row tile t of image b.
__global__ void __launch_bounds__(MASK_THREADS)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                u64* __restrict__ mask, int K, int W, float thr) {
    __shared__ float cb[MASK_THREADS][4];
    __shared__ float ca[MASK_THREADS];
    __shared__ u64 sbits[BITS][MASK_WORDS];
    const int t = blockIdx.y, b = blockIdx.z;
    const int w0 = t + MASK_WORDS * blockIdx.x;
    if (w0 >= W) return;                       // left of the diagonal
    const int tid = threadIdx.x;
    const float* bb = boxes + (long long)b * K * 4;
    const int j0 = w0 * BITS;
    float v[4] = {0.0f, 0.0f, 1.0f, 1.0f};    // a unit box past K (masked below)
    if (j0 + tid < K) {
        const float* p = bb + (long long)(j0 + tid) * 4;
        v[0] = p[0];
        v[1] = p[1];
        v[2] = p[2];
        v[3] = p[3];
    }
    cb[tid][0] = v[0];
    cb[tid][1] = v[1];
    cb[tid][2] = v[2];
    cb[tid][3] = v[3];
    ca[tid] = area_of(v[0], v[1], v[2], v[3]);
    const bool areas_pos = __syncthreads_and(ca[tid] > 0.0f);
    const int r = tid % BITS, k = tid / BITS;  // row of the tile, word
    const int i = t * BITS + r, w = w0 + k;
    const float(*col)[4] = cb + k * BITS;      // the word's 64 staged boxes
    const float* cola = ca + k * BITS;
    u64 bits = 0ull;
    if (i < K && w < W) {
        const float* p = bb + (long long)i * 4;
        const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
        const float ai = area_of(x1, y1, x2, y2);
        // no columns past K; on the diagonal word, only those right of i
        const int ncol = K - w * BITS;
        u64 cols = ncol < BITS ? (1ull << ncol) - 1ull : ~0ull;
        if (w == t) cols &= ~0ull << r << 1;
        // pass 1, all 64 columns: a zero intersection decides without the
        // division; the others are marked for pass 2
        u64 nz = 0ull;
        if (areas_pos && ai > 0.0f && 0.0f <= thr) {
            // every union of a zero intersection is then ai + aq > 0, and
            // +-0 / uni <= thr: no zero intersection suppresses
#pragma unroll
            for (int jj = 0; jj < BITS; ++jj)
                if (inter_of(x1, y1, x2, y2, col[jj]) != 0.0f) nz |= 1ull << jj;
        } else {
#pragma unroll
            for (int jj = 0; jj < BITS; ++jj) {
                const float inter = inter_of(x1, y1, x2, y2, col[jj]);
                const float uni = union_of(ai, cola[jj], inter);
                if (inter == 0.0f)             // 0 / uni: NaN or +-0
                    bits |= (u64)!(uni != 0.0f && uni == uni && 0.0f <= thr) << jj;
                else
                    nz |= 1ull << jj;
            }
        }
        bits &= cols;
        // pass 2, the overlapping columns alone: the division
        for (nz &= cols; nz; nz &= nz - 1) {
            const int jj = __ffsll((long long)nz) - 1;
            const float inter = inter_of(x1, y1, x2, y2, col[jj]);
            const float uni = union_of(ai, cola[jj], inter);
            if (!(__fdiv_rn(inter, uni) <= thr)) bits |= 1ull << jj;
        }
    }
    sbits[r][k] = bits;
    u64* mb = mask + (long long)b * mask_words(W);
    if (blockIdx.x == 0 && tid < BITS) {       // the diagonal block: valid bits
        const uint32_t vb = __ballot_sync(0xffffffffu,
                                          i < K && valid[(long long)b * K + i]);
        if (tid % 32 == 0)
            reinterpret_cast<uint32_t*>(mb + tile_offset(W, W) + t)[tid / 32] = vb;
    }
    __syncthreads();
    // out row by row: four adjacent threads write a row's four words
    const int ro = tid / MASK_WORDS, ko = tid % MASK_WORDS;
    if (w0 + ko < W)
        mb[tile_offset(t, W) + (long long)ro * (W - t) + (w0 - t) + ko] = sbits[ro][ko];
}

// mbarrier and the TMA bulk copy (global -> shared, one contiguous run).
__device__ __forceinline__ void mbar_init(u64* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(u64* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    return done != 0;
}

// The barrier's one arrival for this phase, with the bytes its copies bring;
// the phase completes when they have landed.
__device__ __forceinline__ void mbar_expect_tx(u64* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// bytes a multiple of 16, both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          u64* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The greedy resolution of a tile, by warp 0: alive holds the rows still
// candidates (valid, not removed by earlier tiles); lane l holds the
// diagonal words of rows l and l + 32. The kept set is the unique fixed
// point of kept = alive & ~OR(diagonal words of kept rows) (each row's
// status follows from the rows before it): iterated from alive, it is final
// after as many rounds as the longest chain of suppressions, 64 at most.
__device__ __forceinline__ u64 resolve(u64 alive, u64 d0, u64 d1, int lane) {
    u64 kept = alive;
    for (;;) {
        const u64 v = (((kept >> lane) & 1ull) ? d0 : 0ull)
                      | (((kept >> (lane + 32)) & 1ull) ? d1 : 0ull);
        const u64 sup = (u64)__reduce_or_sync(0xffffffffu, (uint32_t)(v >> 32)) << 32
                        | __reduce_or_sync(0xffffffffu, (uint32_t)v);
        const u64 next = alive & ~sup;
        if (next == kept) return kept;
        kept = next;
    }
}

// One block per image.
__global__ void __launch_bounds__(SCAN_THREADS)
nms_scan_kernel(const u64* __restrict__ mask, uint8_t* __restrict__ keep, int K,
                int W) {
    extern __shared__ __align__(16) u64 smem[];
    u64* vbits = smem + STAGES * BITS * W;
    u64* removed = vbits + valid_words(W);
    u64* bar = removed + W;                    // a barrier a stage
    __shared__ u64 s_kept;
    __shared__ int s_nkept;
    __shared__ uint8_t s_rows[BITS];          // the tile's kept rows, in order
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
    const u64* mb = mask + (long long)b * mask_words(W);

    for (int w = tid; w < W; w += SCAN_THREADS) removed[w] = 0ull;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(bar + s);
        mbar_init_fence();
        // tiles 0..STAGES-1 in flight; the valid bits with tile 0
        for (int s = 0; s < STAGES && s < W; ++s) {
            const uint32_t bytes = BITS * (W - s) * 8;
            mbar_expect_tx(bar + s, bytes + (s == 0 ? valid_words(W) * 8 : 0));
            if (s == 0) bulk_copy(vbits, mb + tile_offset(W, W), valid_words(W) * 8, bar);
            bulk_copy(smem + s * BITS * W, mb + tile_offset(s, W), bytes, bar + s);
        }
    }
    __syncthreads();

    for (int t = 0; t < W; ++t) {
        const int s = t % STAGES;
        u64* tile = smem + s * BITS * W;
        const int pitch = W - t;
        while (!mbar_try_wait(bar + s, (t / STAGES) & 1)) {
        }
        if (tid < 32) {
            const u64 alive = vbits[t] & ~removed[t];
            const u64 kept = resolve(alive, tile[lane * pitch], tile[(lane + 32) * pitch],
                                     lane);
            // the kept rows, listed in order
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = lane + 32 * h;
                if ((kept >> r) & 1ull)
                    s_rows[__popcll(kept & ((1ull << r) - 1ull))] = (uint8_t)r;
            }
            if (lane == 0) {
                s_kept = kept;
                s_nkept = __popcll(kept);
            }
        }
        __syncthreads();
        const u64 kept = s_kept;
        const int nk = s_nkept;
        // the kept rows' words right of the diagonal into the removed set: a
        // thread a word and a share of the kept rows (a quarter where the
        // tile has at most 32 such words, merged by atomicOr; else all)
        if (pitch <= 33) {
            const int c = 1 + tid % 32, j1 = min(nk, 16 * (tid / 32 + 1));
            u64 acc = 0ull;
            if (c < pitch)
                for (int j = 16 * (tid / 32); j < j1; ++j)
                    acc |= tile[s_rows[j] * pitch + c];
            if (acc) atomicOr(&removed[t + c], acc);
        } else if (1 + tid < pitch) {
            const int c = 1 + tid;
            u64 acc = removed[t + c];
            int j = 0;
            for (; j + 4 <= nk; j += 4)
                acc |= tile[s_rows[j] * pitch + c] | tile[s_rows[j + 1] * pitch + c]
                       | tile[s_rows[j + 2] * pitch + c] | tile[s_rows[j + 3] * pitch + c];
            for (; j < nk; ++j) acc |= tile[s_rows[j] * pitch + c];
            removed[t + c] = acc;
        }
        if (tid < BITS && t * BITS + tid < K)
            keep[(long long)b * K + t * BITS + tid] = (uint8_t)((kept >> tid) & 1ull);
        __syncthreads();                       // tile t's stage free again
        if (tid == 0 && t + STAGES < W) {
            const uint32_t bytes = BITS * (W - t - STAGES) * 8;
            fence_proxy_async();
            mbar_expect_tx(bar + s, bytes);
            bulk_copy(tile, mb + tile_offset(t + STAGES, W), bytes, bar + s);
        }
    }
}

}  // namespace

extern "C" int nms_max_k() { return MAX_K; }

// 64-bit words of the packed mask of one image, and the scan's shared memory
// in bytes, at K candidates.
extern "C" long long nms_mask_words(int K) {
    return mask_words((K + BITS - 1) / BITS);
}

extern "C" int nms_scan_smem(int K) { return scan_smem((K + BITS - 1) / BITS); }

// The two kernels apart (for timing each); nms_keep launches both.
extern "C" int nms_mask(const float* boxes, const uint8_t* valid,
                        unsigned long long* mask, int B, int K, float thr,
                        cudaStream_t stream) {
    if (B <= 0 || K <= 0) return 0;
    if (K > MAX_K || B > 65535) return (int)cudaErrorInvalidValue;
    const int W = (K + BITS - 1) / BITS;
    dim3 grid((W + MASK_WORDS - 1) / MASK_WORDS, W, B);
    nms_mask_kernel<<<grid, MASK_THREADS, 0, stream>>>(boxes, valid, mask, K, W,
                                                       thr);
    return (int)cudaGetLastError();
}

extern "C" int nms_scan(const unsigned long long* mask, uint8_t* keep, int B, int K,
                        cudaStream_t stream) {
    if (B <= 0 || K <= 0) return 0;
    if (K > MAX_K || (uintptr_t)mask % 16) return (int)cudaErrorInvalidValue;
    static bool opted = false;                 // once, for the largest K
    if (!opted) {
        cudaError_t err = cudaFuncSetAttribute(
            nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            scan_smem(MAX_K / BITS));
        if (err != cudaSuccess) return (int)err;
        opted = true;
    }
    const int W = (K + BITS - 1) / BITS;
    nms_scan_kernel<<<B, SCAN_THREADS, scan_smem(W), stream>>>(mask, keep, K, W);
    return (int)cudaGetLastError();
}

// boxes (B, K, 4) f32; valid (B, K) u8; mask (B, nms_mask_words(K)) scratch;
// keep (B, K) u8. Returns a cudaError_t.
extern "C" int nms_keep(const float* boxes, const uint8_t* valid,
                        unsigned long long* mask, uint8_t* keep, int B, int K,
                        float thr, cudaStream_t stream) {
    const int err = nms_mask(boxes, valid, mask, B, K, thr, stream);
    if (err != 0) return err;
    return nms_scan(mask, keep, B, K, stream);
}
