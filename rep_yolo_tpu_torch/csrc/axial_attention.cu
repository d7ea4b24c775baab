// Fused axial (criss-cross / vertical) attention for Hopper, f32.
//
// Replaces rep_yolo_tpu/ops/pallas/axial_attention.py:criss_cross_fused_x
// and vertical_fused_x (kernel body _axis_kernel_x). For x (B,H,W,C) NHWC
// and the packed deploy constants of nn/blocks.py
//   wqk (2*c8, C)  dense [Wq ; Wk] of the grouped 1x1 query/key convs
//   pq  (3, 2*c8)  [[bq ; bk], [a_qk ; a_qk], [c_qk ; c_qk]]  (BN: y*a + c)
//   pv  (4, C)     [wv, bv, a_v, c_v]  (depthwise value conv + BN)
// it computes
//   q,k = relu6(silu(x . Wqk^T + pq[0]) * pq[1] + pq[2])
//   v   = relu6(silu(x * pv[0] + pv[1]) * pv[2] + pv[3])
//   criss-cross: one softmax jointly over the W row energies and the H
//                column energies of each pixel (the centre pixel counts in
//                both branches, as in the reference), aggregate v over both
//   vertical:    the column energies used raw (no softmax)
//   y = gamma * out + x
//
// Two kernels:
//   K1 axial_project_kernel: q, k (c8 each) and v (C) once per pixel. The
//      TPU kernel recomputed them per branch only because of its layouts.
//   K2 axial_attend_kernel: one block per 8 query pixels of one row, one
//      warp per query pixel for the energies and the softmax statistics;
//      on Hopper a block sees the whole row and column, so the joint
//      softmax is direct and needs no flash-style merge of two branches.
//
// Bound on this card: at the 640-px shapes both kernels move a few MB and
// do a few tens of MFLOP per call, so they sit near the memory/launch floor
// (bytes / 3.35 TB/s is microseconds). This first version is simple: f32
// CUDA-core FMAs, x/k/v read through L1/L2, no tensor cores. Energies and
// softmax are f32 as in the TPU kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PROJ_PIX = 8;     // pixels per projection block
constexpr int TW = 8;           // query pixels per attention block (= warps)
constexpr int THREADS = 256;

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

__device__ __forceinline__ float relu6(float z) {
    return fminf(fmaxf(z, 0.0f), 6.0f);
}

__global__ void axial_project_kernel(const float* __restrict__ x,
                                     const float* __restrict__ wqk,
                                     const float* __restrict__ pq,
                                     const float* __restrict__ pv,
                                     float* __restrict__ q,
                                     float* __restrict__ k,
                                     float* __restrict__ v,
                                     long long npix, int C, int c8) {
    extern __shared__ float xs[];                  // PROJ_PIX * C
    const long long p0 = (long long)blockIdx.x * PROJ_PIX;
    const int np = (int)min((long long)PROJ_PIX, npix - p0);
    for (int i = threadIdx.x; i < np * C; i += blockDim.x)
        xs[i] = x[p0 * C + i];
    __syncthreads();
    const int nq = 2 * c8;
    const int nout = nq + C;
    for (int i = threadIdx.x; i < np * nout; i += blockDim.x) {
        const int p = i / nout, j = i % nout;
        const long long pix = p0 + p;
        if (j < nq) {
            const float* w = wqk + (long long)j * C;
            const float* xr = xs + p * C;
            float acc = 0.0f;
            for (int c = 0; c < C; ++c) acc = fmaf(xr[c], w[c], acc);
            const float y = relu6(silu(acc + pq[j]) * pq[nq + j] + pq[2 * nq + j]);
            if (j < c8) q[pix * c8 + j] = y;
            else k[pix * c8 + (j - c8)] = y;
        } else {
            const int c = j - nq;
            const float z = xs[p * C + c] * pv[c] + pv[C + c];
            v[pix * C + c] = relu6(silu(z) * pv[2 * C + c] + pv[3 * C + c]);
        }
    }
}

__device__ __forceinline__ float warp_max(float a) {
    for (int o = 16; o > 0; o >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    return a;
}

__device__ __forceinline__ float warp_sum(float a) {
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    return a;
}

// grid (ceil(W/TW), H, B), THREADS threads. Shared: e[TW][L] energies then
// weights, qs[TW][c8] queries, den[TW] softmax denominators; L = W + H
// (criss-cross) or H (vertical).
__global__ void axial_attend_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ x,
                                    const float* __restrict__ gamma,
                                    float* __restrict__ y,
                                    int H, int W, int C, int c8,
                                    int criss_cross) {
    extern __shared__ float sm[];
    const int nrow = criss_cross ? W : 0;
    const int L = nrow + H;
    float* e = sm;
    float* qs = e + TW * L;
    float* den = qs + TW * c8;

    const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * TW;
    const long long img = (long long)b * H * W;
    for (int i = threadIdx.x; i < TW * c8; i += blockDim.x) {
        const int w = w0 + i / c8;
        qs[i] = w < W ? q[(img + (long long)h * W + w) * c8 + i % c8] : 0.0f;
    }
    __syncthreads();

    const int t = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wq = w0 + t;
    if (t < TW && wq < W) {
        float* et = e + t * L;
        const float* qt = qs + t * c8;
        float m = -INFINITY;
        for (int g = lane; g < L; g += 32) {
            const float* kr = g < nrow
                ? k + (img + (long long)h * W + g) * c8             // row: k[b,h,g]
                : k + (img + (long long)(g - nrow) * W + wq) * c8;  // col: k[b,g,w]
            float acc = 0.0f;
            for (int c = 0; c < c8; ++c) acc = fmaf(qt[c], kr[c], acc);
            et[g] = acc;
            m = fmaxf(m, acc);
        }
        if (criss_cross) {
            m = warp_max(m);
            float s = 0.0f;
            for (int g = lane; g < L; g += 32) {
                const float p = expf(et[g] - m);
                et[g] = p;
                s += p;
            }
            s = warp_sum(s);
            if (lane == 0) den[t] = s;
        } else if (lane == 0) {
            den[t] = 1.0f;
        }
    }
    __syncthreads();

    const float gm = gamma[0];
    for (int i = threadIdx.x; i < TW * C; i += blockDim.x) {
        const int ti = i / C, c = i % C, w = w0 + ti;
        if (w >= W) continue;
        const float* et = e + ti * L;
        float acc = 0.0f;
        for (int g = 0; g < nrow; ++g)
            acc = fmaf(et[g], v[(img + (long long)h * W + g) * C + c], acc);
        for (int g = 0; g < H; ++g)
            acc = fmaf(et[nrow + g], v[(img + (long long)g * W + w) * C + c], acc);
        const long long o = (img + (long long)h * W + w) * C + c;
        const float out = criss_cross ? acc / den[ti] : acc;
        y[o] = gm * out + x[o];
    }
}

}  // namespace

extern "C" int axial_project(const float* x, const float* wqk, const float* pq,
                             const float* pv, float* q, float* k, float* v,
                             long long npix, int C, int c8, cudaStream_t stream) {
    if (npix <= 0) return 0;
    const unsigned blocks = (unsigned)((npix + PROJ_PIX - 1) / PROJ_PIX);
    const size_t smem = (size_t)PROJ_PIX * C * sizeof(float);
    axial_project_kernel<<<blocks, THREADS, smem, stream>>>(
        x, wqk, pq, pv, q, k, v, npix, C, c8);
    return (int)cudaGetLastError();
}

extern "C" long long axial_attend_smem(int H, int W, int c8, int criss_cross) {
    const int L = (criss_cross ? W : 0) + H;
    return (long long)(TW * L + TW * c8 + TW) * (long long)sizeof(float);
}

extern "C" int axial_attend(const float* q, const float* k, const float* v,
                            const float* x, const float* gamma, float* y,
                            int B, int H, int W, int C, int c8, int criss_cross,
                            cudaStream_t stream) {
    if (B <= 0 || H <= 0 || W <= 0) return 0;
    dim3 grid((W + TW - 1) / TW, H, B);
    const size_t smem = (size_t)axial_attend_smem(H, W, c8, criss_cross);
    axial_attend_kernel<<<grid, THREADS, smem, stream>>>(
        q, k, v, x, gamma, y, H, W, C, c8, criss_cross);
    return (int)cudaGetLastError();
}
