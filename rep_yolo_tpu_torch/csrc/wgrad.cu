// K9 wgrad3x3: the weight gradient of a 3x3 stride-1 pad-1 ungrouped conv,
// float32, for Hopper.
//
// Replaces rep_yolo_tpu/ops/pallas/wgrad_kernel.py:wgrad3x3_nhwc (the
// backward of conv3x3_pallas_wgrad). It is a tall-skinny GEMM
//
//     dW[o, j] = sum_p dY[p, o] * im2col(X)[p, j],   j = c*9 + u*3 + v,
//     im2col(X)[p, j] = Xpad[n, c, y+u, x+v],         p = (n, y, x),
//
// with the output (O, 9C) row-major, which is the OIHW weight layout. The
// reduction over P = B*H*W (3,200 to 51,200 on the flagship at 640 px) is
// long and the output small, so:
//
// - the output is cut into 64 x 64 tiles, one block each, 256 threads, each
//   thread a 4 x 4 register tile, the operands staged through shared memory
//   16 positions of P at a time (plain FFMA; TF32 stays off, as the port
//   trains in float32);
// - im2col is never materialized: each staged element of X is read from the
//   NCHW map with its one-pixel halo (zero outside), and dY is read as it
//   comes (NCHW); threads of a warp read neighbouring positions p;
// - split-K over P fills the 132 SMs when the output has few tiles (the thin
//   convs); each split writes its partial tile to a workspace and a second
//   pass adds the partials in split order, so a step repeats bit for bit (no
//   atomics).
//
// This kernel does the direct sum, 2 * O * 9C * P FLOPs. The function needs
// fewer: Winograd's minimal algorithm takes (H+2)(W+2) products per image
// and channel pair, 2 * O * C * B * (H+2)(W+2) FLOPs, 7.4x to 8.6x fewer at
// the flagship's shapes, and cuDNN's FFT algorithms beat the direct sum's
// time. The TPU kernel's padded slabs and (8, 128) alignment were Mosaic
// constraints and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // rows of the output tile (o)
constexpr int BN = 64;           // columns of the output tile (j)
constexpr int BK = 16;           // positions p staged per step
constexpr int THREADS = 256;
constexpr int PAD = 4;           // keeps float4 rows 16-byte aligned

// x (B, C, H, W), dy (B, O, H, W); out: (splits, O, 9C) partials, or dW
// itself when there is one split. Block (bx, by, bz) covers columns
// bx*BN.., rows by*BM.. over positions [bz*chunk, (bz+1)*chunk).
__global__ void __launch_bounds__(THREADS)
wgrad3x3_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                float* __restrict__ out, int C, int H, int W, int O, int P,
                int chunk) {
    __shared__ __align__(16) float As[BK][BM + PAD];
    __shared__ __align__(16) float Bs[BK][BN + PAD];

    const int HW = H * W;
    const int J = 9 * C;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int p_begin = blockIdx.z * chunk;
    const int p_end = min(P, p_begin + chunk);

    const int tid = threadIdx.x;
    const int lp = tid % BK;          // the position this thread stages
    const int lr = tid / BK;          // its first row / column (0..15)

    // this thread's four staged columns j = n0 + lr + 16*i as (c, u-1, v-1)
    int bc[4], bu[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int j = n0 + lr + 16 * i;
        const int t = j % 9;
        bc[i] = j < J ? j / 9 : -1;
        bu[i] = t / 3 - 1;
        bv[i] = t % 3 - 1;
    }

    float a_reg[4], b_reg[4];
    auto load = [&](int p0) {
        const int p = p0 + lp;
        const bool pin = p < p_end;
        const int n = pin ? p / HW : 0;
        const int hw = p - n * HW;
        const int y = hw / W;
        const int xq = hw - y * W;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int o = m0 + lr + 16 * i;
            a_reg[i] = (pin && o < O) ? dy[((size_t)n * O + o) * HW + hw] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int yy = y + bu[i], xx = xq + bv[i];
            const bool in = pin && bc[i] >= 0 && yy >= 0 && yy < H &&
                            xx >= 0 && xx < W;
            b_reg[i] = in ? x[((size_t)n * C + bc[i]) * HW + yy * W + xx]
                          : 0.f;
        }
    };

    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

    if (p_begin < p_end) load(p_begin);
    for (int p0 = p_begin; p0 < p_end; p0 += BK) {
        __syncthreads();              // the previous step's reads are done
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            As[lp][lr + 16 * i] = a_reg[i];
            Bs[lp][lr + 16 * i] = b_reg[i];
        }
        __syncthreads();
        if (p0 + BK < p_end) load(p0 + BK);   // in flight during the FMAs
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bw[q], acc[i][q]);
        }
    }

    float* dst = out + (size_t)blockIdx.z * O * J;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int o = m0 + ty * 4 + i;
        if (o >= O) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = n0 + tx * 4 + q;
            if (j < J) dst[(size_t)o * J + j] = acc[i][q];
        }
    }
}

// dw[i] = sum over s in order of ws[s, i]
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws,
                                    float* __restrict__ dw, int splits,
                                    long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        float s = ws[i];
        for (int k = 1; k < splits; ++k) s += ws[(size_t)k * n + i];
        dw[i] = s;
    }
}

}  // namespace

extern "C" {

// The split-K factor and the workspace (floats) wgrad3x3 needs: splits
// blocks along P, each at least 16 steps of BK, enough blocks in all to
// give every SM four.
int wgrad3x3_splits(int B, int C, int H, int W, int O) {
    const long long P = (long long)B * H * W;
    const long long tiles = (long long)((9 * C + BN - 1) / BN) *
                            ((O + BM - 1) / BM);
    const long long want = (132LL * 4 + tiles - 1) / tiles;
    const long long most = (P + 16 * BK - 1) / (16 * BK);
    long long s = want < most ? want : most;
    return (int)(s < 1 ? 1 : s);
}

// x (B, C, H, W) f32, dy (B, O, H, W) f32, both contiguous; dw (O, C, 3, 3)
// f32; ws: (splits - 1 > 0 ? splits : 0) * O * 9C floats. Returns a
// cudaError_t.
int wgrad3x3(const void* x, const void* dy, void* dw, void* ws, int B, int C,
             int H, int W, int O, int splits, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const long long P = (long long)B * H * W;
    if (P <= 0 || C <= 0 || O <= 0) return 0;
    if (P >= (1LL << 31) || (long long)B * C * H * W >= (1LL << 40) ||
        splits < 1)
        return (int)cudaErrorInvalidValue;
    const int J = 9 * C;
    long long chunk = (P + splits - 1) / splits;
    chunk = (chunk + BK - 1) / BK * BK;
    const int used = (int)((P + chunk - 1) / chunk);
    dim3 grid((J + BN - 1) / BN, (O + BM - 1) / BM, used);
    float* dst = used > 1 ? (float*)ws : (float*)dw;
    wgrad3x3_kernel<<<grid, THREADS, 0, stream>>>(
        (const float*)x, (const float*)dy, dst, C, H, W, O, (int)P,
        (int)chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || used == 1) return (int)err;
    const long long n = (long long)O * J;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    wgrad_reduce_kernel<<<(int)blocks, threads, 0, stream>>>(
        (const float*)ws, (float*)dw, used, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
