// K9 wgrad3x3: the weight gradient of a 3x3 stride-1 pad-1 ungrouped conv,
// float32, for Hopper.
//
// Replaces rep_yolo_tpu/ops/pallas/wgrad_kernel.py:wgrad3x3_nhwc (the
// backward of conv3x3_pallas_wgrad):
//
//     dW[o, c, u, v] = sum_{n,y,x} dY[n, o, y, x] * Xpad[n, c, y+u, x+v],
//
// NCHW x (B, C, H, W) and dY (B, O, H, W), dW (O, C, 3, 3) (OIHW).
//
// What bounds it on this card: the reduction over P = B*H*W (3,200 to
// 51,200 on the flagship at 640 px) is long and the output small, so the
// work is products, not bytes. The direct sum takes 2 * O * 9C * P float32
// operations (128 GFLOP over the nine convs of a train step, 1.9 ms at the
// 67 TFLOP/s of the float32 pipes). This kernel cuts both the count and the
// cost of a product:
//
// - Winograd F(3x3, 2x2). dY is cut into 2x2 tiles (odd H or W pads dY with
//   zeros); tile t pairs with the 4x4 patch of Xpad at the same corner, and
//   its 36 products become 16:
//       Vy_t = G dY_t G^T, Ux_t = B^T X_t B, M = sum_t Vy_t * Ux_t,
//       dW = A^T M A,
//   with G = [1 0; .5 .5; .5 -.5; 0 -1],
//   B^T = [1 0 -1 0; 0 1 1 0; 0 -1 1 0; 0 1 0 -1],
//   A^T = [1 1 1 0; 0 1 -1 0; 0 1 1 1]
//   (F(2x2, 3x3)'s matrices with the roles of its filter and output
//   swapped; the factor 1/2 sits on dY's side so that A^T only adds).
// - The 16 products per tile are 16 GEMMs M[k] (O x C) = Vy[k] . Ux[k]^T
//   over K = T = B * ceil(H/2) * ceil(W/2), run on the TF32 tensor cores
//   (mma.sync m16n8k8) in 3xTF32: each float32 operand a is split into
//   hi = tf32(a) and lo = tf32(a - hi) (both rounded as cvt.rna: to
//   nearest, ties away), and lo*hi' + hi*lo' + hi*hi' is accumulated in
//   float32, which keeps the float32 result's accuracy (hi alone, 1xTF32,
//   misses the port's 1e-4 gate at P = 51,200).
//
// Three passes, each a kernel:
// 1. wgrad3x3_transform_kernel writes Vy (16, O, Tp) and Ux (16, C, Tp), T
//    contiguous and padded with zeros to Tp, a multiple of the GEMM's k-step
//    (the "nonfused" form: about 4x the bytes of x and dY, and a plain GEMM).
// 2. wgrad3x3_gemm_kernel: 64 x 64 output tiles of one M[k], 4 warps of 32 x
//    32, the operands staged 32 tiles of T at a time through a ring of three
//    shared-memory stages filled by cp.async (the next tiles' copies overlap
//    the current products), row pitch 36 floats so that the fragment loads
//    hit 32 distinct banks. Split-K over T fills the 132 SMs where the
//    output has few tiles (the thin convs); each split writes its own
//    partial M.
// 3. wgrad3x3_output_kernel adds the splits' partials in split order (no
//    atomics, so a step repeats bit for bit) and applies A^T M A, 16 (o, c)
//    pairs a block, one thread per product index k while it sums.
//
// The TPU kernel's padded slabs and (8, 128) alignment were Mosaic
// constraints and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GM = 64;           // output rows (o) of a GEMM tile
constexpr int GN = 64;           // output columns (c) of a GEMM tile
constexpr int GK = 32;           // tiles t staged per step
constexpr int PITCH = GK + 4;    // shared row pitch, floats (36: 4 mod 32)
constexpr int STAGES = 3;
constexpr int GT = 128;          // GEMM threads: 4 warps
constexpr int SMEM = STAGES * (GM + GN) * PITCH * 4;   // 55,296 bytes
constexpr int XT = 128;          // transform threads

// ---------------------------------------------------------------------------
// 1. transforms
// ---------------------------------------------------------------------------

// Block row r < O: Vy[:, r, t] from dY; r >= O: Ux[:, r - O, t] from x.
// t = (n * TH + ty) * TW + tx; t in [T, Tp) is written as zeros.
__global__ void __launch_bounds__(XT)
wgrad3x3_transform_kernel(const float* __restrict__ x,
                          const float* __restrict__ dy, float* __restrict__ vy,
                          float* __restrict__ ux, int C, int H, int W, int O,
                          int TH, int TW, int T, int Tp) {
    const int t = blockIdx.x * XT + threadIdx.x;
    if (t >= Tp) return;
    const int r = blockIdx.y;
    const bool in = t < T;
    int n = 0, ty = 0, tx = 0;
    if (in) {
        n = t / (TH * TW);
        const int rem = t - n * TH * TW;
        ty = rem / TW;
        tx = rem - ty * TW;
    }
    const long long HW = (long long)H * W;
    float v[16];
    float* dst;
    long long kstride;
    if (r < O) {
        // G dY_t G^T, dY_t rows 2ty.., columns 2tx..
        const float* src = dy + ((long long)n * O + r) * HW;
        float d[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int yy = 2 * ty + i, xx = 2 * tx + j;
                d[i][j] = (in && yy < H && xx < W) ? src[yy * W + xx] : 0.f;
            }
        float g[4][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            g[0][j] = d[0][j];
            g[1][j] = 0.5f * (d[0][j] + d[1][j]);
            g[2][j] = 0.5f * (d[0][j] - d[1][j]);
            g[3][j] = -d[1][j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            v[4 * i + 0] = g[i][0];
            v[4 * i + 1] = 0.5f * (g[i][0] + g[i][1]);
            v[4 * i + 2] = 0.5f * (g[i][0] - g[i][1]);
            v[4 * i + 3] = -g[i][1];
        }
        dst = vy + (long long)r * Tp + t;
        kstride = (long long)O * Tp;
    } else {
        // B^T X_t B, X_t = Xpad rows 2ty.. (x rows 2ty - 1..), zero outside
        const int c = r - O;
        const float* src = x + ((long long)n * C + c) * HW;
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int yy = 2 * ty - 1 + i, xx = 2 * tx - 1 + j;
                p[i][j] = (in && yy >= 0 && yy < H && xx >= 0 && xx < W)
                              ? src[yy * W + xx] : 0.f;
            }
        float s[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            s[0][j] = p[0][j] - p[2][j];
            s[1][j] = p[1][j] + p[2][j];
            s[2][j] = p[2][j] - p[1][j];
            s[3][j] = p[1][j] - p[3][j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            v[4 * i + 0] = s[i][0] - s[i][2];
            v[4 * i + 1] = s[i][1] + s[i][2];
            v[4 * i + 2] = s[i][2] - s[i][1];
            v[4 * i + 3] = s[i][1] - s[i][3];
        }
        dst = ux + (long long)c * Tp + t;
        kstride = (long long)C * Tp;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[k * kstride] = v[k];
}

// ---------------------------------------------------------------------------
// 2. the 16 GEMMs, 3xTF32
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo, hi = tf32(a) and lo = tf32(a - hi), both rounded to nearest,
// ties away from zero: hi by cvt.rna.tf32.f32, lo by the same rounding as
// two integer operations (add half of the 13 dropped bits, clear them),
// which equals cvt.rna for every finite value; the residual is finite
// whenever a is (a NaN or Inf a leaves hi non-finite). The cvt is the
// slower of the two on this card, and these splits sit in the inner loop.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
    const float rest = a - __uint_as_float(hi);
    lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// vy (16, O, Tp), ux (16, C, Tp); m (splits, 16, O, C): block (bx, by, bz)
// computes columns bx*GN.., rows by*GM.. of M[bz % 16] over the tiles
// [split * chunk, (split + 1) * chunk), split = bz / 16.
__global__ void __launch_bounds__(GT)
wgrad3x3_gemm_kernel(const float* __restrict__ vy, const float* __restrict__ ux,
                     float* __restrict__ m, int O, int C, int Tp, int chunk) {
    extern __shared__ __align__(16) float smem[];
    const int k = blockIdx.z % 16, split = blockIdx.z / 16;
    const int o0 = blockIdx.y * GM, c0 = blockIdx.x * GN;
    const int t_begin = split * chunk;
    const int steps = (min(Tp, t_begin + chunk) - t_begin) / GK;
    const float* A = vy + (long long)k * O * Tp;
    const float* Bm = ux + (long long)k * C * Tp;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

    // one stage: 64 rows x 8 16-byte chunks of each operand, 4 a thread;
    // rows past O or C are zero-filled
    auto load = [&](int stage, int t0) {
        float* As = smem + stage * (GM + GN) * PITCH;
        float* Bs = As + GM * PITCH;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int e = tid + i * GT, row = e >> 3, q = (e & 7) * 4;
            const int o = o0 + row, c = c0 + row;
            cp_async16(As + row * PITCH + q,
                       A + (long long)(o < O ? o : 0) * Tp + t0 + q, o < O);
            cp_async16(Bs + row * PITCH + q,
                       Bm + (long long)(c < C ? c : 0) * Tp + t0 + q, c < C);
        }
    };

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < steps) load(s, t_begin + s * GK);
        cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
        cp_async_wait<STAGES - 2>();      // this step's stage has landed
        __syncthreads();                  // and every warp is done with the
                                          // stage the next load refills
        const int next = step + STAGES - 1;
        if (next < steps) load(next % STAGES, t_begin + next * GK);
        cp_async_commit();
        const float* As = smem + (step % STAGES) * (GM + GN) * PITCH;
        const float* Bs = As + GM * PITCH;
#pragma unroll
        for (int kk = 0; kk < GK; kk += 8) {
            uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float* r0 = As + (wm + i * 16 + g) * PITCH + kk + t4;
                const float* r8 = r0 + 8 * PITCH;
                split_tf32(r0[0], ah[i][0], al[i][0]);
                split_tf32(r8[0], ah[i][1], al[i][1]);
                split_tf32(r0[4], ah[i][2], al[i][2]);
                split_tf32(r8[4], ah[i][3], al[i][3]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float* col = Bs + (wn + j * 8 + g) * PITCH + kk + t4;
                split_tf32(col[0], bh[j][0], bl[j][0]);
                split_tf32(col[4], bh[j][1], bl[j][1]);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    mma_tf32(acc[i][j], al[i], bh[j]);
                    mma_tf32(acc[i][j], ah[i], bl[j]);
                    mma_tf32(acc[i][j], ah[i], bh[j]);
                }
        }
    }
    cp_async_wait<0>();

    float* dst = m + ((long long)split * 16 + k) * O * C;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = o0 + wm + i * 16 + g + 8 * h;
                const int c = c0 + wn + j * 8 + 2 * t4;
                if (o >= O) continue;
                if (c < C) dst[(long long)o * C + c] = acc[i][j][2 * h];
                if (c + 1 < C) dst[(long long)o * C + c + 1] = acc[i][j][2 * h + 1];
            }
}

// ---------------------------------------------------------------------------
// 3. the splits' sum and the output transform
// ---------------------------------------------------------------------------

// dw[i] = A^T (sum over s in order of m[s, :, i]) A, i = o * C + c; a block
// takes 16 consecutive i: thread (k, j) adds the splits' M[k, i0 + j], then
// the block writes the 16 x 9 outputs (contiguous in dw)
__global__ void __launch_bounds__(256)
wgrad3x3_output_kernel(const float* __restrict__ m, float* __restrict__ dw,
                       int splits, long long OC) {
    __shared__ float s[16][17];
    const int k = threadIdx.x >> 4, j = threadIdx.x & 15;
    const long long i0 = blockIdx.x * 16LL, i = i0 + j;
    float v = 0.f;
    if (i < OC) {
        v = m[k * OC + i];
        for (int sp = 1; sp < splits; ++sp) v += m[(sp * 16LL + k) * OC + i];
    }
    s[j][k] = v;
    __syncthreads();
    if (threadIdx.x >= 16 * 9) return;
    const int jj = threadIdx.x / 9, uv = threadIdx.x - jj * 9;
    const int u = uv / 3, w = uv - 3 * u;
    if (i0 + jj >= OC) return;
    const float* q = s[jj];           // M as 4 x 4, row r = q[4r..4r+3]
    float a[4];                       // row u of A^T M
#pragma unroll
    for (int c = 0; c < 4; ++c)
        a[c] = u == 0 ? q[c] + q[4 + c] + q[8 + c]
             : u == 1 ? q[4 + c] - q[8 + c] : q[4 + c] + q[8 + c] + q[12 + c];
    dw[(i0 + jj) * 9 + uv] = w == 0 ? a[0] + a[1] + a[2]
                           : w == 1 ? a[1] - a[2] : a[1] + a[2] + a[3];
}

struct Plan {
    int TH, TW, T, Tp, splits, chunk;
};

// The tiles, their padded count and the split-K over them: enough blocks to
// give every SM four, each split at least 8 steps of GK tiles.
Plan plan(int B, int C, int H, int W, int O) {
    Plan p;
    p.TH = (H + 1) / 2;
    p.TW = (W + 1) / 2;
    p.T = B * p.TH * p.TW;
    p.Tp = (p.T + GK - 1) / GK * GK;
    const int steps = p.Tp / GK;
    const long long tiles = 16LL * ((O + GM - 1) / GM) * ((C + GN - 1) / GN);
    long long want = (132LL * 4 + tiles - 1) / tiles;
    const long long most = steps / 8 > 1 ? steps / 8 : 1;
    if (want > most) want = most;
    const int per = (steps + (int)want - 1) / (int)want;
    p.chunk = per * GK;
    p.splits = (steps + per - 1) / per;
    return p;
}

}  // namespace

extern "C" {

// Floats of workspace wgrad3x3 needs at this shape: Vy, Ux and the splits'
// partial M.
long long wgrad3x3_workspace(int B, int C, int H, int W, int O) {
    const Plan p = plan(B, C, H, W, O);
    return 16LL * (O + C) * p.Tp + 16LL * p.splits * O * C;
}

// x (B, C, H, W) f32, dy (B, O, H, W) f32, both contiguous; dw (O, C, 3, 3)
// f32; ws: wgrad3x3_workspace(...) floats. Returns a cudaError_t.
int wgrad3x3(const void* x, const void* dy, void* dw, void* ws, int B, int C,
             int H, int W, int O, void* stream_ptr) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0) return 0;
    if ((long long)B * H * W >= (1LL << 31) || O + C > 65535 ||
        (long long)B * C * H * W >= (1LL << 40) ||
        (long long)B * O * H * W >= (1LL << 40))
        return (int)cudaErrorInvalidValue;
    const Plan p = plan(B, C, H, W, O);
    float* vy = (float*)ws;
    float* ux = vy + 16LL * O * p.Tp;
    float* m = ux + 16LL * C * p.Tp;

    dim3 tgrid((p.Tp + XT - 1) / XT, O + C);
    wgrad3x3_transform_kernel<<<tgrid, XT, 0, stream>>>(
        (const float*)x, (const float*)dy, vy, ux, C, H, W, O, p.TH, p.TW,
        p.T, p.Tp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    err = cudaFuncSetAttribute(wgrad3x3_gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 ggrid((C + GN - 1) / GN, (O + GM - 1) / GM, 16 * p.splits);
    wgrad3x3_gemm_kernel<<<ggrid, GT, SMEM, stream>>>(vy, ux, m, O, C, p.Tp,
                                                      p.chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const long long OC = (long long)O * C;
    wgrad3x3_output_kernel<<<(unsigned)((OC + 15) / 16), 256, 0, stream>>>(
        m, (float*)dw, p.splits, OC);
    return (int)cudaGetLastError();
}

}  // extern "C"
