// Fused axial (criss-cross / vertical) attention for Hopper, f32.
//
// Replaces rep_yolo_tpu/ops/pallas/axial_attention.py:criss_cross_fused_x
// and vertical_fused_x (kernel body _axis_kernel_x), and criss_cross_fused
// / vertical_fused (the row-3 route). For x (B,H,W,C) NHWC and the packed
// deploy constants of nn/blocks.py
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
// Two kernel templates, all f32 FFMA (no tensor cores: TF32 would miss the
// 1e-4 gate, and each call is at most a few hundred MFLOP):
//   K1 axial_project_kernel<RP, RJ>: a block takes TP = 32*RP pixels and a
//      group of NG = 8*RJ of the 2*c8 q/k columns (2*c8 > 16 takes several
//      groups, blockIdx.y). The pixel tile (TP*C contiguous floats), the
//      group's weight rows and pv land in shared memory at once by cp.async
//      (16 bytes), so a block waits on memory once. Each group turns its
//      share of the tile's channels into v (16-byte stores). Each thread
//      owns a register tile of RP pixels x RJ columns (8 column threads x
//      32 pixel threads): 4 channels cost RP + RJ float4 reads from shared
//      memory and 4*RP*RJ FMAs, summed over C in channel order. The SiLU /
//      BN / ReLU6 epilogue runs in registers.
//   K2, axial_attend_line_kernel<RQ, MODE> (RQ >= 5: the register-capped
//      axial_attend_line_capped_kernel<RQ, MODE>), one body for a line of
//      keys and values, a column or a row: a block takes one line of one
//      image, a query tile of QT = TQ*RQ of its pixels and a channel tile
//      of CT = 4*TC channels (TQ*TC = 256 threads). It streams the line's
//      keys in chunks of KCH pixels: k and v of a chunk land once in shared
//      memory by cp.async (16 bytes; up to 4 chunks in flight, which at 640
//      px is the whole line), E = Q_tile K_chunk^T is formed in shared
//      memory four keys a thread, and O += E V_chunk accumulates in a
//      register tile of RQ pixels x 4 channels a thread (its E values read
//      as float4s). Shared memory depends on the tile and the chunk, not on
//      the line's length, so any H and W run (query tiles loop where a line
//      exceeds one tile). The modes:
//        LINE_RAW (vertical): the column's raw energies, y = gamma O + x.
//        LINE_ROW (criss-cross, first): the row's energies under a softmax
//          kept flash-style, a running max m and sum s a query, O rescaled
//          by exp(m_before - m) when a chunk raises m; it writes the
//          unnormalised O = sum exp(e - m) v, m and s (the row branch's
//          outputs in criss_cross_fused_x).
//        LINE_MERGE (criss-cross, second): the same over the column, and
//          in its epilogue the merge of criss_cross_fused_x: a_w, a_h =
//          exp(m_w - max(m_w, m_h)), exp(m_h - ...), y = gamma (O_w a_w +
//          O_h a_h) / (s_w a_w + s_h a_h) + x. The centre pixel counts in
//          both branches, as in the reference.
//      What bounds it: the energy route's 2 L (c8 + C) FMAs a pixel from
//      shared memory (L the line's length), against bytes that read each
//      of q, k, v, x once and, for criss-cross, the row pass's O twice.
//
// The host code (ops/kernels/axial_attention.py: project_tile,
// line_tile) picks the tiles and checks the shapes; these entries
// launch what they are given.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

__device__ __forceinline__ float relu6(float z) {
    return fminf(fmaxf(z, 0.0f), 6.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// K1: the projection
// ---------------------------------------------------------------------------

constexpr int P_THREADS = 256;
constexpr int P_TJ = 8;                   // column threads
constexpr int P_TPT = P_THREADS / P_TJ;   // pixel threads (32)

// floats of shared memory: xs [TP][C + 4], ws [NG][C + 4], pvs [4][C]
__host__ __device__ inline long long project_smem_floats(int C, int TP,
                                                         int NG) {
    return (long long)(TP + NG) * (C + 4) + 4LL * C;
}

// grid (ceil(npix / TP), ngroups), P_THREADS threads; TP = 32 * RP pixels a
// block, NG = 8 * RJ of the 2*c8 q/k columns a block (group blockIdx.y).
template <int RP, int RJ>
__global__ void __launch_bounds__(P_THREADS)
axial_project_kernel(const float* __restrict__ x,
                     const float* __restrict__ wqk,
                     const float* __restrict__ pq,
                     const float* __restrict__ pv,
                     float* __restrict__ q, float* __restrict__ k,
                     float* __restrict__ v, long long npix, int C, int c8) {
    constexpr int TP = P_TPT * RP, NG = P_TJ * RJ;
    extern __shared__ __align__(16) float sm[];
    const int pitch = C + 4, C4 = C / 4;       // pitch: rows 16 bytes apart
    float* xs = sm;                              // in bank groups
    float* ws = xs + TP * pitch;
    float* pvs = ws + NG * pitch;

    const int nq = 2 * c8, grp = blockIdx.y, ngroups = gridDim.y;
    const int j0 = grp * NG;
    const int tid = threadIdx.x, jt = tid % P_TJ, pt = tid / P_TJ;
    const long long p0 = (long long)blockIdx.x * TP;
    const int np = (int)min((long long)TP, npix - p0);

    // the pixel tile (TP * C contiguous floats), the group's weight rows
    // (zeros past 2*c8) and pv, all in flight at once
    for (int idx = tid; idx < np * C4; idx += P_THREADS) {
        const int p = idx / C4, f = idx % C4;
        cp_async16(xs + p * pitch + 4 * f, x + (p0 + p) * C + 4 * f);
    }
    for (int idx = tid; idx < NG * C4; idx += P_THREADS) {
        const int j = idx / C4, f = idx % C4;
        if (j0 + j < nq)
            cp_async16(ws + j * pitch + 4 * f,
                       wqk + (long long)(j0 + j) * C + 4 * f);
        else
            *reinterpret_cast<float4*>(ws + j * pitch + 4 * f) =
                make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int idx = tid; idx < C; idx += P_THREADS)
        cp_async16(pvs + 4 * idx, pv + 4 * idx);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // v of this group's share of the channels (a contiguous float4 range
    // of each pixel), 16-byte stores
    const int f0 = grp * C4 / ngroups, nf = (grp + 1) * C4 / ngroups - f0;
    for (int idx = tid; idx < np * nf; idx += P_THREADS) {
        const int p = idx / nf, c = 4 * (f0 + idx % nf);
        const float4 xv = *reinterpret_cast<const float4*>(xs + p * pitch + c);
        const float4 a = *reinterpret_cast<const float4*>(pvs + c);
        const float4 b = *reinterpret_cast<const float4*>(pvs + C + c);
        const float4 g = *reinterpret_cast<const float4*>(pvs + 2 * C + c);
        const float4 h = *reinterpret_cast<const float4*>(pvs + 3 * C + c);
        float4 o;
        o.x = relu6(silu(xv.x * a.x + b.x) * g.x + h.x);
        o.y = relu6(silu(xv.y * a.y + b.y) * g.y + h.y);
        o.z = relu6(silu(xv.z * a.z + b.z) * g.z + h.z);
        o.w = relu6(silu(xv.w * a.w + b.w) * g.w + h.w);
        *reinterpret_cast<float4*>(v + (p0 + p) * C + c) = o;
    }

    // a register tile of RP pixels (pt + 32 i) x RJ columns (jt + 8 r),
    // summed over C in channel order
    float acc[RP][RJ];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int r = 0; r < RJ; ++r) acc[i][r] = 0.0f;
#pragma unroll 4
    for (int c4 = 0; c4 < C4; ++c4) {
        float4 a[RP];
#pragma unroll
        for (int i = 0; i < RP; ++i)
            a[i] = *reinterpret_cast<const float4*>(
                xs + (pt + P_TPT * i) * pitch + 4 * c4);
#pragma unroll
        for (int r = 0; r < RJ; ++r) {
            const float4 b = *reinterpret_cast<const float4*>(
                ws + (jt + P_TJ * r) * pitch + 4 * c4);
#pragma unroll
            for (int i = 0; i < RP; ++i) {
                float t = acc[i][r];
                t = fmaf(a[i].x, b.x, t);
                t = fmaf(a[i].y, b.y, t);
                t = fmaf(a[i].z, b.z, t);
                acc[i][r] = fmaf(a[i].w, b.w, t);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RJ; ++r) {
        const int j = j0 + jt + P_TJ * r;
        if (j >= nq) continue;
        const float bias = pq[j], scale = pq[nq + j], shift = pq[2 * nq + j];
        float* out = j < c8 ? q + j : k + (j - c8);
#pragma unroll
        for (int i = 0; i < RP; ++i) {
            const int p = pt + P_TPT * i;
            if (p < np)
                out[(p0 + p) * c8] =
                    relu6(silu(acc[i][r] + bias) * scale + shift);
        }
    }
}

// ---------------------------------------------------------------------------
// K2: the line kernel. A line is a column (vertical; criss-cross's column
// pass) or a row (criss-cross's row pass); a block stages its keys and
// values once, in chunks, for all the queries of a tile on that line.
// ---------------------------------------------------------------------------

constexpr int V_THREADS = 256;

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// floats a staged query / key row: c8 padded to whole float4s, plus one
// float4 where that count is even (rows an odd number of float4s apart
// fall in distinct bank groups)
__host__ __device__ inline int key_pitch(int c8) {
    const int p = round4(c8);
    return (p / 4) % 2 ? p : p + 4;
}

constexpr int V_MAX_STAGES = 4;

// What a line block computes (the template's MODE, the C entry's mode).
enum LineMode : int {
    LINE_RAW = 0,       // vertical: raw column energies, y = gamma O + x
    LINE_ROW = 1,       // criss-cross row pass: softmax statistics over the
                        // row; writes O = sum exp(e - m) v unnormalised,
                        // its max m and its sum s
    LINE_MERGE = 2,     // criss-cross column pass: the same over the
                        // column, merged with the row pass's O, m, s under
                        // the joint softmax into y
};

// floats of shared memory: Qs [QT][kp], Ks NS x [KCH][kp], Vs NS x
// [KCH][CT], Es [KCH][QTP]; with the softmax also Al, Ms, Ss [QTP] (QTP =
// TQ * round4(RQ) positions of an energy row)
__host__ __device__ inline long long line_smem_floats(int c8, int TC, int RQ,
                                                      int KCH, int NS,
                                                      int mode) {
    const long long kp = key_pitch(c8), TQ = V_THREADS / TC;
    const long long QTP = TQ * round4(RQ);
    return (TQ * RQ + (long long)NS * KCH) * kp
        + (long long)NS * KCH * 4 * TC
        + (KCH + (mode != LINE_RAW ? 3 : 0)) * QTP;
}

__device__ __forceinline__ void cp_async_wait_n(int n) {
    switch (n) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        default: cp_async_wait<3>(); break;
    }
}

// grid (lines of an image: W columns, or H rows for LINE_ROW; B; qtiles *
// ctiles), V_THREADS threads; TC a power of two dividing V_THREADS, the
// query tile QT = (V_THREADS / TC) * RQ pixels of the line, KCH a multiple
// of 4, NS stages (1..V_MAX_STAGES) of key chunks in flight. po / pm / ps
// are the row pass's partials (B, H, W, C) / (B, H, W) / (B, H, W): written
// by LINE_ROW, read by LINE_MERGE (16-byte aligned), unused by LINE_RAW.
template <int RQ, int MODE>
__device__ __forceinline__ void line_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ x,
    const float* __restrict__ gamma, float* __restrict__ y,
    float* __restrict__ po, float* __restrict__ pm, float* __restrict__ ps,
    int H, int W, int C, int c8, int TC, int KCH, int NS, int ctiles) {
    constexpr bool SOFTMAX = MODE != LINE_RAW, ROW = MODE == LINE_ROW;
    constexpr int RQP = (RQ + 3) / 4 * 4;      // a thread's rows in Es
    extern __shared__ __align__(16) float sm[];
    const int TQ = V_THREADS / TC, CT = 4 * TC, QT = TQ * RQ, QTP = TQ * RQP;
    const int kp = key_pitch(c8), c8p = round4(c8);
    float* Qs = sm;
    float* Ks = Qs + QT * kp;
    float* Vs = Ks + NS * KCH * kp;
    float* Es = Vs + NS * KCH * CT;
    float* Al = Es + KCH * QTP;     // softmax: a position's rescale factor,
    float* Ms = Al + QTP;           // running max
    float* Ss = Ms + QTP;           // and running sum

    const int tid = threadIdx.x, tc = tid % TC, tq = tid / TC;
    const int b = blockIdx.y;
    const int q0 = (blockIdx.z / ctiles) * QT, c0 = (blockIdx.z % ctiles) * CT;
    // the line: L pixels ls apart from pixel `line` (row h = blockIdx.x, or
    // column w = blockIdx.x, of image b)
    const int L = ROW ? W : H;
    const long long ls = ROW ? 1 : W;
    const long long line = (long long)b * H * W
        + (ROW ? (long long)blockIdx.x * W : (long long)blockIdx.x);
    const bool k16 = c8 % 4 == 0;

    // the query tile, Qs[i][d] = q[line pixel q0 + i][d], zeros past c8
    // and L; the key stages' pad columns zeroed once (the copies never
    // write them); the softmax statistics started
    for (int idx = tid; idx < QT * c8p; idx += V_THREADS) {
        const int i = idx / c8p, d = idx % c8p;
        Qs[i * kp + d] = q0 + i < L && d < c8
            ? q[(line + (long long)(q0 + i) * ls) * c8 + d] : 0.0f;
    }
    for (int idx = tid; idx < NS * KCH * (c8p - c8); idx += V_THREADS)
        Ks[(idx / (c8p - c8)) * kp + c8 + idx % (c8p - c8)] = 0.0f;
    if constexpr (SOFTMAX)
        for (int p = tid; p < QTP; p += V_THREADS) {
            Ms[p] = -INFINITY;
            Ss[p] = 0.0f;
        }

    const int nch = (L + KCH - 1) / KCH;
    // chunk n's k rows and v rows (its channel tile) into stage n % NS
    auto issue = [&](int n) {
        const int g0 = n * KCH, kn = min(KCH, L - g0);
        float* kb = Ks + (n % NS) * KCH * kp;
        float* vb = Vs + (n % NS) * KCH * CT;
        if (k16) {
            for (int idx = tid; idx < kn * c8 / 4; idx += V_THREADS) {
                const int g = idx / (c8 / 4), f = idx % (c8 / 4);
                cp_async16(kb + g * kp + 4 * f,
                           k + (line + (long long)(g0 + g) * ls) * c8 + 4 * f);
            }
        } else {
            for (int idx = tid; idx < kn * c8; idx += V_THREADS) {
                const int g = idx / c8, d = idx % c8;
                cp_async4(kb + g * kp + d,
                          k + (line + (long long)(g0 + g) * ls) * c8 + d);
            }
        }
        for (int idx = tid; idx < kn * TC; idx += V_THREADS) {
            const int g = idx / TC, f = idx % TC;
            cp_async16(vb + g * CT + 4 * f,
                       v + (line + (long long)(g0 + g) * ls) * C + c0 + 4 * f);
        }
        cp_async_commit();
    };

    // the energy step: query row ei of the tile, key groups of four from
    // eg0 in steps of EG; row i is kept at position (i % TQ) * RQP + i / TQ
    // of an Es row, so a thread's RQ rows are adjacent
    const int EG = V_THREADS / QT, ei = tid % QT, eg0 = tid / QT;
    const int epos = (ei % TQ) * RQP + ei / TQ;
    const float* qi = Qs + ei * kp;

    float4 o[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) o[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    for (int n = 0; n < NS && n < nch; ++n) issue(n);
    for (int n = 0; n < nch; ++n) {
        // chunk n has landed once no more than the chunks issued after it
        // are pending
        cp_async_wait_n(min(nch - 1, n + NS - 1) - n);
        __syncthreads();
        const int kn = min(KCH, L - n * KCH);
        const float* kb = Ks + (n % NS) * KCH * kp;
        const float* vb = Vs + (n % NS) * KCH * CT;
        // E[g][i] = q[q0 + i] . k[g0 + g], four keys a thread, over c8 in
        // order (rows past kn hold stale keys and are never read)
        if (eg0 < EG)
            for (int g = 4 * eg0; g < kn; g += 4 * EG) {
                const float* kg = kb + g * kp;
                float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f, e3 = 0.0f;
                for (int d = 0; d < c8p; d += 4) {
                    const float4 a = *reinterpret_cast<const float4*>(qi + d);
                    const float4 k0 = *reinterpret_cast<const float4*>(kg + d);
                    const float4 k1 = *reinterpret_cast<const float4*>(kg + kp + d);
                    const float4 k2 = *reinterpret_cast<const float4*>(kg + 2 * kp + d);
                    const float4 k3 = *reinterpret_cast<const float4*>(kg + 3 * kp + d);
                    e0 = fmaf(a.w, k0.w, fmaf(a.z, k0.z, fmaf(a.y, k0.y, fmaf(a.x, k0.x, e0))));
                    e1 = fmaf(a.w, k1.w, fmaf(a.z, k1.z, fmaf(a.y, k1.y, fmaf(a.x, k1.x, e1))));
                    e2 = fmaf(a.w, k2.w, fmaf(a.z, k2.z, fmaf(a.y, k2.y, fmaf(a.x, k2.x, e2))));
                    e3 = fmaf(a.w, k3.w, fmaf(a.z, k3.z, fmaf(a.y, k3.y, fmaf(a.x, k3.x, e3))));
                }
                Es[g * QTP + epos] = e0;
                Es[(g + 1) * QTP + epos] = e1;
                Es[(g + 2) * QTP + epos] = e2;
                Es[(g + 3) * QTP + epos] = e3;
            }
        __syncthreads();
        if constexpr (SOFTMAX) {
            // flash-style: a position's running max m takes the chunk's
            // energies in, they become exp(e - m), and Al = exp(m_before -
            // m) rescales what the earlier chunks summed (one thread a
            // position, consecutive positions on consecutive threads)
            for (int p = tid; p < QTP; p += V_THREADS) {
                if (p % RQP >= RQ) continue;
                float* ep = Es + p;
                const float m0 = Ms[p];
                float m = m0;
                for (int g = 0; g < kn; ++g) m = fmaxf(m, ep[g * QTP]);
                float s = 0.0f;
                for (int g = 0; g < kn; ++g) {
                    const float e = expf(ep[g * QTP] - m);
                    ep[g * QTP] = e;
                    s += e;
                }
                const float a = expf(m0 - m);      // 0 at the first chunk
                Al[p] = a;
                Ss[p] = Ss[p] * a + s;
                Ms[p] = m;
            }
            __syncthreads();
#pragma unroll
            for (int r4 = 0; r4 < RQP; r4 += 4) {
                const float4 a4 = *reinterpret_cast<const float4*>(
                    Al + tq * RQP + r4);
                const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    if (r4 + u >= RQ) break;
                    float4& acc = o[r4 + u];
                    acc.x *= av[u];
                    acc.y *= av[u];
                    acc.z *= av[u];
                    acc.w *= av[u];
                }
            }
        }
        // O[i][c..c+3] += sum_g E[g][i] v[g0 + g][c..c+3], i = tq + TQ r
#pragma unroll 2
        for (int g = 0; g < kn; ++g) {
            const float4 vv = *reinterpret_cast<const float4*>(vb + g * CT + 4 * tc);
            const float* eg = Es + g * QTP + tq * RQP;
#pragma unroll
            for (int r4 = 0; r4 < RQP; r4 += 4) {
                const float4 e4 = *reinterpret_cast<const float4*>(eg + r4);
                const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    if (r4 + u >= RQ) break;
                    float4& acc = o[r4 + u];
                    acc.x = fmaf(ev[u], vv.x, acc.x);
                    acc.y = fmaf(ev[u], vv.y, acc.y);
                    acc.z = fmaf(ev[u], vv.z, acc.z);
                    acc.w = fmaf(ev[u], vv.w, acc.w);
                }
            }
        }
        __syncthreads();                       // stage n % NS and Es free
        if (n + NS < nch) issue(n + NS);
    }

    const float gm = gamma[0];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        const int i = q0 + tq + TQ * r;
        if (i >= L) continue;
        const long long pix = line + (long long)i * ls;
        const long long off = pix * C + c0 + 4 * tc;
        if constexpr (MODE == LINE_ROW) {
            *reinterpret_cast<float4*>(po + off) = o[r];
            if (c0 == 0 && tc == 0) {
                pm[pix] = Ms[tq * RQP + r];
                ps[pix] = Ss[tq * RQP + r];
            }
        } else {
            const float4 xv = *reinterpret_cast<const float4*>(x + off);
            float4 t = o[r];
            if constexpr (MODE == LINE_MERGE) {
                // the merge of criss_cross_fused_x: both branches rescaled
                // to their joint max, over their joint sum
                const float mh = Ms[tq * RQP + r], sh = Ss[tq * RQP + r];
                const float mw = pm[pix], sw = ps[pix];
                const float mx = fmaxf(mw, mh);
                const float aw = expf(mw - mx), ah = expf(mh - mx);
                const float inv = 1.0f / (sw * aw + sh * ah);
                const float4 ow = *reinterpret_cast<const float4*>(po + off);
                t.x = (ow.x * aw + t.x * ah) * inv;
                t.y = (ow.y * aw + t.y * ah) * inv;
                t.z = (ow.z * aw + t.z * ah) * inv;
                t.w = (ow.w * aw + t.w * ah) * inv;
            }
            float4 out;
            out.x = gm * t.x + xv.x;
            out.y = gm * t.y + xv.y;
            out.z = gm * t.z + xv.z;
            out.w = gm * t.w + xv.w;
            *reinterpret_cast<float4*>(y + off) = out;
        }
    }
}

#define LINE_PARAMS                                                         \
    const float* __restrict__ q, const float* __restrict__ k,               \
        const float* __restrict__ v, const float* __restrict__ x,           \
        const float* __restrict__ gamma, float* __restrict__ y,             \
        float* __restrict__ po, float* __restrict__ pm,                     \
        float* __restrict__ ps, int H, int W, int C, int c8, int TC,        \
        int KCH, int NS, int ctiles
#define LINE_ARGS \
    q, k, v, x, gamma, y, po, pm, ps, H, W, C, c8, TC, KCH, NS, ctiles

template <int RQ, int MODE>
__global__ void __launch_bounds__(V_THREADS)
axial_attend_line_kernel(LINE_PARAMS) {
    line_body<RQ, MODE>(LINE_ARGS);
}

// Five or more rows a thread take 85-105 registers uncapped, two blocks an
// SM, and the 80-px maps then run in two waves: these instances are capped
// at three blocks an SM (a few spilled bytes cost less).
template <int RQ, int MODE>
__global__ void __launch_bounds__(V_THREADS, 3)
axial_attend_line_capped_kernel(LINE_PARAMS) {
    line_body<RQ, MODE>(LINE_ARGS);
}
#undef LINE_PARAMS

template <int RP, int RJ>
cudaError_t launch_project(const float* x, const float* wqk, const float* pq,
                           const float* pv, float* q, float* k, float* v,
                           long long npix, int C, int c8, cudaStream_t stream) {
    constexpr int TP = P_TPT * RP, NG = P_TJ * RJ;
    const int ngroups = (2 * c8 + NG - 1) / NG;
    const size_t smem = (size_t)project_smem_floats(C, TP, NG) * sizeof(float);
    auto kernel = axial_project_kernel<RP, RJ>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    dim3 grid((unsigned)((npix + TP - 1) / TP), (unsigned)ngroups);
    kernel<<<grid, P_THREADS, smem, stream>>>(x, wqk, pq, pv, q, k, v, npix,
                                              C, c8);
    return cudaGetLastError();
}

template <int RQ, int MODE>
auto line_kernel() {              // only the instance that launches is built
    if constexpr (RQ >= 5) return axial_attend_line_capped_kernel<RQ, MODE>;
    else return axial_attend_line_kernel<RQ, MODE>;
}

template <int RQ, int MODE>
cudaError_t launch_line(const float* q, const float* k, const float* v,
                        const float* x, const float* gamma, float* y,
                        float* po, float* pm, float* ps, int B, int H, int W,
                        int C, int c8, int TC, int KCH, int NS, int qtiles,
                        cudaStream_t stream) {
    const int ctiles = C / (4 * TC);
    const size_t smem = (size_t)line_smem_floats(c8, TC, RQ, KCH, NS, MODE)
        * sizeof(float);
    auto kernel = line_kernel<RQ, MODE>();
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    dim3 grid((unsigned)(MODE == LINE_ROW ? H : W), (unsigned)B,
              (unsigned)(qtiles * ctiles));
    kernel<<<grid, V_THREADS, smem, stream>>>(LINE_ARGS);
    return cudaGetLastError();
}
#undef LINE_ARGS

}  // namespace

extern "C" long long axial_project_smem(int C, int RP, int RJ) {
    return project_smem_floats(C, P_TPT * RP, P_TJ * RJ)
        * (long long)sizeof(float);
}

// K1 with the tile of project_tile (ops/kernels/axial_attention.py): RP
// pixels and RJ columns a thread (RP 1 or 2, RJ 1 or 2); C % 4 == 0 and x,
// wqk, pv 16-byte aligned: the host checks.
extern "C" int axial_project(const float* x, const float* wqk, const float* pq,
                             const float* pv, float* q, float* k, float* v,
                             long long npix, int C, int c8, int RP, int RJ,
                             cudaStream_t stream) {
    if (npix <= 0) return 0;
    if (C % 4 || c8 < 1) return (int)cudaErrorInvalidValue;
    const int tile = 10 * RP + RJ;
    switch (tile) {
#define K1_CASE(P, R) \
    case 10 * P + R: return (int)launch_project<P, R>( \
        x, wqk, pq, pv, q, k, v, npix, C, c8, stream);
        K1_CASE(1, 1) K1_CASE(1, 2) K1_CASE(2, 1) K1_CASE(2, 2)
#undef K1_CASE
        default: return (int)cudaErrorInvalidValue;
    }
}


extern "C" long long axial_line_smem(int c8, int TC, int RQ, int KCH, int NS,
                                     int mode) {
    return line_smem_floats(c8, TC, RQ, KCH, NS, mode)
        * (long long)sizeof(float);
}

// K2 with the tile of line_tile (ops/kernels/axial_attention.py): mode
// LINE_RAW (vertical), LINE_ROW or LINE_MERGE (criss-cross's two passes,
// launched in that order on one stream); TC channel-float4 threads, RQ
// query pixels a thread, KCH key pixels a chunk, NS chunks in flight,
// qtiles query tiles a line.
extern "C" int axial_line(const float* q, const float* k, const float* v,
                          const float* x, const float* gamma, float* y,
                          float* po, float* pm, float* ps, int B, int H,
                          int W, int C, int c8, int mode, int TC, int RQ,
                          int KCH, int NS, int qtiles, cudaStream_t stream) {
    if (B <= 0 || H <= 0 || W <= 0) return 0;
    if (TC < 1 || V_THREADS % TC || C % (4 * TC) || KCH % 4 || KCH < 4
        || NS < 1 || NS > V_MAX_STAGES || qtiles < 1)
        return (int)cudaErrorInvalidValue;
    switch (10 * mode + RQ) {
#define K2_CASE(M, R) \
    case 10 * M + R: return (int)launch_line<R, M>( \
        q, k, v, x, gamma, y, po, pm, ps, B, H, W, C, c8, TC, KCH, NS, \
        qtiles, stream);
#define K2_MODE(M) K2_CASE(M, 1) K2_CASE(M, 2) K2_CASE(M, 3) K2_CASE(M, 4) \
    K2_CASE(M, 5) K2_CASE(M, 6) K2_CASE(M, 7) K2_CASE(M, 8)
        K2_MODE(LINE_RAW) K2_MODE(LINE_ROW) K2_MODE(LINE_MERGE)
#undef K2_MODE
#undef K2_CASE
        default: return (int)cudaErrorInvalidValue;
    }
}
