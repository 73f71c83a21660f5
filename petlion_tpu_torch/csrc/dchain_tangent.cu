// Tangent of the fused nested Schur chain (K3, csrc/dchain.cu), hand-written
// for Hopper (sm_90a): one thread block a cell.
//
// Replaces no TPU kernel of its own. Under jax.jacfwd the JAX package
// differentiates whatever computes its chain: on a TPU the pallas_call of
// ops/pallas_schur.py:_dchain_kernel through Pallas's JVP rule, which runs
// the tangent in the kernel body. This is the port's counterpart of that
// JVP. It takes the permuted core D, its tangent dD and K3's outputs (of
// which it reads each level's invA and AinvB and the core inverse X; each
// level's C it takes from the primal core it holds), and for each level of
// size nk, on the current core [A B; C D22] and its tangent
// [dA dB; dC dD22], forms
//     T1      = invA * dA
//     d invA  = -T1 * invA            (invA is K3's folded inverse, so the
//                                      equilibration scalings drop out)
//     d AinvB = d invA * B + invA * dB
//     dC      (a block of the tangent core)
//     dD     <- dD22 - (dC * AinvB + C * d AinvB)
// and, before the last level, the primal core D <- D22 - C * AinvB (C from
// the core it holds, AinvB from K3), whose C and B blocks the next level
// needs; after the last level, the tangent of the core inverse,
// -(X * dD) * X with X K3's last output. The outputs have K3's shapes, in
// K3's order. The plain version with the same formulas is
// ops/dchain.py:dchain_tangent_plain, and the plain mirror of this order of
// operations is ops/dchain.py:dchain_tangent_mirror.
//
// What bounds it on an H100: per cell it reads D, dD, each level's invA
// and AinvB and X, and writes as many values as K3 does (2 x 71^2 + 3,401
// read and 5,041 written at n = 71 with levels (20, 20): 0.15 MB in
// float64), against the products of the chain twice over (0.70 MFLOP a
// cell on the default mesh): 4.7 operations a byte, under the card's
// float64 ridge of 20 (67 TFLOP/s on the tensor cores / 3.35 TB/s), so
// bytes bound it. On the estimation path the batch is the number of fitted
// parameters, one or two cells, so a launch is latency: about ten
// dependent products, each a barrier apart.
//
// Design: the primal and the tangent core stay in dynamic shared memory
// (row stride padded, 2 n x ldn values) and are updated in place, a level
// at a time; nothing else of the chain is held but the level's invA, AinvB
// and d AinvB (and X for the last step). Each level's T1 lands in the
// primal core's A block and its d invA in the tangent core's A block, both
// dead by then; the core's T1 lands in the primal core's last block. At
// n = 71, levels (20, 20), that is 111,904 B in float64 (two blocks an SM)
// and 55,952 B in float32. Each product spreads over all 256 threads:
// - float64 on the tensor cores (mma.sync.m16n8k8.f64, DMMA): a warp takes
//   a 32 x 16 block of the output, 2 x 2 tiles whose fragments each feed
//   two MMAs (a fragment used once would leave the products bound by
//   shared-memory reads), each output summing the depth eight at a time
//   (each DMMA adds the sum of its eight products), ragged edges clamped
//   and masked; row strides of 4 mod 8 doubles keep the fragment reads free
//   of bank conflicts;
// - float32 on FFMA at full precision: a thread takes a 2 x 4 tile where
//   that leaves at least 128 tiles, else 2 x 2, of rows ti + TI a and
//   columns tj + TJ b (neighbouring threads read neighbouring columns), the
//   depth summed in order, each row's next four values in one 16-byte read
//   where the rows are aligned; tiles this small fit 64 registers a thread,
//   so four float32 blocks share an SM (4 x 4 tiles took 128 and left two).
// The two r x r updates of a level (the tangent's and the primal's) run
// in one pass that shares C and AinvB. The next level's invA (or X) is
// staged with cp.async while the level's update runs, and its AinvB while
// its first three products run. Every output is written once from the
// registers that formed it (dC from the tangent core).

#include <cuda_runtime.h>

#include "tangent_common.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int NT = 256;
constexpr int NW = NT / 32;


template <typename S>
struct Ptrs {
    const S* in[3 * kMaxLevels + 1];   // K3's outputs: per level invA, AinvB, C; X
    S* out[3 * kMaxLevels + 1];        // their tangents, in the same order
};

struct Plan {
    int n;
    int n_levels;
    int sizes[kMaxLevels];
    int ldn;        // row stride of the cores
    int inv_off;    // offsets (elements) of invA / X, AinvB and d AinvB
    int ab_off;
    int dab_off;
};

// Shared layout of a launch (the same sums as ops/dchain.py
// tangent_smem_bytes): the two cores, then invA / X, AinvB, d AinvB.
template <typename S>
__host__ __device__ inline long long plan_layout(Plan& p) {
    const int n = p.n;
    p.ldn = tc::pad_ld(n);
    int m = n, s_inv = 1, s_ab = 1;
    for (int L = 0; L < p.n_levels; ++L) {
        const int nk = p.sizes[L], r = m - nk;
        s_inv = nk * tc::pad_ld(nk) > s_inv ? nk * tc::pad_ld(nk) : s_inv;
        s_ab = nk * tc::pad_ld(r) > s_ab ? nk * tc::pad_ld(r) : s_ab;
        m = r;
    }
    s_inv = m * tc::pad_ld(m) > s_inv ? m * tc::pad_ld(m) : s_inv;
    p.inv_off = 2 * n * p.ldn;
    p.ab_off = p.inv_off + s_inv;
    p.dab_off = p.ab_off + s_ab;
    return static_cast<long long>(p.dab_off + s_ab) * sizeof(S);
}

// ---------------------------------------------------------------------------
// block products: acc = X1 * Y1 (depth K1) [+ X2 * Y2 (depth K2)] over
// M x N outputs, and with DUAL also accp = X2 * Y1 (depth K1); then
// epi(i, j, acc, accp) for every output. Row-major operands with their
// strides. (One out-of-line product function for all call sites, which
// keeps the kernel's code smaller, was tried and was slower.)
// ---------------------------------------------------------------------------

// float64 on DMMA (m16n8k8): a warp takes a 32 x 16 block of the output
// (2 x 2 tiles of 16 x 8, each fragment read from shared memory feeding two
// MMAs), the depth eight at a time. Rows and columns past the edge read the
// last row or column (their results are dropped); a depth that is not a
// multiple of eight ends in one step whose missing terms are zeros.
constexpr int MT = 2, NT8 = 2;   // 16-row and 8-column tiles of a warp's block

// one step at depth k of ac += X * Y (and with PRIM acp += Xp * Y): the
// fragment pointers start at depth t of their rows (xl, xh: rows g and
// g + 8 of each 16-row tile; yc: column g of each 8-column tile, row t).
// TAIL: the last step past K, read in range (clamped), the missing terms
// zero.
template <bool PRIM, bool TAIL>
__device__ __forceinline__ void mma_step64(double (&ac)[MT][NT8][4], double (&acp)[MT][NT8][4],
                                           const double* const (&xl)[MT],
                                           const double* const (&xh)[MT],
                                           const double* const (&pl)[MT],
                                           const double* const (&ph)[MT],
                                           const double* const (&yc)[NT8], int ly, int k,
                                           int K) {
    const int t = threadIdx.x & 3;
    const int o0 = TAIL ? min(k + t, K - 1) - t : k;
    const int o1 = TAIL ? min(k + t + 4, K - 1) - t : k + 4;
    const bool v0 = !TAIL || k + t < K, v1 = !TAIL || k + t + 4 < K;
    double b[NT8][2];
#pragma unroll
    for (int c = 0; c < NT8; ++c) {
        b[c][0] = v0 ? yc[c][o0 * ly] : 0.0;
        b[c][1] = v1 ? yc[c][o1 * ly] : 0.0;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const double a[4] = {v0 ? xl[m][o0] : 0.0, v0 ? xh[m][o0] : 0.0, v1 ? xl[m][o1] : 0.0,
                             v1 ? xh[m][o1] : 0.0};
#pragma unroll
        for (int c = 0; c < NT8; ++c) tc::dmma16x8x8(ac[m][c], a, b[c]);
        if constexpr (PRIM) {
            const double ap[4] = {v0 ? pl[m][o0] : 0.0, v0 ? ph[m][o0] : 0.0,
                                  v1 ? pl[m][o1] : 0.0, v1 ? ph[m][o1] : 0.0};
#pragma unroll
            for (int c = 0; c < NT8; ++c) tc::dmma16x8x8(acp[m][c], ap, b[c]);
        }
    }
}

// ac += X * Y over the depth K (fragment rows rlo, rhi of X, columns col of
// Y); with PRIM also acp += Xp * Y
template <bool PRIM>
__device__ __forceinline__ void mma_run64(double (&ac)[MT][NT8][4], double (&acp)[MT][NT8][4],
                                          const double* X, int lx, const double* Y, int ly,
                                          int K, const double* Xp, int lxp,
                                          const int (&rlo)[MT], const int (&rhi)[MT],
                                          const int (&col)[NT8]) {
    const int t = threadIdx.x & 3;
    const double* xl[MT];
    const double* xh[MT];
    const double* pl[MT];
    const double* ph[MT];
    const double* yc[NT8];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        xl[m] = X + rlo[m] * lx + t;
        xh[m] = X + rhi[m] * lx + t;
        pl[m] = Xp + rlo[m] * lxp + t;
        ph[m] = Xp + rhi[m] * lxp + t;
    }
#pragma unroll
    for (int c = 0; c < NT8; ++c) yc[c] = Y + t * ly + col[c];
    const int kf = K & ~7;
#pragma unroll 2
    for (int k = 0; k < kf; k += 8)
        mma_step64<PRIM, false>(ac, acp, xl, xh, pl, ph, yc, ly, k, K);
    if (kf < K) mma_step64<PRIM, true>(ac, acp, xl, xh, pl, ph, yc, ly, kf, K);
}

template <bool TWO, bool DUAL, typename Epi>
__device__ __forceinline__ void prod64(const double* X1, int lx1, const double* Y1, int ly1,
                                       int K1, const double* X2, int lx2, const double* Y2,
                                       int ly2, int K2, int M, int N, Epi epi) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int tn = (N + 8 * NT8 - 1) / (8 * NT8), tasks = (M + 16 * MT - 1) / (16 * MT) * tn;
    for (int task = warp; task < tasks; task += NW) {
        const int i0 = (task / tn) * 16 * MT, j0 = (task % tn) * 8 * NT8;
        int rlo[MT], rhi[MT], col[NT8];
        double acc[MT][NT8][4], accp[MT][NT8][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            rlo[m] = min(i0 + 16 * m + g, M - 1);
            rhi[m] = min(i0 + 16 * m + g + 8, M - 1);
#pragma unroll
            for (int c = 0; c < NT8; ++c)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][c][e] = accp[m][c][e] = 0.0;
        }
#pragma unroll
        for (int c = 0; c < NT8; ++c) col[c] = min(j0 + 8 * c + g, N - 1);
#ifndef TANGENT_PROBE_NO_PRODUCTS
        mma_run64<DUAL>(acc, accp, X1, lx1, Y1, ly1, K1, DUAL ? X2 : X1, DUAL ? lx2 : lx1, rlo,
                        rhi, col);
        if constexpr (TWO)
            mma_run64<false>(acc, accp, X2, lx2, Y2, ly2, K2, X2, lx2, rlo, rhi, col);
#endif
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = i0 + 16 * m + g + 8 * h;
                if (i >= M) continue;
#pragma unroll
                for (int c = 0; c < NT8; ++c)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int j = j0 + 8 * c + 2 * t + e;
                        if (j < N) epi(i, j, acc[m][c][2 * h + e], accp[m][c][2 * h + e]);
                    }
            }
    }
}

// float32 on FFMA: TM x TN tiles, rows ti + TI a and columns tj + TJ b (a
// warp's neighbouring threads read neighbouring columns), the depth in
// order. With KS = 4 the rows of X1 and X2 are 16-byte aligned and each
// row's next four depth values come in one 16-byte read; a depth that is
// not a multiple of four ends in single steps.
template <int TM, int KS>
__device__ __forceinline__ void rows32(float (&x)[TM][4], const float* const (&xr)[TM], int k) {
#pragma unroll
    for (int a = 0; a < TM; ++a) {
        if constexpr (KS == 4) {
            const float4 v = *reinterpret_cast<const float4*>(xr[a] + k);
            x[a][0] = v.x;
            x[a][1] = v.y;
            x[a][2] = v.z;
            x[a][3] = v.w;
        } else {
            x[a][0] = xr[a][k];
        }
    }
}

// acc += X * Y (and with PRIM accp += Xp * Y) over depths k0 .. k1 - 1, KS at
// a time
template <int TM, int TN, int KS, bool PRIM>
__device__ __forceinline__ void fma_run32(float (&acc)[TM][TN], float (&accp)[TM][TN],
                                          const float* const (&xr)[TM],
                                          const float* const (&pr)[TM],
                                          const float* const (&yc)[TN], int ly, int k0, int k1) {
#pragma unroll 2
    for (int k = k0; k < k1; k += KS) {
        float x[TM][4], xp[TM][4];
        rows32<TM, KS>(x, xr, k);
        if constexpr (PRIM) rows32<TM, KS>(xp, pr, k);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            float y[TN];
#pragma unroll
            for (int b = 0; b < TN; ++b) y[b] = yc[b][(k + kk) * ly];
#pragma unroll
            for (int a = 0; a < TM; ++a)
#pragma unroll
                for (int b = 0; b < TN; ++b) {
                    acc[a][b] = fmaf(x[a][kk], y[b], acc[a][b]);
                    if constexpr (PRIM) accp[a][b] = fmaf(xp[a][kk], y[b], accp[a][b]);
                }
        }
    }
}

// acc += X * Y over the depth K (and with PRIM accp += Xp * Y)
template <int TM, int TN, bool PRIM>
__device__ __forceinline__ void fma_depth32(float (&acc)[TM][TN], float (&accp)[TM][TN],
                                            const float* X, int lx, const float* Y, int ly,
                                            int K, const float* Xp, int lxp,
                                            const int (&ir)[TM], const int (&jc)[TN], bool vec) {
    const float* xr[TM];
    const float* pr[TM];
    const float* yc[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
        xr[a] = X + ir[a] * lx;
        pr[a] = Xp + ir[a] * lxp;
    }
#pragma unroll
    for (int b = 0; b < TN; ++b) yc[b] = Y + jc[b];
    const int k4 = vec ? K & ~3 : 0;
    fma_run32<TM, TN, 4, PRIM>(acc, accp, xr, pr, yc, ly, 0, k4);
    fma_run32<TM, TN, 1, PRIM>(acc, accp, xr, pr, yc, ly, k4, K);
}

template <int TM, int TN, bool TWO, bool DUAL, typename Epi>
__device__ __forceinline__ void prod32(const float* X1, int lx1, const float* Y1, int ly1,
                                       int K1, const float* X2, int lx2, const float* Y2,
                                       int ly2, int K2, int M, int N, Epi epi) {
    const int TI = (M + TM - 1) / TM, TJ = (N + TN - 1) / TN, tiles = TI * TJ;
    // rows 16-byte aligned: the 16-byte reads of X's rows
    const bool vec = ((lx1 | (TWO || DUAL ? lx2 : 0)) & 3) == 0 &&
                     ((reinterpret_cast<size_t>(X1) |
                       reinterpret_cast<size_t>(TWO || DUAL ? X2 : X1)) & 15) == 0;
    for (int tile = threadIdx.x; tile < tiles; tile += NT) {
        const int ti = tile / TJ, tj = tile - ti * TJ;
        int ir[TM], jc[TN];
#pragma unroll
        for (int a = 0; a < TM; ++a) ir[a] = min(ti + TI * a, M - 1);
#pragma unroll
        for (int b = 0; b < TN; ++b) jc[b] = min(tj + TJ * b, N - 1);
        float acc[TM][TN], accp[TM][TN];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
            for (int b = 0; b < TN; ++b) acc[a][b] = accp[a][b] = 0.0f;
#ifndef TANGENT_PROBE_NO_PRODUCTS
        fma_depth32<TM, TN, DUAL>(acc, accp, X1, lx1, Y1, ly1, K1, DUAL ? X2 : X1,
                                  DUAL ? lx2 : lx1, ir, jc, vec);
        if constexpr (TWO)
            fma_depth32<TM, TN, false>(acc, accp, X2, lx2, Y2, ly2, K2, X2, lx2, ir, jc, vec);
#endif
#pragma unroll
        for (int a = 0; a < TM; ++a) {
            const int i = ti + TI * a;
            if (i >= M) continue;
#pragma unroll
            for (int b = 0; b < TN; ++b) {
                const int j = tj + TJ * b;
                if (j < N) epi(i, j, acc[a][b], accp[a][b]);
            }
        }
    }
}

// float32 tiles: 2 x 4 where that leaves at least half the threads a tile,
// else 2 x 2 (small enough for 64 registers a thread: four blocks an SM)
template <typename S, bool TWO, bool DUAL, typename Epi>
__device__ __forceinline__ void product(const S* X1, int lx1, const S* Y1, int ly1, int K1,
                                        const S* X2, int lx2, const S* Y2, int ly2, int K2,
                                        int M, int N, Epi epi) {
    if constexpr (sizeof(S) == 8) {
        prod64<TWO, DUAL>(X1, lx1, Y1, ly1, K1, X2, lx2, Y2, ly2, K2, M, N, epi);
    } else if (((M + 1) / 2) * ((N + 3) / 4) >= NT / 2) {
        prod32<2, 4, TWO, DUAL>(X1, lx1, Y1, ly1, K1, X2, lx2, Y2, ly2, K2, M, N, epi);
    } else {
        prod32<2, 2, TWO, DUAL>(X1, lx1, Y1, ly1, K1, X2, lx2, Y2, ly2, K2, M, N, epi);
    }
}

template <typename S>
__global__ void __launch_bounds__(NT, sizeof(S) == 8 ? 2 : 4)
dchain_tangent_kernel(const S* __restrict__ D, const S* __restrict__ dD, Ptrs<S> p,
                      Plan plan) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n = plan.n, ldn = plan.ldn;
    S* const Mp = reinterpret_cast<S*>(smem_raw);   // primal core, n x ldn
    S* const dM = Mp + n * ldn;                      // tangent core
    S* const INV = Mp + plan.inv_off;                // invA, or X
    S* const AB = Mp + plan.ab_off;                  // AinvB
    S* const DAB = Mp + plan.dab_off;                // d AinvB
    const long long b = blockIdx.x;
    const int NL = plan.n_levels;
    int stamp = 0;
    TANGENT_STAMP(stamp++);

#ifndef TANGENT_PROBE_NO_STAGING
    tc::stage<S, NT>(Mp, ldn, D + b * n * n, n, n, n);
    tc::stage<S, NT>(dM, ldn, dD + b * n * n, n, n, n);
    if (NL > 0) {
        const int nk = plan.sizes[0], r = n - nk;
        tc::stage<S, NT>(INV, tc::pad_ld(nk), p.in[0] + b * nk * nk, nk, nk, nk);
        tc::stage<S, NT>(AB, tc::pad_ld(r), p.in[1] + b * nk * r, r, nk, r);
    } else {
        tc::stage<S, NT>(INV, tc::pad_ld(n), p.in[0] + b * n * n, n, n, n);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
#endif
    __syncthreads();
    TANGENT_STAMP(stamp++);

    int o = 0, m = n;
    for (int L = 0; L < NL; ++L) {
        const int nk = plan.sizes[L], r = m - nk;
        const int ldk = tc::pad_ld(nk), ldr = tc::pad_ld(r);
        S* const Ap = Mp + o * ldn + o;          // primal A block (dead): T1
        S* const Bp = Ap + nk;                   // B
        S* const Cp = Ap + nk * ldn;             // C
        S* const dA = dM + o * ldn + o;          // dA, then d invA
        S* const dB = dA + nk;
        S* const dC = dA + nk * ldn;
        S* const out_dI = p.out[3 * L] + b * nk * nk;
        S* const out_dAB = p.out[3 * L + 1] + b * nk * r;
        S* const out_dC = p.out[3 * L + 2] + b * r * nk;

        // T1 = invA * dA
        product<S, false, false>(INV, ldk, dA, ldn, nk, nullptr, 0, nullptr, 0, 0, nk, nk,
                                 [&](int i, int j, S v, S) { Ap[i * ldn + j] = v; });
        __syncthreads();
        TANGENT_STAMP(stamp++);
        // d invA = -T1 * invA
        product<S, false, false>(Ap, ldn, INV, ldk, nk, nullptr, 0, nullptr, 0, 0, nk, nk,
                                 [&](int i, int j, S v, S) {
                                     dA[i * ldn + j] = -v;
                                     out_dI[i * nk + j] = -v;
                                 });
        __syncthreads();
        TANGENT_STAMP(stamp++);
        // d AinvB = d invA * B + invA * dB; dC out
        product<S, true, false>(dA, ldn, Bp, ldn, nk, INV, ldk, dB, ldn, nk, nk, r,
                                [&](int i, int j, S v, S) {
                                    DAB[i * ldr + j] = v;
                                    out_dAB[i * r + j] = v;
                                });
        for (int e = threadIdx.x; e < r * nk; e += NT) {
            const int i = e / nk, j = e - i * nk;
            out_dC[e] = dC[i * ldn + j];
        }
        __syncthreads();
        TANGENT_STAMP(stamp++);
        // the next level's invA (or X) lands while the update runs
        const int m2 = r - (L + 1 < NL ? plan.sizes[L + 1] : 0);
#ifndef TANGENT_PROBE_NO_STAGING
        if (L + 1 < NL) {
            const int nk2 = plan.sizes[L + 1];
            tc::stage<S, NT>(INV, tc::pad_ld(nk2), p.in[3 * L + 3] + b * nk2 * nk2, nk2, nk2,
                             nk2);
        } else {
            tc::stage<S, NT>(INV, tc::pad_ld(r), p.in[3 * L + 3] + b * r * r, r, r, r);
        }
        tc::cp_async_commit();
        if (L > 0) {            // this level's AinvB
            tc::cp_async_wait<1>();
            __syncthreads();
            TANGENT_STAMP(stamp++);
        }
#endif
        // dD <- dD22 - (dC * AinvB + C * d AinvB); D <- D22 - C * AinvB
        S* const dD22 = dC + nk;
        S* const D22 = Cp + nk;
        if (L + 1 < NL)
            product<S, true, true>(dC, ldn, AB, ldr, nk, Cp, ldn, DAB, ldr, nk, r, r,
                                   [&](int i, int j, S v, S vp) {
                                       dD22[i * ldn + j] -= v;
                                       D22[i * ldn + j] -= vp;
                                   });
        else
            product<S, true, false>(dC, ldn, AB, ldr, nk, Cp, ldn, DAB, ldr, nk, r, r,
                                    [&](int i, int j, S v, S) { dD22[i * ldn + j] -= v; });
        __syncthreads();
        TANGENT_STAMP(stamp++);
#ifndef TANGENT_PROBE_NO_STAGING
        if (L + 1 < NL) {
            const int nk2 = plan.sizes[L + 1];
            tc::stage<S, NT>(AB, tc::pad_ld(m2), p.in[3 * L + 4] + b * nk2 * m2, m2, nk2, m2);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
#endif
        __syncthreads();
        TANGENT_STAMP(stamp++);
        o += nk;
        m = r;
    }
    // the core inverse X: dX = -(X * dD) * X
    const int ldm = tc::pad_ld(m);
    S* const T1 = Mp + o * ldn + o;
    S* const out_dX = p.out[3 * NL] + b * m * m;
    product<S, false, false>(INV, ldm, dM + o * ldn + o, ldn, m, nullptr, 0, nullptr, 0, 0, m,
                             m, [&](int i, int j, S v, S) { T1[i * ldn + j] = v; });
    __syncthreads();
    TANGENT_STAMP(stamp++);
    product<S, false, false>(T1, ldn, INV, ldm, m, nullptr, 0, nullptr, 0, 0, m, m,
                             [&](int i, int j, S v, S) { out_dX[i * m + j] = -v; });
    TANGENT_STAMP(stamp++);
}

template <typename S>
long long smem_of(const int* sizes, int n_levels, int n, Plan& plan) {
    if (n_levels < 0 || n_levels > kMaxLevels || n < 1) return -1;
    plan = Plan{};
    plan.n = n;
    plan.n_levels = n_levels;
    int m = n;
    for (int L = 0; L < n_levels; ++L) {
        if (sizes[L] < 1 || sizes[L] >= m) return -1;
        plan.sizes[L] = sizes[L];
        m -= sizes[L];
    }
    return plan_layout<S>(plan);
}

template <typename S>
int launch(const S* D, const S* dD, const S* const* ptrs, const int* sizes, int n_levels,
           int batch, int n, void* stream_) {
    // launches on the caller's current device (the wrapper makes it D's)
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    Plan plan;
    const long long smem = smem_of<S>(sizes, n_levels, n, plan);
    if (smem < 0 || smem > tc::kMaxSmem || batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Ptrs<S> p{};
    const int k = 3 * n_levels + 1;
    for (int i = 0; i < k; ++i) {
        p.in[i] = ptrs[i];
        p.out[i] = const_cast<S*>(ptrs[k + i]);
    }
    static unsigned long long opted = 0;
    auto kernel = dchain_tangent_kernel<S>;
    const cudaError_t err = tc::smem_opt_in(kernel, static_cast<size_t>(smem), opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<batch, NT, static_cast<size_t>(smem), stream>>>(D, dD, p, plan);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

TANGENT_PROBE_EXPORT

extern "C" {

// ptrs: K3's 3 * n_levels + 1 outputs, then their tangents (one host array
// of device pointers); sizes: n_levels ints
int dchain_tangent_f32(const float* D, const float* dD, const float* const* ptrs,
                       const int* sizes, int n_levels, int batch, int n, void* stream) {
    return launch<float>(D, dD, ptrs, sizes, n_levels, batch, n, stream);
}

int dchain_tangent_f64(const double* D, const double* dD, const double* const* ptrs,
                       const int* sizes, int n_levels, int batch, int n, void* stream) {
    return launch<double>(D, dD, ptrs, sizes, n_levels, batch, n, stream);
}

// shared memory of one block (bytes), or -1 where the sizes do not fit n
long long dchain_tangent_smem(int f64, const int* sizes, int n_levels, int n) {
    Plan plan;
    return f64 ? smem_of<double>(sizes, n_levels, n, plan)
               : smem_of<float>(sizes, n_levels, n, plan);
}

const char* dchain_tangent_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
