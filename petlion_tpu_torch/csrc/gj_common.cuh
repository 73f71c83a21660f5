// Register-tiled, block-level pivot-free Gauss-Jordan inverse, shared by
// gj_inverse.cu (K1) and dchain.cu (K3, for a level or rest larger than 32).
//
// The matrix (m x m, m <= T*P) is held in registers for the whole
// elimination: thread (ty, tx) of a T x T thread grid owns rows ty + T*a and
// columns tx + T*b, a, b < P, of the matrix padded to T*P with the identity.
// The padding is a separate diagonal block, so it changes nothing in the m x m
// inverse.
//
// The inverse is formed in place (no [A | I]), eight pivots at a time, as
// the JAX package's TPU kernel does (pallas_gj.py, BS = 8). For the pivot
// set K = c0 .. c0+7, with the raw pivot rows A_K* and columns A_*K:
//     P    = inverse of the 8 x 8 pivot block (scalar in-place Gauss-Jordan)
//     R    = P A_K*                 the normalised pivot rows
//     a_ij <- a_ij - sum_t a_it R_tj for i, j outside K (one rounding of the
//                                   8-term sum, as the blocked form's matmul)
//     A_K* <- R,  A_*K <- -A_*K P,  A_KK <- P
// This keeps n x n state instead of n x 2n. On the Newton cores of the main
// path (condition ~4e10 after equilibration) the eight-wide blocks are 3-7x
// more accurate in float32 than the scalar rank-1 loop. The plain mirror of
// this order of operations is ops/gj_kernel.py:gj_inverse_inplace (bs = 8;
// the kernel fuses the sums into fma chains, the mirror rounds products and
// sums apart).
//
// Two barriers per eight pivots: (i) the owners of the pivot rows and columns
// write them to shared memory; barrier; (ii) every warp inverts the 8 x 8
// pivot block on its own (lane r holds row r, pivots broadcast by shuffles)
// and (iii) the owners of the pivot rows form R; barrier; (iv) every thread
// updates its tile from its rows of A_*K and its columns of R, read as
// contiguous 8-vectors. The pivot columns are double-buffered, so the next
// block's (i) never overwrites what a slower thread still reads in (iv); the
// raw rows, R and the warp's P are read only before the barrier that follows.
//
// The loop over pivot blocks is not unrolled, so the kernel's code stays
// small enough for the instruction cache: the tile slot that holds the pivot
// rows and columns (a = b = pp) is a runtime value, picked from the register
// tile by selects. No element update divides or takes a modulo.

#pragma once

#include <cuda_runtime.h>

namespace gjc {

constexpr int BS = 8;   // pivots per block
// row stride of the shared pivot rows and columns: 12 elements (48 bytes in
// f32), so the 16-byte reads of eight neighbouring threads hit distinct banks
constexpr int LD = 12;

// shared elements tile_gj needs: raw pivot rows, two buffers of pivot
// columns, normalised pivot rows (each T*P rows of stride LD) and one 8 x 8
// P per warp
template <int T, int P>
__host__ __device__ constexpr int smem_elems() {
    return 4 * T * P * LD + (T * T / 32) * BS * BS;
}

// 1/x, correctly rounded (the same value as S(1) / x, without the division)
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// eight contiguous values from shared memory (16-byte aligned)
template <typename S>
__device__ __forceinline__ void ld8(S (&x)[BS], const S* p) {
    if constexpr (sizeof(S) == 4) {
        const float4 u = reinterpret_cast<const float4*>(p)[0];
        const float4 w = reinterpret_cast<const float4*>(p)[1];
        x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
        x[4] = w.x; x[5] = w.y; x[6] = w.z; x[7] = w.w;
    } else {
#pragma unroll
        for (int t = 0; t < BS; t += 2) {
            const double2 u = reinterpret_cast<const double2*>(p)[t / 2];
            x[t] = u.x;
            x[t + 1] = u.y;
        }
    }
}

// Load the m x m matrix at src (row stride ld) into the tile; identity
// outside.
template <typename S, int T, int P>
__device__ __forceinline__ void tile_load(S (&v)[P][P], const S* src, int ld,
                                          int m, int ty, int tx) {
#pragma unroll
    for (int a = 0; a < P; ++a) {
        const int i = ty + T * a;
#pragma unroll
        for (int b = 0; b < P; ++b) {
            const int j = tx + T * b;
            v[a][b] = (i < m && j < m) ? src[i * ld + j] : S(i == j ? 1 : 0);
        }
    }
}

// Store the m x m part of the tile at dst (row stride ld).
template <typename S, int T, int P>
__device__ __forceinline__ void tile_store(const S (&v)[P][P], S* dst, int ld,
                                           int m, int ty, int tx) {
#pragma unroll
    for (int a = 0; a < P; ++a) {
        const int i = ty + T * a;
#pragma unroll
        for (int b = 0; b < P; ++b) {
            const int j = tx + T * b;
            if (i < m && j < m) dst[i * ld + j] = v[a][b];
        }
    }
}

// In place: the tile's m x m matrix becomes its inverse. Every thread of the
// block (exactly T*T of them, T a multiple of 8) calls it; sm holds
// smem_elems<T, P>() elements of shared memory, 16-byte aligned. Shared
// memory is free again after the caller's next barrier.
template <typename S, int T, int P>
__device__ void tile_gj(S (&v)[P][P], int m, S* sm, int ty, int tx) {
    constexpr int NP = T * P;
    constexpr int H = T / BS;                    // pivot blocks per tile slot
    // tile rows a group in (iv): more rows, fewer reloads of R, more registers
    constexpr int G = (sizeof(S) == 8 || P <= 4) ? 1 : T == 8 ? 3 : 2;
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    S* rt = sm;                                  // raw pivot rows, [column][t]
    S* cb = rt + NP * LD;                        // raw pivot columns, 2 x [row][t]
    S* rn = cb + 2 * NP * LD;                    // R, [column][t]
    S* pw = rn + NP * LD + (threadIdx.x >> 5) * BS * BS;   // this warp's P, [t][u]

    for (int kb = 0; kb * BS < m; ++kb) {
        const int pp = kb / H, h = kb % H;       // slot and half: H is 1 or 2
        const int c0 = BS * kb;
        S* cq = cb + (kb & 1) * NP * LD;
        const int s = ty - BS * h, s2 = tx - BS * h;
        const bool prow = static_cast<unsigned>(s) < BS;   // owns pivot row c0+s
        const bool pcol = static_cast<unsigned>(s2) < BS;  // owns pivot column c0+s2
        const int sc = prow ? s : 0, s2c = pcol ? s2 : 0;

        // (i) publish the raw pivot rows and columns (slot pp, picked by
        // selects: a register array takes no runtime index)
        if (prow) {
#pragma unroll
            for (int b = 0; b < P; ++b) {
                S x = v[0][b];
#pragma unroll
                for (int a = 1; a < P; ++a) x = (a == pp) ? v[a][b] : x;
                rt[(tx + T * b) * LD + s] = x;
            }
        }
        if (pcol) {
#pragma unroll
            for (int a = 0; a < P; ++a) {
                S x = v[a][0];
#pragma unroll
                for (int b = 1; b < P; ++b) x = (b == pp) ? v[a][b] : x;
                cq[(ty + T * a) * LD + s2] = x;
            }
        }
        __syncthreads();

        // (ii) P: every warp inverts the pivot block, lane r & 7 row r
        {
            const int r = lane & (BS - 1);
            S x[BS];
#pragma unroll
            for (int t = 0; t < BS; ++t) x[t] = rt[(c0 + t) * LD + r];
#pragma unroll
            for (int k = 0; k < BS; ++k) {
                const S p = rcp(__shfl_sync(full, x[k], k));
                const S c = x[k];
#pragma unroll
                for (int j = 0; j < BS; ++j) {
                    const S rk = __shfl_sync(full, x[j], k) * p;
                    x[j] = (r == k) ? rk : x[j] - c * rk;
                }
                x[k] = (r == k) ? p : -c * p;
            }
            if (lane < BS) {
#pragma unroll
                for (int t = 0; t < BS; ++t) pw[lane * BS + t] = x[t];
            }
            __syncwarp();
        }

        // (iii) R = P * raw pivot rows, by the owners of the pivot rows
        if (prow) {
            S pr[BS];
            ld8(pr, pw + s * BS);
#pragma unroll
            for (int b = 0; b < P; ++b) {
                S col[BS];
                ld8(col, rt + (tx + T * b) * LD);
                S acc = S(0);
#pragma unroll
                for (int t = 0; t < BS; ++t) acc += pr[t] * col[t];
                rn[(tx + T * b) * LD + s] = acc;
            }
        }
        __syncthreads();

        // (iv) the update, G tile rows at a time: a_ij - sum_t a_it R_tj,
        // R in the pivot rows, P in the pivot block, -A_*K P in the pivot
        // columns
        const S pv = pw[sc * BS + s2c];
#pragma unroll
        for (int a0 = 0; a0 < P; a0 += G) {
            S crow[G][BS], e[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                if (a0 + g >= P) break;
                ld8(crow[g], cq + (ty + T * (a0 + g)) * LD);
                e[g] = S(0);
#pragma unroll
                for (int t = 0; t < BS; ++t) e[g] += crow[g][t] * pw[t * BS + s2c];
            }
#pragma unroll
            for (int b = 0; b < P; ++b) {
                S rc[BS];
                ld8(rc, rn + (tx + T * b) * LD);
                const S rb = rn[(tx + T * b) * LD + sc];
                const bool colk = pcol && b == pp;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const int a = a0 + g;
                    if (a >= P) break;
                    S d = S(0);
#pragma unroll
                    for (int t = 0; t < BS; ++t) d += crow[g][t] * rc[t];
                    const S upd = colk ? -e[g] : v[a][b] - d;
                    v[a][b] = (prow && a == pp) ? (colk ? pv : rb) : upd;
                }
            }
        }
    }
}

}  // namespace gjc
