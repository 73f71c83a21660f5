// Tangent of the fused nested Schur chain (K3, csrc/dchain.cu), hand-written
// for Hopper (sm_90a): one thread block a cell.
//
// Replaces no TPU kernel of its own. Under jax.jacfwd the JAX package
// differentiates whatever computes its chain: on a TPU the pallas_call of
// ops/pallas_schur.py:_dchain_kernel through Pallas's JVP rule, which runs
// the tangent in the kernel body. This is the port's counterpart of that
// JVP. It takes the permuted core D, its tangent dD and K3's outputs (of
// which it reads each level's invA and AinvB and the core inverse X; each
// level's C it takes from the primal core it holds), and for each level of size nk, on the current core [A B; C D22] and its
// tangent [dA dB; dC dD22], forms
//     d invA  = -invA * dA * invA     (invA is K3's folded inverse, so the
//                                      equilibration scalings drop out)
//     d AinvB = d invA * B + invA * dB
//     dC      (a block of the tangent core)
//     dD     <- dD22 - (dC * AinvB + C * d AinvB)
// and the primal core D <- D22 - C * AinvB (C from the core it holds,
// AinvB from K3), whose C and B blocks the next level needs; after the
// last level, the tangent of the core inverse, -X * dD * X with X K3's
// last output. The outputs have K3's shapes, in K3's order. The plain
// version with the same formulas is ops/dchain.py:dchain_tangent_plain.
//
// What bounds it on an H100: per cell it reads D, dD, each level's invA
// and AinvB and X, and writes as many values as K3 does (2 x 71^2 + 3,401
// read and 5,041 written at n = 71 with levels (20, 20): 0.15 MB in
// float64), against the products of the chain twice over (0.70 MFLOP a
// cell on the default mesh): 4.7 operations a byte, under the card's
// float64 ridge of 20 (67 TFLOP/s on the tensor cores / 3.35 TB/s), so
// bytes bound it. On the estimation path the batch is the number of fitted
// parameters, one or two cells, so a launch is latency.
//
// Design: the primal and the tangent core stay in dynamic shared memory
// through every level (2 n^2 values: 79 KB at n = 71 in float64); each
// level's invA and AinvB are staged from K3's outputs, the products spread
// over the block's 256 threads in 4 x 4 register tiles with full-precision
// fma (k summed in order), and each output is written once, a row per warp.
// Simple first: no wgmma, no TMA, no cuBLAS.

#include <cuda_runtime.h>

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
    int s1;     // largest nk^2 over the levels and the rest's m^2
    int s2;     // largest nk * (m - nk) over the levels (at least 1)
};

// Z = Z0 + sign * (X1 * Y1 [+ X2 * Y2]) over M x N outputs, depths K1 and
// K2, row-major operands with their strides (Z0 may be Z: each output reads
// only its own old value). X2 null: one product. Z0 null: Z0 = 0.
template <typename S>
__device__ void gemm(const S* X1, int ldx1, const S* Y1, int ldy1, int K1,
                     const S* X2, int ldx2, const S* Y2, int ldy2, int K2,
                     int M, int N, S sign, const S* Z0, int ld0, S* Z, int ldz) {
    const int tiles_j = (N + 3) >> 2, tiles = ((M + 3) >> 2) * tiles_j;
    for (int idx = threadIdx.x; idx < tiles; idx += NT) {
        const int ti = idx / tiles_j, tj = idx - ti * tiles_j;
        const int i0 = 4 * ti, j0 = 4 * tj;
        int ir[4], jc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ir[a] = min(i0 + a, M - 1);
#pragma unroll
        for (int b = 0; b < 4; ++b) jc[b] = min(j0 + b, N - 1);
        S acc[4][4] = {};
        for (int k = 0; k < K1; ++k) {
            S x[4], y[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) x[a] = X1[ir[a] * ldx1 + k];
#pragma unroll
            for (int b = 0; b < 4; ++b) y[b] = Y1[k * ldy1 + jc[b]];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) acc[a][b] = fma(x[a], y[b], acc[a][b]);
        }
        if (X2 != nullptr) {
            for (int k = 0; k < K2; ++k) {
                S x[4], y[4];
#pragma unroll
                for (int a = 0; a < 4; ++a) x[a] = X2[ir[a] * ldx2 + k];
#pragma unroll
                for (int b = 0; b < 4; ++b) y[b] = Y2[k * ldy2 + jc[b]];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b) acc[a][b] = fma(x[a], y[b], acc[a][b]);
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            if (i0 + a >= M) break;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                if (j0 + b >= N) break;
                const S z0 = Z0 != nullptr ? Z0[(i0 + a) * ld0 + j0 + b] : S(0);
                Z[(i0 + a) * ldz + j0 + b] = z0 + sign * acc[a][b];
            }
        }
    }
}

// rows x cols from src (stride lds) to dst (stride ldd), a row per warp
template <typename S>
__device__ __forceinline__ void copy_block(const S* src, int lds, int rows, int cols,
                                     S* dst, int ldd) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < rows; i += NW)
        for (int j = lane; j < cols; j += 32) dst[i * ldd + j] = src[i * lds + j];
}

template <typename S>
__global__ void __launch_bounds__(NT)
dchain_tangent_kernel(const S* __restrict__ D, const S* __restrict__ dD, Ptrs<S> p,
                      Plan plan) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n = plan.n;
    S* Dm = reinterpret_cast<S*>(smem_raw);   // primal core, n x n, stride n
    S* dM = Dm + n * n;                       // tangent core
    S* inv = dM + n * n;                      // invA (or X), s1
    S* T1 = inv + plan.s1;                    // invA * dA (or X * dD), s1
    S* dI = T1 + plan.s1;                     // d invA, s1
    S* AB = dI + plan.s1;                     // AinvB, s2
    S* dX = AB + plan.s2;                     // d AinvB, s2
    const long long b = blockIdx.x;
    const S one = S(1), minus = S(-1);

    copy_block(D + b * n * n, n, n, n, Dm, n);
    copy_block(dD + b * n * n, n, n, n, dM, n);
    __syncthreads();

    int o = 0, m = n;
    for (int L = 0; L < plan.n_levels; ++L) {
        const int nk = plan.sizes[L], r = m - nk;
        S* A = Dm + o * n + o;                // current core, stride n
        S* dA = dM + o * n + o;
        copy_block(p.in[3 * L] + b * nk * nk, nk, nk, nk, inv, nk);
        copy_block(p.in[3 * L + 1] + b * nk * r, r, nk, r, AB, r);
        __syncthreads();
        // T1 = invA * dA; d invA = -T1 * invA
        gemm<S>(inv, nk, dA, n, nk, nullptr, 0, nullptr, 0, 0, nk, nk, one,
                nullptr, 0, T1, nk);
        __syncthreads();
        gemm<S>(T1, nk, inv, nk, nk, nullptr, 0, nullptr, 0, 0, nk, nk, minus,
                nullptr, 0, dI, nk);
        __syncthreads();
        // d AinvB = d invA * B + invA * dB
        gemm<S>(dI, nk, A + nk, n, nk, inv, nk, dA + nk, n, nk, nk, r, one,
                nullptr, 0, dX, r);
        __syncthreads();
        copy_block(dI, nk, nk, nk, p.out[3 * L] + b * nk * nk, nk);
        copy_block(dX, r, nk, r, p.out[3 * L + 1] + b * nk * r, r);
        copy_block(dA + nk * n, n, r, nk, p.out[3 * L + 2] + b * r * nk, nk);
        // dD <- dD22 - (dC * AinvB + C * d AinvB); D <- D22 - C * AinvB
        gemm<S>(dA + nk * n, n, AB, r, nk, A + nk * n, n, dX, r, nk, r, r, minus,
                dA + nk * n + nk, n, dA + nk * n + nk, n);
        if (L + 1 < plan.n_levels)
            gemm<S>(A + nk * n, n, AB, r, nk, nullptr, 0, nullptr, 0, 0, r, r, minus,
                    A + nk * n + nk, n, A + nk * n + nk, n);
        __syncthreads();
        o += nk;
        m = r;
    }
    // the core inverse X: dX = -(X * dD) * X
    const int L = plan.n_levels;
    copy_block(p.in[3 * L] + b * m * m, m, m, m, inv, m);
    __syncthreads();
    gemm<S>(inv, m, dM + o * n + o, n, m, nullptr, 0, nullptr, 0, 0, m, m, one,
            nullptr, 0, T1, m);
    __syncthreads();
    gemm<S>(T1, m, inv, m, m, nullptr, 0, nullptr, 0, 0, m, m, minus, nullptr, 0,
            dI, m);
    __syncthreads();
    copy_block(dI, m, m, m, p.out[3 * L] + b * m * m, m);
}

template <typename S>
int launch(const S* D, const S* dD, const S* const* ins, S* const* outs,
           const int* sizes, int n_levels, int batch, int n, void* stream_) {
    // launches on the caller's current device (the wrapper makes it D's)
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (n_levels < 0 || n_levels > kMaxLevels || n < 1 || batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Plan plan{};
    plan.n = n;
    plan.n_levels = n_levels;
    int m = n, s1 = 1, s2 = 1;
    for (int L = 0; L < n_levels; ++L) {
        const int nk = sizes[L];
        if (nk < 1 || nk >= m) return static_cast<int>(cudaErrorInvalidValue);
        plan.sizes[L] = nk;
        s1 = nk * nk > s1 ? nk * nk : s1;
        s2 = nk * (m - nk) > s2 ? nk * (m - nk) : s2;
        m -= nk;
    }
    s1 = m * m > s1 ? m * m : s1;
    plan.s1 = s1;
    plan.s2 = s2;
    Ptrs<S> p{};
    for (int i = 0; i < 3 * n_levels + 1; ++i) {
        p.in[i] = ins[i];
        p.out[i] = outs[i];
    }
    const size_t smem = (2 * static_cast<size_t>(n) * n + 3 * s1 + 2 * s2) * sizeof(S);
    auto kernel = dchain_tangent_kernel<S>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<batch, NT, smem, stream>>>(D, dD, p, plan);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ins: K3's 3 * n_levels + 1 outputs, outs: their tangents (host arrays of
// device pointers); sizes: n_levels ints
int dchain_tangent_f32(const float* D, const float* dD, const float* const* ins,
                       float* const* outs, const int* sizes, int n_levels, int batch,
                       int n, void* stream) {
    return launch<float>(D, dD, ins, outs, sizes, n_levels, batch, n, stream);
}

int dchain_tangent_f64(const double* D, const double* dD, const double* const* ins,
                       double* const* outs, const int* sizes, int n_levels, int batch,
                       int n, void* stream) {
    return launch<double>(D, dD, ins, outs, sizes, n_levels, batch, n, stream);
}

const char* dchain_tangent_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
