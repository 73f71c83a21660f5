// Tangent of a stack of matrix inverses, hand-written for Hopper (sm_90a):
// dX = -X * dA * X, one thread block a matrix.
//
// Replaces no TPU kernel of its own. Under jax.jacfwd the JAX package
// differentiates whatever computes its inverses: on a TPU the pallas_call
// of ops/pallas_gj.py:_gj_kernel through Pallas's JVP rule, which runs the
// tangent in the kernel body. This is the port's counterpart of that JVP:
// given X, the inverse that K1 (csrc/gj_inverse.cu) or K2
// (csrc/gj_blocks.cu) returned for an equilibrated matrix A, and dA, the
// tangent of A, it forms the tangent of the inverse. It serves K1's tangent
// (n = 71 on the LCO core and its initialisation block; 92, 101, 121 on
// other models) and K2's (the particle blocks, n = 10, and the c_e block,
// n = 30). It is kept apart from K1 and K2 so that every primal path stays
// bit for bit as it is; the plain version beside it is
// ops/gj_kernel.py:gj_tangent_plain, with the same association
// -(X * dA) * X.
//
// What bounds it on an H100: 4 n^3 operations a matrix against 3 n^2
// values moved (X and dA read once, dX written once). At n = 71 in float64
// that is 1.43 MFLOP against 121 KB a matrix: some 12 operations a byte,
// under the card's float64 ridge of 20 (67 TFLOP/s on the tensor cores /
// 3.35 TB/s), so bytes bound it; in float32 it is 24 a byte, over the
// ridge of 20 (67 TFLOP/s outside the tensor cores), so operations do. On the estimation path the batch is
// the number of fitted parameters, one or two matrices, so a launch is
// latency: one block on one SM.
//
// Design: 256 threads, a 16 x 16 grid; the matrix is cut into panels of 16
// rows. For each panel, V = X[panel, :] * dA and then dX[panel, :] =
// -V * X, both through shared memory: a 16 x 16 tile of the left operand
// and a 16-row slab of the right one are staged per step of depth 16, and
// thread (r, c) accumulates row r at columns c, c + 16, ... (NQ of them,
// n <= 16 NQ) in registers with full-precision fma, summing k in order.
// V stays in shared memory between the two products. Operands past n are
// staged as zeros, so any n up to K1's limit (176 in float, 128 in double)
// takes the same code. Simple first: no wgmma, no TMA, no cuBLAS.

#include <cuda_runtime.h>

namespace {

constexpr int TY = 16;        // rows of a panel, and of the thread grid
constexpr int TX = 16;        // column groups of the thread grid
constexpr int KT = 16;        // depth of a staged step
constexpr int NT = TY * TX;   // threads of a block

template <typename S, int NQ>
__global__ void __launch_bounds__(NT)
gj_tangent_kernel(const S* __restrict__ X, const S* __restrict__ dA,
                  S* __restrict__ dX, int n) {
    constexpr int NPAD = TX * NQ;
    __shared__ S xs[TY][KT + 1];     // left operand tile (padded row)
    __shared__ S bs[KT][NPAD];       // right operand slab
    __shared__ S vs[TY][NPAD];       // V = X[panel, :] * dA
    const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
    const S* x = X + off;
    const S* da = dA + off;
    S* dx = dX + off;
    const int tid = threadIdx.x;
    const int r = tid / TX, c = tid % TX;

    for (int r0 = 0; r0 < n; r0 += TY) {
        const int row = r0 + r;
        S acc[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[q] = S(0);
        // V = X[panel, :] * dA
        for (int k0 = 0; k0 < n; k0 += KT) {
            {
                const int kk = tid % KT, rr = tid / KT;
                xs[rr][kk] = (r0 + rr < n && k0 + kk < n) ? x[(r0 + rr) * n + k0 + kk] : S(0);
            }
            for (int e = tid; e < KT * NPAD; e += NT) {
                const int kk = e / NPAD, j = e % NPAD;
                bs[kk][j] = (k0 + kk < n && j < n) ? da[(k0 + kk) * n + j] : S(0);
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
                const S a = xs[r][kk];
#pragma unroll
                for (int q = 0; q < NQ; ++q) acc[q] = fma(a, bs[kk][c + TX * q], acc[q]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) vs[r][c + TX * q] = acc[q];
        // dX[panel, :] = -V * X (vs is read only after the next barrier)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[q] = S(0);
        for (int k0 = 0; k0 < n; k0 += KT) {
            for (int e = tid; e < KT * NPAD; e += NT) {
                const int kk = e / NPAD, j = e % NPAD;
                bs[kk][j] = (k0 + kk < n && j < n) ? x[(k0 + kk) * n + j] : S(0);
            }
            __syncthreads();
            const int kmax = n - k0 < KT ? n - k0 : KT;
            for (int kk = 0; kk < kmax; ++kk) {
                const S a = vs[r][k0 + kk];
#pragma unroll
                for (int q = 0; q < NQ; ++q) acc[q] = fma(a, bs[kk][c + TX * q], acc[q]);
            }
            __syncthreads();
        }
        if (row < n) {
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int j = c + TX * q;
                if (j < n) dx[row * n + j] = -acc[q];
            }
        }
    }
}

template <typename S, int NQ>
int launch_nq(const S* X, const S* dA, S* dX, int batch, int n, cudaStream_t stream) {
    gj_tangent_kernel<S, NQ><<<batch, NT, 0, stream>>>(X, dA, dX, n);
    return static_cast<int>(cudaGetLastError());
}

// largest n each element type takes (K1's, ops/gj_kernel.py MAX_N)
template <typename S>
constexpr int max_n() { return sizeof(S) == 4 ? 176 : 128; }

template <typename S>
int launch(const S* X, const S* dA, S* dX, int batch, int n, void* stream_) {
    // launches on the caller's current device (the wrapper makes it X's)
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (n < 1 || n > max_n<S>() || batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 16) return launch_nq<S, 1>(X, dA, dX, batch, n, stream);
    if (n <= 32) return launch_nq<S, 2>(X, dA, dX, batch, n, stream);
    if (n <= 80) return launch_nq<S, 5>(X, dA, dX, batch, n, stream);
    if (n <= 128) return launch_nq<S, 8>(X, dA, dX, batch, n, stream);
    if constexpr (max_n<S>() > 128) return launch_nq<S, 11>(X, dA, dX, batch, n, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int gj_tangent_f32(const float* X, const float* dA, float* dX, int batch, int n,
                   void* stream) {
    return launch<float>(X, dA, dX, batch, n, stream);
}

int gj_tangent_f64(const double* X, const double* dA, double* dX, int batch, int n,
                   void* stream) {
    return launch<double>(X, dA, dX, batch, n, stream);
}

const char* gj_tangent_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
