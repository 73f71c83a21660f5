// Batched pivot-free Gauss-Jordan inverses of stacks of small matrices,
// hand-written for Hopper (sm_90a): one warp per matrix, several matrices per
// thread block.
//
// Replaces: the JAX package's ops/pallas_gj.py:_gj_kernel as reached through
// gj_inverse_hot_blocks (the (B, m, n, n) stack flattened to B*m matrices,
// batch tile _blocks_tile(n)). In the nested Schur factorisation these are
// the per-group inverses: 20 cathode and 20 anode particle blocks (10x10)
// and the c_e block (30x30) of every cell. Callers equilibrate rows and
// columns first; the blocks are c0*I minus a diffusion operator (diagonally
// dominant), so no pivoting.
//
// What bounds it on an H100: each matrix is read once and its inverse written
// once. At (10240, 10, 10) in f32 that is 8.2 MB (2.4 us at 3.35 TB/s) against
// 2*n^3 = 2,000 flops per matrix (20 MFLOP: 0.3 us at 67 TFLOP/s), so bytes
// bound it; at these sizes the launch itself (a few us) dominates.
//
// Design: a 10x10 matrix is 400 bytes, so one 256-thread block per matrix (as
// K1 does at n = 71) would leave almost every thread idle. Here a warp owns a
// matrix: [A | I] (n x 2n, row stride 2n+1 so that the lanes' column accesses
// fall in distinct banks) sits in the warp's slice of dynamic shared memory,
// and lane i owns row i (n <= 32). Each pivot step k has two phases separated
// by __syncwarp: (1) the lanes write the normalised pivot row for the n+1
// columns k..n+k that can change; (2) lane i applies the rank-1 update to its
// row (lane k writes the normalised row). Columns left of k are already unit
// vectors and identity columns right of n+k are untouched, so skipping them
// is exact and the arithmetic is the plain scalar Gauss-Jordan's. No block-
// wide barrier: the warps of a block never wait for one another. Simple
// first: no wgmma, no TMA.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // matrices per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 32;                 // one row per lane

__host__ __device__ inline int row_stride(int n) { return 2 * n + 1; }

// shared memory of one warp's matrix: [A | I] plus the pivot row (n + 1)
__host__ __device__ inline int warp_smem_elems(int n) {
    return n * row_stride(n) + n + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_blocks_kernel(const T* __restrict__ A, T* __restrict__ out, int count,
                 int n) {
    extern __shared__ unsigned char smem_raw[];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const long long mat = static_cast<long long>(blockIdx.x) * kWarps + warp;
    if (mat >= count) return;   // whole warps only; no block-wide barrier below
    const int ld = row_stride(n);
    const int nn = n * n;
    T* M = reinterpret_cast<T*>(smem_raw) + warp * warp_smem_elems(n);
    T* rowk = M + n * ld;
    const T* a = A + mat * nn;
    T* o = out + mat * nn;

    for (int idx = lane; idx < nn; idx += 32) {
        const int i = idx / n, j = idx - i * n;
        M[i * ld + j] = a[idx];
        M[i * ld + n + j] = (i == j) ? T(1) : T(0);
    }
    __syncwarp();

    for (int k = 0; k < n; ++k) {
        const T piv = M[k * ld + k];
        for (int jj = lane; jj <= n; jj += 32) {
            rowk[jj] = M[k * ld + k + jj] / piv;
        }
        __syncwarp();
        if (lane < n) {
            T* m = M + lane * ld + k;
            const T c = m[0];
            if (lane == k) {
                for (int jj = 0; jj <= n; ++jj) m[jj] = rowk[jj];
            } else {
                for (int jj = 0; jj <= n; ++jj) m[jj] = m[jj] - c * rowk[jj];
            }
        }
        __syncwarp();
    }

    for (int idx = lane; idx < nn; idx += 32) {
        const int i = idx / n, j = idx - i * n;
        o[idx] = M[i * ld + n + j];
    }
}

template <typename T>
int launch(const T* A, T* out, int count, int n, void* stream) {
    // launches on the caller's current device (the wrapper makes it A's)
    if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(kWarps) * warp_smem_elems(n) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(gj_blocks_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int blocks = (count + kWarps - 1) / kWarps;
    gj_blocks_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, out, count, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gj_blocks_f32(const float* A, float* out, int count, int n, void* stream) {
    return launch<float>(A, out, count, n, stream);
}

int gj_blocks_f64(const double* A, double* out, int count, int n,
                  void* stream) {
    return launch<double>(A, out, count, n, stream);
}

const char* gj_blocks_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
