// Batched pivot-free Gauss-Jordan inverse, hand-written for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_gj.py:_gj_kernel (reached through
// gj_inverse_pallas / gj_inverse_hot), the TPU kernel that inverts the 71x71
// Schur core of every Newton factorisation and the 71x71 algebraic block of
// every consistent-initialisation iteration. Callers equilibrate rows and
// columns first; the matrices are diagonally dominant, so no pivoting.
//
// What bounds it on an H100: the work per matrix is 2n^3 flops (0.73 GFLOP
// at B=1024, n=71: 11 us at the 67 TFLOP/s FP32 peak) against 2*B*n^2*4
// bytes of input and output (41 MB: 12 us at 3.35 TB/s), so the floor is the
// memory bound, with compute close behind. A pivot loop is sequential,
// though: n steps, each a rank-1 update that depends on the previous one.
//
// Design: one thread block per matrix. The augmented [A | I] (n x 2n, 40 KB
// in f32 at n=71) lives in dynamic shared memory for the whole elimination,
// so device memory sees one read of A and one write of A^-1, as on the TPU.
// Each pivot step has two phases separated by __syncthreads: (1) save the
// pivot column and the normalised pivot row, (2) the rank-1 update. Only the
// n+1 columns k..n+k can change at step k (columns left of k are already unit
// vectors and the identity columns right of n+k are untouched), so phase 2
// skips the others; the skipped updates are exact no-ops, which keeps the
// arithmetic equal to the plain version's. No identity padding: that was a
// TPU tiling device. Many blocks per SM (40 KB each) hide the sync latency.
// Simple first: no wgmma, no TMA.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_inverse_kernel(const T* __restrict__ A, T* __restrict__ out, int n) {
    extern __shared__ unsigned char smem_raw[];
    T* M = reinterpret_cast<T*>(smem_raw);   // n x 2n, row-major, ld = 2n
    T* colk = M + 2 * n * n;                 // saved pivot column (n)
    T* rowk = colk + n;                      // normalised pivot row (n + 1)
    const int ld = 2 * n;
    const int nn = n * n;
    const T* a = A + static_cast<size_t>(blockIdx.x) * nn;
    T* o = out + static_cast<size_t>(blockIdx.x) * nn;

    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        M[i * ld + j] = a[idx];
        M[i * ld + n + j] = (i == j) ? T(1) : T(0);
    }
    __syncthreads();

    const int w = n + 1;  // active columns k .. n+k
    for (int k = 0; k < n; ++k) {
        const T piv = M[k * ld + k];
        for (int idx = threadIdx.x; idx < n + w; idx += blockDim.x) {
            if (idx < n) {
                colk[idx] = M[idx * ld + k];
            } else {
                const int jj = idx - n;
                rowk[jj] = M[k * ld + k + jj] / piv;
            }
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < n * w; idx += blockDim.x) {
            const int i = idx / w, jj = idx - i * w;
            const T r = rowk[jj];
            T* m = &M[i * ld + k + jj];
            *m = (i == k) ? r : *m - colk[i] * r;
        }
        __syncthreads();
    }

    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
        const int i = idx / n, j = idx - i * n;
        o[idx] = M[i * ld + n + j];
    }
}

template <typename T>
int launch(const T* A, T* out, int batch, int n, void* stream) {
    // launches on the caller's current device (the wrapper makes it A's)
    const size_t smem = (2 * static_cast<size_t>(n) * n + 2 * n + 1) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(gj_inverse_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    gj_inverse_kernel<T><<<batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(A, out, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gj_inverse_f32(const float* A, float* out, int batch, int n, void* stream) {
    return launch<float>(A, out, batch, n, stream);
}

int gj_inverse_f64(const double* A, double* out, int batch, int n,
                   void* stream) {
    return launch<double>(A, out, batch, n, stream);
}

const char* gj_inverse_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
