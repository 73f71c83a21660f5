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
// though: n steps, each an update that depends on the previous one, so what
// limits a simple kernel is instruction issue and barrier latency.
//
// Design: one thread block per matrix, the matrix in registers (gj_common.cuh:
// a T x T thread grid, each thread a P x P tile, the in-place Gauss-Jordan
// inverse eight pivots at a time with two barriers per eight pivots and no
// divide or modulo in the loop). Device memory sees one read of A and one
// write of A^-1. Tile shapes are compile-time; the launch picks the smallest
// that holds n. At n = 71 (T = 8, P = 9: 64 threads, 81 values a thread) a
// block takes 223 registers a thread and 14 KB of shared memory, so 4 blocks
// fit on an SM and 1024 matrices run in two waves. Capped at 128 registers
// for one wave, the tile spilled and the kernel ran 1.5x slower (PERF.md).
// Simple first: no wgmma (its f32 path is TF32), no TMA.

#include <cuda_runtime.h>

#include "gj_common.cuh"

namespace {

// float at T = 8 asks for 4 blocks an SM (at most 255 registers a thread)
template <typename S, int T>
__host__ __device__ constexpr int min_blocks() {
    return (sizeof(S) == 4 && T == 8) ? 4 : 1;
}

template <typename S, int T, int P>
__global__ void __launch_bounds__(T * T, min_blocks<S, T>())
gj_inverse_kernel(const S* __restrict__ A, S* __restrict__ out, int n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    S* sm = reinterpret_cast<S*>(smem_raw);   // gjc::smem_elems<T, P>()
    const int ty = threadIdx.x / T, tx = threadIdx.x % T;
    const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
    S v[P][P];
    gjc::tile_load<S, T, P>(v, A + off, n, n, ty, tx);
    gjc::tile_gj<S, T, P>(v, n, sm, ty, tx);
    gjc::tile_store<S, T, P>(v, out + off, n, n, ty, tx);
}

template <typename S, int T, int P>
int launch_tile(const S* A, S* out, int batch, int n, cudaStream_t stream) {
    const size_t smem = gjc::smem_elems<T, P>() * sizeof(S);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            gj_inverse_kernel<S, T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    gj_inverse_kernel<S, T, P><<<batch, T * T, smem, stream>>>(A, out, n);
    return static_cast<int>(cudaGetLastError());
}

// largest n each element type takes (ops/gj_kernel.py MAX_N)
template <typename S>
constexpr int max_n() { return sizeof(S) == 4 ? 176 : 128; }

template <typename S>
int launch(const S* A, S* out, int batch, int n, void* stream_) {
    // launches on the caller's current device (the wrapper makes it A's)
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (n < 1 || n > max_n<S>() || batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 16) return launch_tile<S, 8, 2>(A, out, batch, n, stream);
    if (n <= 40) return launch_tile<S, 8, 5>(A, out, batch, n, stream);
    if (n <= 72) return launch_tile<S, 8, 9>(A, out, batch, n, stream);
    if (n <= 128) return launch_tile<S, 16, 8>(A, out, batch, n, stream);
    if constexpr (max_n<S>() > 128)
        return launch_tile<S, 16, 11>(A, out, batch, n, stream);
    return static_cast<int>(cudaErrorInvalidValue);
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
