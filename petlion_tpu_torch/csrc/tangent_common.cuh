// Pieces shared by the tangent kernels K1t (gj_tangent.cu) and K3t
// (dchain_tangent.cu): asynchronous staging into shared memory, the float64
// tensor-core product (DMMA), padded row strides, and the host-side
// once-per-device shared-memory opt-in.
//
// Float64 products run on mma.sync.m16n8k8.f64 (DMMA): IEEE float64
// products and sums, the depth taken eight at a time, each step adding the
// sum of its eight products to the 16 x 8 accumulator tile. Float32 products run on FFMA
// at full precision (no TF32), the depth summed in order in one fma chain.

#pragma once

#include <cuda_runtime.h>

namespace tc {

// Phase clocks for kernel_probe.py (built with -DTANGENT_PROBE_CLOCKS):
// thread 0 of each of the first 2048 blocks stamps clock64() at each
// barrier, and tangent_probe_clocks copies the stamps out. Without the
// flag a stamp is nothing.
#ifdef TANGENT_PROBE_CLOCKS
__device__ long long probe_clocks[2048 * 16];
#define TANGENT_STAMP(i)                                                          \
    do {                                                                          \
        const int i_ = (i);                                                       \
        if (threadIdx.x == 0 && blockIdx.x < 2048 && i_ < 16)                     \
            tc::probe_clocks[blockIdx.x * 16 + i_] = clock64();                   \
    } while (0)
#define TANGENT_PROBE_EXPORT                                                      \
    extern "C" int tangent_probe_clocks(long long* host) {                        \
        return static_cast<int>(                                                  \
            cudaMemcpyFromSymbol(host, tc::probe_clocks, sizeof(tc::probe_clocks))); \
    }
#else
#define TANGENT_STAMP(i) \
    do {                 \
    } while (0)
#define TANGENT_PROBE_EXPORT
#endif

// largest dynamic shared memory one block may take on Hopper
constexpr int kMaxSmem = 232448;

// Row stride (elements) of a shared operand that holds `cols` columns: 4
// mod 8. In float64 the eight rows of a DMMA A fragment (four doubles
// each) and the four rows of a B fragment (eight doubles) fall in distinct
// banks; in float32 rows stay 16-byte aligned and the 16-byte reads of
// eight neighbouring rows fall in distinct banks.
__host__ __device__ constexpr int pad_ld(int cols) {
    return cols + ((4 - cols) % 8 + 8) % 8;
}

// one element from device to shared memory, asynchronously; a false `valid`
// writes a zero and reads nothing (src must still be a mapped address)
template <typename S>
__device__ __forceinline__ void cp_async(S* dst, const S* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(sizeof(S)), "r"(valid ? static_cast<int>(sizeof(S)) : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols from src (row stride lds, device memory) to dst (row stride
// ldd, shared memory), all threads of the block, a warp a row
template <typename S, int NT>
__device__ __forceinline__ void stage(S* dst, int ldd, const S* src, int lds, int rows,
                                      int cols) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < rows; i += NT / 32)
        for (int j = lane; j < cols; j += 32) cp_async(dst + i * ldd + j, src + i * lds + j, true);
}

// d += a * b over one 16 x 8 x 8 step of mma.sync.m16n8k8.f64 (lane l, g =
// l / 4, t = l % 4: a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]).
// The float64 MMA shape both tangent kernels take: on an H100 m8n8k4
// measured slower (PERF.md §6).
__device__ __forceinline__ void dmma16x8x8(double (&d)[4], const double (&a)[4],
                                           const double (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Opt a kernel into `bytes` of dynamic shared memory on the current device,
// once per device for each kernel (the attribute is per device and stays).
template <typename Kernel>
inline cudaError_t smem_opt_in(Kernel kernel, size_t bytes, unsigned long long& done) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
    return err;
}

}  // namespace tc
