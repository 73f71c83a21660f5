// Batched pivot-free Gauss-Jordan inverses of stacks of small matrices,
// hand-written for Hopper (sm_90a): the matrix in registers, one row per
// lane, several matrices per warp.
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
// bound it; at (1024, 30, 30) 7.4 MB against 55 MFLOP. What holds the kernel
// above that (kernel_probe.py's clock64 phases): the load of the whole wave
// at once, with nothing to overlap it, and the n dependent pivot steps, each
// a broadcast of the pivot row (n shuffles), a reciprocal and n fmas.
//
// Design. A group of G lanes owns one matrix, lane i its row i, held as NC
// values in registers: at the main path's n = 10, G = 10 (three matrices a
// warp, two lanes left over) and NC = 10; at n = 30, G = 32 and NC = 30;
// otherwise G = NC = 8, 16 or 32 with the matrix padded by an identity tail,
// which is exact (the inverse restricts). The inverse is formed in place, one
// pivot at a time, with no [A | I], and each pivot row's normalisation is
// deferred: a row that has been the pivot row keeps its scale, so the lane
// of the pivot row does no work of its own. For pivot k every lane of the
// group receives the raw row k by __shfl_sync (with 1 put in column k) and
// forms p = 1/a_kk (one correctly rounded reciprocal, the same in every
// lane); then
//     lane i != k:  m = a_ik * p, a_ij <- a_ij - m * a_kj (j != k, one fma),
//                   a_ik <- -m;
//     lane k:       keeps its row, a_kk <- 1, and keeps p as its scale.
// In exact arithmetic every row then is the inverse's row divided by its own
// p, so the end multiplies row i by p_i. Every pivot is a separate piece of
// code (a template fold), so a_ik is a register with a static index. The
// warp's matrices are contiguous in memory; they are loaded and stored
// through shared memory with coalesced 16-byte accesses, eight a lane in
// flight at once (a ragged or unaligned stack falls back to 4- or 8-byte
// ones). No block-wide barrier: the warps of a block never wait for one
// another.
//
// The plain mirror of this order of operations is ops/gj_blocks.py:
// gj_blocks_mirror (the kernel fuses a_ij - m * a_kj into one fma; the
// mirror rounds product and difference apart). The choices below were
// measured on the card with petlion_tpu_torch/kernel_probe.py, which builds
// copies of this file with one of them changed, and with GJ_BLOCKS_PROBE
// defined for clock64 stamps of the load, the elimination and the store.
// Simple first: no wgmma, no TMA.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kMaxN = 32;                 // one row per lane
constexpr int kWarps = 2;                 // warps per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kLanesAt10 = 10;            // lanes a matrix at n = 10 (10, 16 or 32)
constexpr bool kShuffleRows = true;       // pivot row by __shfl_sync, not shared memory
constexpr bool kUnrollPivots = true;      // every pivot a separate piece of code
constexpr bool kStageInShared = true;     // load and store through shared memory
constexpr int kBatch = 8;                 // 16-byte loads a lane in flight in a copy

#ifdef GJ_BLOCKS_PROBE
constexpr int kProbeWarps = 8192;
__device__ long long g_prof[kProbeWarps * 3];
#define PROBE_START long long t_ = clock64(), acc_[3] = {0, 0, 0};
// the stamp waits for the row's values (a use of each) before reading the clock
#define PROBE_PHASE(p, a)                                                     \
    {                                                                         \
        T x_ = T(0);                                                          \
        for (int j_ = 0; j_ < NC; ++j_) x_ += a[j_];                          \
        if (x_ == T(-12345)) acc_[2] += 1;                                    \
        const long long n_ = clock64();                                       \
        acc_[p] += n_ - t_;                                                   \
        t_ = n_;                                                              \
    }
#define PROBE_SAVE                                                            \
    {                                                                         \
        const long long w_ = mat0 / MPW;                                      \
        if (lane == 0 && w_ < kProbeWarps)                                    \
            for (int q_ = 0; q_ < 3; ++q_) g_prof[w_ * 3 + q_] = acc_[q_];    \
    }
#else
#define PROBE_START
#define PROBE_PHASE(p, a)
#define PROBE_SAVE
#endif

__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// elements of a pivot-row buffer (without shuffles): the NC columns and the
// pivot, rounded up to 16 bytes
template <typename T, int NC>
__host__ __device__ constexpr int row_ld() {
    constexpr int v = 16 / static_cast<int>(sizeof(T));
    return (NC + 1 + v - 1) / v * v;
}

// shared elements of one warp: its matrices (n x n each), rounded up to 16
// bytes, then (without shuffles) two pivot-row buffers a matrix
template <typename T, int G, int NC>
__host__ __device__ constexpr int warp_elems(int n) {
    constexpr int v = 16 / static_cast<int>(sizeof(T));
    return ((32 / G) * n * n + v - 1) / v * v + (kShuffleRows ? 0 : (32 / G) * 2 * row_ld<T, NC>());
}

// a[k] for a k that is static once the pivots are unrolled
template <typename T, int NC>
__device__ __forceinline__ T pick(const T (&a)[NC], int k) {
    T v = a[0];
#pragma unroll
    for (int j = 1; j < NC; ++j) v = (j == k) ? a[j] : v;
    return v;
}

// count contiguous elements by the whole warp, 16 bytes a lane where both
// ends are 16-byte aligned; kBatch loads a lane are issued before the first
// store, so that their latencies overlap
template <typename T>
__device__ __forceinline__ void warp_copy(T* __restrict__ dst, const T* __restrict__ src,
                                          int count, int lane) {
    constexpr int v = 16 / static_cast<int>(sizeof(T));
    int done = 0;
    if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
        const int nv = count / v;
        const int4* s4 = reinterpret_cast<const int4*>(src);
        int4* d4 = reinterpret_cast<int4*>(dst);
        for (int e0 = lane; e0 < nv; e0 += 32 * kBatch) {
            int4 buf[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
                if (e0 + 32 * b < nv) buf[b] = s4[e0 + 32 * b];
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
                if (e0 + 32 * b < nv) d4[e0 + 32 * b] = buf[b];
        }
        done = nv * v;
    }
    for (int e = done + lane; e < count; e += 32) dst[e] = src[e];
}

// pivot k of the matrix whose row i this lane holds in a; lane0: the
// matrix's first lane; rows: its two pivot-row buffers (without shuffles).
// With k a constant every test against k below folds.
template <typename T, int G, int NC>
__device__ __forceinline__ void pivot(T (&a)[NC], T& scale, int k, int i, int lane0, T* rows) {
    // r: the raw pivot row, with 1 in column k; akk: the pivot
    T r[NC], akk = T(1);
    if constexpr (kShuffleRows) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            const T x = __shfl_sync(0xffffffffu, a[j], lane0 + k);
            if (j == k) akk = x;
            r[j] = (j == k) ? T(1) : x;
        }
    } else {
        // double-buffered (pivot k uses buffer k & 1), so one __syncwarp a
        // pivot: a lane that writes buffer k & 1 at pivot k + 2 has passed
        // the barrier of pivot k + 1, which every lane reaches only after
        // reading the buffer at pivot k
        T* rowk = rows + (k & 1) * row_ld<T, NC>();
        if (i == k) {
#pragma unroll
            for (int j = 0; j < NC; ++j) rowk[j] = (j == k) ? T(1) : a[j];
            rowk[NC] = pick(a, k);
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NC; ++j) r[j] = rowk[j];
        akk = rowk[NC];
    }
    const T p = rcp(akk);
    if (i == k) scale = p;
    // lane k keeps its row (m = 0) with a_kk = 1; the others eliminate
    // column k and take a_ik = -m (the fma adds 1 * -m to 0)
    const T m = (i == k) ? T(0) : pick(a, k) * p;
    const T kk = (i == k) ? T(1) : T(0);
#pragma unroll
    for (int j = 0; j < NC; ++j) a[j] = fma(-m, r[j], (j == k) ? kk : a[j]);
}

// pivots 0 .. NC - 1 with k a compile-time constant, whatever the unroller decides
template <typename T, int G, int NC, int... K>
__device__ __forceinline__ void pivots(T (&a)[NC], T& scale, int i, int lane0, T* rows,
                                       std::integer_sequence<int, K...>) {
    (pivot<T, G, NC>(a, scale, K, i, lane0, rows), ...);
}

template <typename T, int G, int NC>
__global__ void __launch_bounds__(kThreads)
gj_blocks_kernel(const T* __restrict__ A, T* __restrict__ out, int count, int n) {
    constexpr int MPW = 32 / G;           // matrices a warp
    constexpr int v = 16 / static_cast<int>(sizeof(T));
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / G;               // the warp's matrix this lane works on
    const int i = g < MPW ? lane % G : G; // its row (G: a lane left over, never a pivot)
    const long long mat0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * MPW;
    if (mat0 >= count) return;            // whole warps only; no block-wide barrier below
    PROBE_START
    const int nmat = count - mat0 < MPW ? static_cast<int>(count - mat0) : MPW;
    const bool live = g < nmat;
    const int nn = n * n;
    T* stage = reinterpret_cast<T*>(smem_raw) + warp * warp_elems<T, G, NC>(n);
    // this matrix's two pivot-row buffers (a lane left over only reads group 0's)
    T* rows = stage + (MPW * nn + v - 1) / v * v + (g < MPW ? g : 0) * 2 * row_ld<T, NC>();
    const T* src = A + (mat0 + g) * nn + i * n;
    if constexpr (kStageInShared) {
        warp_copy(stage, A + mat0 * nn, nmat * nn, lane);
        __syncwarp();
        src = stage + g * nn + i * n;
    }

    // row i of the matrix, padded with the identity (a lane left over holds zeros)
    T a[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j)
        a[j] = (live && i < n && j < n) ? src[j] : T(i == j);
    PROBE_PHASE(0, a)

    T scale = T(1);                       // 1 / the pivot of this lane's row
    if constexpr (kUnrollPivots) {
        pivots<T, G, NC>(a, scale, i, g * G, rows, std::make_integer_sequence<int, NC>());
    } else {
#pragma unroll 1
        for (int k = 0; k < NC; ++k) pivot<T, G, NC>(a, scale, k, i, g * G, rows);
    }
    // the row was a pivot row once and kept its scale since: scale it now
#pragma unroll
    for (int j = 0; j < NC; ++j) a[j] *= scale;
    PROBE_PHASE(1, a)

    T* dst = kStageInShared ? stage + g * nn + i * n : out + (mat0 + g) * nn + i * n;
    if (live && i < n) {
#pragma unroll
        for (int j = 0; j < NC; ++j)
            if (j < n) dst[j] = a[j];
    }
    if constexpr (kStageInShared) {
        __syncwarp();
        warp_copy(out + mat0 * nn, stage, nmat * nn, lane);
    }
    PROBE_PHASE(2, a)
    PROBE_SAVE
}

template <typename T, int G, int NC>
int launch_as(const T* A, T* out, int count, int n, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(kWarps) * warp_elems<T, G, NC>(n) * sizeof(T);
    if (smem > 48 * 1024) {   // not at the shipped choices (at most 16 KB)
        const cudaError_t err = cudaFuncSetAttribute(gj_blocks_kernel<T, G, NC>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    constexpr int per_block = kWarps * (32 / G);
    const int blocks = (count + per_block - 1) / per_block;
    gj_blocks_kernel<T, G, NC><<<blocks, kThreads, smem, stream>>>(A, out, count, n);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* A, T* out, int count, int n, void* stream) {
    // launches on the caller's current device (the wrapper makes it A's)
    if (n < 1 || n > kMaxN || count < 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n == 10) return launch_as<T, kLanesAt10, 10>(A, out, count, n, s);
    if (n == 30) return launch_as<T, 32, 30>(A, out, count, n, s);
    if (n <= 8) return launch_as<T, 8, 8>(A, out, count, n, s);
    if (n <= 16) return launch_as<T, 16, 16>(A, out, count, n, s);
    return launch_as<T, 32, 32>(A, out, count, n, s);
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

#ifdef GJ_BLOCKS_PROBE
// the clock64 cycles of each warp (load, elimination, store), 3 per warp
int gj_blocks_probe_copy(long long* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));
}
#endif

}  // extern "C"
