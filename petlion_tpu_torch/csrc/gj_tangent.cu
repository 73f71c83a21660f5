// Tangent of a stack of matrix inverses, hand-written for Hopper (sm_90a):
// dX = -(X * dA) * X.
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
// bit for bit as it is.
//
// What bounds it on an H100: 4 n^3 operations a matrix against 3 n^2
// values moved (X and dA read once, dX written once). At n = 71 in float64
// that is 1.43 MFLOP against 121 KB a matrix: some 12 operations a byte,
// under the card's float64 ridge of 20 (67 TFLOP/s on the tensor cores /
// 3.35 TB/s), so bytes bound it; in float32 it is 24 a byte, over the
// ridge of 20 (67 TFLOP/s outside the tensor cores), so operations do. On
// the estimation path the batch is the number of fitted parameters, one or
// two matrices (and 10 or 20 particle blocks), so a launch is latency.
//
// Design. Each block stages its operands into shared memory once, with
// cp.async (zero-filled past n, so the matrix is padded to NP, a multiple
// of 8, at no cost in device memory), forms V = X[panel, :] * dA into
// registers, writes V back to shared memory over dA (which is then dead),
// and forms dX[panel, :] = -V * X into registers, stored straight to
// device memory. The launch plan comes from the wrapper
// (ops/gj_kernel.py:gj_tangent_plan), which picks one of two regimes:
// - small batch (B * ceil(n/16) <= 132, the estimation path): one block a
//   panel of 16 rows, grid (panels, B), so one matrix spreads over
//   ceil(n/16) SMs and a block runs two staged products instead of the 50
//   dependent staged steps of a block that walks the whole matrix. Each
//   block stages X[panel, :], dA and X (re-read from L2 by every panel),
//   the X it needs second in a separate cp.async group that lands while
//   the first product runs; where three buffers do not fit (n > 96 in
//   float64, n > 128 in float32) X is staged over dA after the first
//   product. Staging sets a small block's time (8-byte cp.async: odd n
//   leaves rows off 16-byte alignment), so these blocks take 512 threads,
//   most of them only to stage.
// - large batch: one block a matrix (MB matrices a block at n <= 48), the
//   whole matrix staged once; at n > 96 in float64 and n > 128 in float32
//   a matrix takes two panels of half its rows, X staged over dA after the
//   first product (227 KB holds no more).
// Products:
// - float64 on the tensor cores, mma.sync.m16n8k8.f64 (DMMA): a warp forms
//   a 16-row strip of CT 16 x 8 tiles (one A fragment feeds CT products;
//   one tile where the batch is small, for more warps and shorter chains);
//   each output sums the depth eight at a time, each DMMA adding the sum of
//   its eight products to the accumulator. A panel's buffers take whole
//   16-row tiles (zeros past n). Row strides of 4 mod 8 doubles keep the
//   fragment reads free of bank conflicts. (m16n8k8, not m8n8k4: on an H100
//   m8n8k4 measured slower, PERF.md §6.)
// - float32 on FFMA at full precision: a thread forms a 4 x 8 tile, rows
//   ti + (PANEL/4) a and columns 4 tj + (NP/2) h + e, from 16-byte shared
//   reads (per four depth steps four reads of X's rows and eight of dA's:
//   0.375 reads an FMA); the depth is summed in order, one fma chain an
//   output. Row strides of NP + 4 floats keep a warp's reads of
//   neighbouring rows in distinct banks.
// The plain version is ops/gj_kernel.py:gj_tangent_plain; the plain
// mirror of this order of operations (panels, the depth eight at a time) is
// ops/gj_kernel.py:gj_tangent_mirror.

#include <cuda_runtime.h>

#include "tangent_common.cuh"

namespace {

// threads of a block in the small-batch regime: staging a panel's
// operands is latency-bound, and each warp keeps only so many copies in
// flight
constexpr int kSmallThreads = 512;

// rows of a float32 thread tile (8 columns); 8 x 8 tiles (fewer shared
// reads an FMA, half the threads) were tried and were slower at (1024, 71)
constexpr int kRowsF32 = 4;

// largest divisor of NP / 8 that is at most 4: the 8 x 8 tiles of a
// float64 warp's strip
__host__ __device__ constexpr int col_tiles(int np) {
    return (np / 8) % 4 == 0 ? 4 : (np / 8) % 3 == 0 ? 3 : (np / 8) % 2 == 0 ? 2 : 1;
}

// NP: padded size, PANEL: rows of a panel, MB: matrices a block
template <typename S, int NP, int PANEL, int MB>
struct Cfg {
    static constexpr int LD = NP + 4;
    static constexpr bool WHOLE = PANEL == NP;          // a panel is the matrix
    // rows of the panel's buffers: float64 tiles take 16 rows (rows past n
    // are zeros)
    static constexpr int PROWS = sizeof(S) == 8 ? (PANEL + 15) / 16 * 16 : PANEL;
    static constexpr int P_ELEMS = PROWS * LD;          // X[panel, :], then V
    static constexpr int F_ELEMS = (PROWS > NP ? PROWS : NP) * LD;   // dA (then V, or X)
    static constexpr bool THREE =
        !WHOLE && static_cast<long long>(PROWS + 2 * NP) * LD * sizeof(S) * MB <= tc::kMaxSmem;
    static constexpr int G_ELEMS = THREE ? NP * LD : 0;   // X
    static constexpr int PER = P_ELEMS + F_ELEMS + G_ELEMS;
    static constexpr long long SMEM = static_cast<long long>(PER) * MB * sizeof(S);
    // the small-batch regime: a block a panel of 16 rows; its staging,
    // latency-bound, takes kSmallThreads threads
    static constexpr bool SMALL = PANEL == 16 && MB == 1;
    // float64: warp tasks of one 16-row strip of CT tiles of 16 x 8 (one
    // tile where the batch is small: more warps, shorter chains)
    static constexpr int CT = SMALL ? 1 : col_tiles(NP);
    static constexpr int STRIPS = NP / 8 / CT;
    static constexpr int TASKS64 = MB * (PROWS / 16) * STRIPS;
    static constexpr int WMAX = SMALL ? kSmallThreads / 32 : 8;
    static constexpr int NW64 = TASKS64 < WMAX ? TASKS64 : WMAX;
    static constexpr int TPW = (TASKS64 + NW64 - 1) / NW64;
    // float32: thread tiles of TR rows x 8 columns
    static constexpr int TR = kRowsF32;
    static constexpr int NTI = PANEL / TR, NTJ = NP / 8;
    static constexpr int TASKS32 = MB * NTI * NTJ;
    static constexpr int NT = SMALL ? kSmallThreads
                                    : sizeof(S) == 8 ? 32 * NW64 : (TASKS32 + 31) / 32 * 32;
    static_assert(NP % 8 == 0 && PANEL % 8 == 0 && PANEL <= NP, "tile sizes");
    static_assert(SMEM <= tc::kMaxSmem, "shared memory");
    static_assert(NT <= 1024, "threads");
};

// rows rbase .. rbase + ROWS - 1 (all NP columns) of the MB matrices of
// `src` (n x n each, from matrix b0) into the buffer at `dst` of each
// matrix (stride PER, row stride LD); zeros past n and past the batch.
// A warp takes a row where rows are at least 32 wide (fewest index
// operations); narrower rows are walked in order by the whole block, so no
// lane idles.
template <typename S, int NP, int LD, int ROWS, int MB, int PER, int NT>
__device__ __forceinline__ void stage_rows(S* dst, const S* src, long long b0, int batch,
                                           int n, int rbase) {
    auto copy = [&](int row, int j) {
        const int m = row / ROWS, i = row - m * ROWS, r = rbase + i;
        const bool on = b0 + m < batch && r < n && j < n;
        const S* s = on ? src + ((b0 + m) * n + r) * static_cast<long long>(n) + j : src;
        tc::cp_async(dst + m * PER + i * LD + j, s, on);
    };
    if constexpr (NP >= 32) {
        const int lane = threadIdx.x & 31;
        for (int row = threadIdx.x >> 5; row < MB * ROWS; row += NT / 32)
#pragma unroll
            for (int j = lane; j < NP; j += 32) copy(row, j);
    } else {
        constexpr int DJ = NT % NP, DR = NT / NP;
        int j = threadIdx.x % NP, row = threadIdx.x / NP;
        while (row < MB * ROWS) {
            copy(row, j);
            j += DJ;
            row += DR;
            if (j >= NP) {
                j -= NP;
                ++row;
            }
        }
    }
}

// float64: acc[c] += A[16-row strip] * B[:, the strip's CT 8-column
// tiles] over the depth NP, eight at a time (A at the strip's first row, B
// at its first column, row stride LD)
template <int NP, int LD, int CT>
__device__ __forceinline__ void strip64(double (&acc)[CT][4], const double* A,
                                        const double* B) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 3
    for (int k = 0; k < NP; k += 8) {
        const double a[4] = {A[g * LD + k + t], A[(g + 8) * LD + k + t], A[g * LD + k + t + 4],
                             A[(g + 8) * LD + k + t + 4]};
#pragma unroll
        for (int c = 0; c < CT; ++c) {
            const double b[2] = {B[(k + t) * LD + 8 * c + g], B[(k + t + 4) * LD + 8 * c + g]};
            tc::dmma16x8x8(acc[c], a, b);
        }
    }
}

// float32: acc[q][c] += sum_k A[ti + NTI q][k] * B[k][col(c)], col(c) =
// 4 tj + (NP / 2)(c / 4) + c % 4, the depth in order
template <int NP, int LD, int NTI, int TR>
__device__ __forceinline__ void tile32(float (&acc)[TR][8], const float* A, const float* B,
                                       int ti, int tj) {
#pragma unroll 2
    for (int k = 0; k < NP; k += 4) {
        float4 a[TR];
#pragma unroll
        for (int q = 0; q < TR; ++q)
            a[q] = *reinterpret_cast<const float4*>(A + (ti + NTI * q) * LD + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const float4 b0 = *reinterpret_cast<const float4*>(B + (k + kk) * LD + 4 * tj);
            const float4 b1 =
                *reinterpret_cast<const float4*>(B + (k + kk) * LD + 4 * tj + NP / 2);
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int q = 0; q < TR; ++q) {
                const float x = kk == 0 ? a[q].x : kk == 1 ? a[q].y : kk == 2 ? a[q].z : a[q].w;
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(x, bv[c], acc[q][c]);
            }
        }
    }
}

template <typename S, int NP, int PANEL, int MB>
__global__ void __launch_bounds__(Cfg<S, NP, PANEL, MB>::NT)
gj_tangent_kernel(const S* __restrict__ X, const S* __restrict__ dA, S* __restrict__ dX,
                  int batch, int n, int panels) {
    using C = Cfg<S, NP, PANEL, MB>;
    constexpr int LD = C::LD, PER = C::PER, NT = C::NT;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    S* const P = reinterpret_cast<S*>(smem_raw);
    S* const F = P + C::P_ELEMS;
    S* const G = F + C::F_ELEMS;
    const int r0 = (blockIdx.x % panels) * PANEL;
    const long long b0 = static_cast<long long>(blockIdx.x / panels) * MB;
    TANGENT_STAMP(0);

    // X[panel, :] -> P, dA -> F; then X -> G in a second group
#ifndef TANGENT_PROBE_NO_STAGING
    stage_rows<S, NP, LD, C::PROWS, MB, PER, NT>(P, X, b0, batch, n, r0);
    stage_rows<S, NP, LD, NP, MB, PER, NT>(F, dA, b0, batch, n, 0);
    tc::cp_async_commit();
    if constexpr (C::THREE) {
        stage_rows<S, NP, LD, NP, MB, PER, NT>(G, X, b0, batch, n, 0);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();
    } else {
        tc::cp_async_wait<0>();
    }
#endif
    __syncthreads();
    TANGENT_STAMP(1);
    // after the first product: V over dA (whole matrix) or over X[panel, :]
    S* const Vb = C::WHOLE ? F : P;
    const S* const Xb = C::WHOLE ? P : (C::THREE ? G : F);

    if constexpr (sizeof(S) == 8) {
        constexpr int CT = C::CT, TPW = C::TPW, NW = C::NW64;
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int g = lane >> 2, t = lane & 3;
        double acc[TPW][CT][4];
        int rt[TPW], c0[TPW], mm[TPW];
#pragma unroll
        for (int u = 0; u < TPW; ++u) {
            const int task = warp + NW * u;
            c0[u] = (task % C::STRIPS) * 8 * CT;
            rt[u] = ((task / C::STRIPS) % (C::PROWS / 16)) * 16;
            mm[u] = task / (C::STRIPS * (C::PROWS / 16));
#pragma unroll
            for (int c = 0; c < CT; ++c)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[u][c][e] = 0.0;
        }
        // V = X[panel, :] * dA
#ifndef TANGENT_PROBE_NO_PRODUCTS
#pragma unroll
        for (int u = 0; u < TPW; ++u)
            if (warp + NW * u < C::TASKS64)
                strip64<NP, LD, CT>(acc[u], P + mm[u] * PER + rt[u] * LD,
                                    F + mm[u] * PER + c0[u]);
#endif
        __syncthreads();
        TANGENT_STAMP(2);
#pragma unroll
        for (int u = 0; u < TPW; ++u)
            if (warp + NW * u < C::TASKS64)
#pragma unroll
                for (int c = 0; c < CT; ++c)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        S* v = Vb + mm[u] * PER + (rt[u] + g + 8 * h) * LD + c0[u] + 8 * c + 2 * t;
                        v[0] = acc[u][c][2 * h];
                        v[1] = acc[u][c][2 * h + 1];
                        acc[u][c][2 * h] = acc[u][c][2 * h + 1] = 0.0;
                    }
#ifndef TANGENT_PROBE_NO_STAGING
        if constexpr (!C::WHOLE && !C::THREE)
            stage_rows<S, NP, LD, NP, MB, PER, NT>(F, X, b0, batch, n, 0);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
#endif
        __syncthreads();
        TANGENT_STAMP(3);
        // dX[panel, :] = -V * X
#ifndef TANGENT_PROBE_NO_PRODUCTS
#pragma unroll
        for (int u = 0; u < TPW; ++u)
            if (warp + NW * u < C::TASKS64)
                strip64<NP, LD, CT>(acc[u], Vb + mm[u] * PER + rt[u] * LD,
                                    Xb + mm[u] * PER + c0[u]);
#endif
        TANGENT_STAMP(4);
#pragma unroll
        for (int u = 0; u < TPW; ++u) {
            const long long b = b0 + mm[u];
            if (warp + NW * u >= C::TASKS64 || b >= batch) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = r0 + rt[u] + g + 8 * h;
                if (row >= n) continue;
                S* out = dX + (b * n + row) * static_cast<long long>(n);
#pragma unroll
                for (int c = 0; c < CT; ++c)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = c0[u] + 8 * c + 2 * t + e;
                        if (col < n) out[col] = -acc[u][c][2 * h + e];
                    }
            }
        }
    } else {
        constexpr int NTI = C::NTI, NTJ = C::NTJ, TR = C::TR;
        const int task = threadIdx.x;
        const bool on = task < C::TASKS32;
        const int tj = task % NTJ, ti = (task / NTJ) % NTI, m = on ? task / (NTJ * NTI) : 0;
        float acc[TR][8];
#pragma unroll
        for (int q = 0; q < TR; ++q)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[q][c] = 0.0f;
        // V = X[panel, :] * dA
#ifndef TANGENT_PROBE_NO_PRODUCTS
        if (on) tile32<NP, LD, NTI, TR>(acc, P + m * PER, F + m * PER, ti, tj);
#endif
        __syncthreads();
        TANGENT_STAMP(2);
        if (on) {
#pragma unroll
            for (int q = 0; q < TR; ++q) {
                float* v = Vb + m * PER + (ti + NTI * q) * LD + 4 * tj;
                reinterpret_cast<float4*>(v)[0] =
                    make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
                reinterpret_cast<float4*>(v + NP / 2)[0] =
                    make_float4(acc[q][4], acc[q][5], acc[q][6], acc[q][7]);
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[q][c] = 0.0f;
            }
        }
#ifndef TANGENT_PROBE_NO_STAGING
        if constexpr (!C::WHOLE && !C::THREE)
            stage_rows<S, NP, LD, NP, MB, PER, NT>(F, X, b0, batch, n, 0);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
#endif
        __syncthreads();
        TANGENT_STAMP(3);
        // dX[panel, :] = -V * X
#ifndef TANGENT_PROBE_NO_PRODUCTS
        if (on) tile32<NP, LD, NTI, TR>(acc, Vb + m * PER, Xb + m * PER, ti, tj);
#endif
        TANGENT_STAMP(4);
        const long long b = b0 + m;
        if (!on || b >= batch) return;
#pragma unroll
        for (int q = 0; q < TR; ++q) {
            const int row = r0 + ti + NTI * q;
            if (row >= n) continue;
            S* out = dX + (b * n + row) * static_cast<long long>(n);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int col = 4 * tj + (NP / 2) * (c / 4) + c % 4;
                if (col < n) out[col] = -acc[q][c];
            }
        }
    }
}

// the instances the plan picks (ops/gj_kernel.py TANGENT_NP and
// gj_tangent_plan): (NP, PANEL, MB) for each regime
#define GJT_F64(X)                                                                      \
    X(16, 16, 4) X(16, 16, 1) X(32, 32, 2) X(32, 16, 1) X(48, 48, 1) X(48, 16, 1)       \
    X(72, 72, 1) X(72, 16, 1) X(96, 96, 1) X(96, 16, 1) X(128, 64, 1) X(128, 16, 1)
#define GJT_F32(X)                                                                      \
    X(16, 16, 16) X(16, 16, 1) X(32, 32, 4) X(32, 16, 1) X(48, 48, 2) X(48, 16, 1)      \
    X(72, 72, 1) X(72, 16, 1) X(96, 96, 1) X(96, 16, 1) X(128, 128, 1) X(128, 16, 1)    \
    X(176, 88, 1) X(176, 16, 1)

template <typename S, int NP, int PANEL, int MB>
int launch_instance(const S* X, const S* dA, S* dX, int batch, int n, cudaStream_t stream) {
    using C = Cfg<S, NP, PANEL, MB>;
    static unsigned long long opted = 0;
    auto kernel = gj_tangent_kernel<S, NP, PANEL, MB>;
    const cudaError_t err = tc::smem_opt_in(kernel, C::SMEM, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int panels = (n + PANEL - 1) / PANEL;
    const long long blocks = (static_cast<long long>(batch) + MB - 1) / MB * panels;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(blocks), C::NT, C::SMEM, stream>>>(X, dA, dX, batch, n,
                                                                       panels);
    return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(const S* X, const S* dA, S* dX, int batch, int n, int np, int rows, int mb,
           void* stream_) {
    // launches on the caller's current device (the wrapper makes it X's)
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (n < 1 || n > np || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
#define GJT_CASE(a, b, c) \
    if (np == a && rows == b && mb == c) return launch_instance<S, a, b, c>(X, dA, dX, batch, n, stream);
    if constexpr (sizeof(S) == 8) {
        GJT_F64(GJT_CASE)
    } else {
        GJT_F32(GJT_CASE)
    }
#undef GJT_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

TANGENT_PROBE_EXPORT

extern "C" {

// np, rows, mb: the launch plan of ops/gj_kernel.py:gj_tangent_plan
int gj_tangent_f32(const float* X, const float* dA, float* dX, int batch, int n, int np,
                   int rows, int mb, void* stream) {
    return launch<float>(X, dA, dX, batch, n, np, rows, mb, stream);
}

int gj_tangent_f64(const double* X, const double* dA, double* dX, int batch, int n, int np,
                   int rows, int mb, void* stream) {
    return launch<double>(X, dA, dX, batch, n, np, rows, mb, stream);
}

// shared memory and threads of a block of the instance (np, rows, mb), or -1
// where there is none: the plan's own numbers, checked against these
long long gj_tangent_block(int f64, int np, int rows, int mb, int threads) {
#define GJT_Q(S, a, b, c)                                                               \
    if (np == a && rows == b && mb == c) return threads ? Cfg<S, a, b, c>::NT : Cfg<S, a, b, c>::SMEM;
#define GJT_Q64(a, b, c) GJT_Q(double, a, b, c)
#define GJT_Q32(a, b, c) GJT_Q(float, a, b, c)
    if (f64) {
        GJT_F64(GJT_Q64)
    } else {
        GJT_F32(GJT_Q32)
    }
#undef GJT_Q
#undef GJT_Q64
#undef GJT_Q32
    return -1;
}

const char* gj_tangent_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
