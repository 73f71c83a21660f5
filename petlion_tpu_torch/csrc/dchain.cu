// Fused nested Schur chain on the permuted core of the Newton matrix,
// hand-written for Hopper (sm_90a): one thread block per cell.
//
// Replaces: the JAX package's ops/pallas_schur.py:_dchain_kernel (reached
// through dchain_pallas / make_dchain_hot). After the group eliminations the
// dense Schur core D (71x71 on the default LCO mesh) is permuted so that each
// nested level (the j family, then Phi_s: 20 states each) is a leading block.
// Per level of size nk, on the current trailing core [A B; C D22]:
//     invA  = equilibrated pivot-free inverse of A, scalings folded back
//     AinvB = invA * B
//     D    <- D22 - C * AinvB
// and the level's (invA, AinvB, C) are outputs; then the folded equilibrated
// inverse of what is left (31x31) is the last output. Equilibration as in the
// JAX package's _inv_equil, with reciprocals: rc_j = 1 / max(max_i |A_ij|,
// 1e-30), rr_i = 1 / max(max_j |A_ij rc_j|, 1e-30), As = (A rc) rr, and
// inv_ij = (inv(As)_ij rc_i) rr_j. The plain mirror of this order of
// operations is ops/dchain.py:dchain_mirror.
//
// What bounds it on an H100: device memory sees one read of D and one write
// of the outputs (71^2 in, 20*20 + 20*51 + 51*20 + 20*20 + 20*31 + 31*20 +
// 31*31 = 5,041 out per cell: 41.3 MB at B = 1024 in f32, 12.3 us at
// 3.35 TB/s) against ~0.3 GFLOP (4.6 us at 67 TFLOP/s), so bytes bound it.
// The chain itself is sequential: three Gauss-Jordan eliminations of 20, 20
// and 31 dependent pivot steps.
//
// Design: the whole core stays in dynamic shared memory through both levels
// and the final inverse (20 KB in f32 plus the AinvB panel); every inverse is
// formed in place of its block, and the Schur update is applied in place on
// the trailing block. Each output is written once, coalesced. The level
// sizes are a launch argument (the permutation and the sizes come from the
// plan), not compiled in.
// - Every inverse is K1's register-tiled elimination (gj_common.cuh), eight
//   pivots at a time: on the default mesh (inverses of 20, 20 and 31) a
//   T = 8 grid of 64 threads with 4 x 4 tiles, so an inverse of 31 is four
//   pivot blocks and eight barriers. A one-warp Gauss-Jordan with the rows
//   in registers (pivot rows broadcast by shuffles, one dependent step per
//   pivot) was tried first and was slower: its 71 dependent steps dominated
//   the kernel.
// - The scalings are maxima over the register tiles: xor shuffles within a
//   warp, the warps' column maxima through shared memory.
// - AinvB and the Schur update spread over all threads in 4 x 4 register
//   tiles: each shared operand is read once per tile row or column, and
//   nothing is divided per element.
// - A level or rest larger than 32 (a finer mesh) takes a 16 x 16 grid.
// With 64 threads, at most 128 registers a thread and 27 KB of shared memory
// (f32, default mesh; the pivot buffers share room with the AinvB panel) 8
// cells fit on an SM, so 1024 cells run in one wave. Simple first: no wgmma,
// no TMA.

#include <cuda_runtime.h>

#include "gj_common.cuh"

namespace {

constexpr int kMaxLevels = 4;

template <typename S>
struct Outputs {
    S* p[3 * kMaxLevels + 1];   // per level invA, AinvB, C; then the core inverse
};

struct Plan {
    int n;                      // core size
    int n_levels;
    int sizes[kMaxLevels];
    int panel;                  // largest nk * (m - nk) over the levels
};

template <typename S>
__device__ __forceinline__ S smax(S a, S b) { return a > b ? a : b; }

// threads of a block: the tile grid (64 threads at T = 8, which leaves each
// 128 registers at 8 blocks an SM; with four warps a block the 64-register
// cap spilled)
template <int T>
__host__ __device__ constexpr int threads() { return T * T; }

// Folded equilibrated inverse of the m x m block at Sm (row stride lds,
// shared memory, m <= T*P), in place, by the block's T*T threads: the block
// loaded into the register tiles; the column maxima (each thread over its
// tile, xor shuffles over the warp's threads of a column, then the warps
// through shared memory) and the row maxima of the column-scaled block (xor
// shuffles over a row's threads, which share a warp), kept in rc, rr (m
// each, shared) for the fold; the elimination (buf: smem_elems<T, P>(),
// 16-byte aligned; it also holds the warps' column maxima first); the fold
// on the way back. Ends after a block-wide barrier.
template <typename S, int T, int P>
__device__ void equil_inverse(S* Sm, int lds, int m, S* rc, S* rr, S* buf) {
    constexpr int NP = T * P;
    const unsigned full = 0xffffffffu;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int ty = tid / T, tx = tid % T;
    S v[P][P];
#pragma unroll
    for (int a = 0; a < P; ++a) {
        const int i = ty + T * a;
#pragma unroll
        for (int b = 0; b < P; ++b) {
            const int j = tx + T * b;
            v[a][b] = (i < m && j < m) ? Sm[i * lds + j] : S(0);
        }
    }
    // column maxima: rc_j = 1 / max(max_i |a_ij|, 1e-30)
#pragma unroll
    for (int b = 0; b < P; ++b) {
        S c = S(0);
#pragma unroll
        for (int a = 0; a < P; ++a) c = smax(c, S(fabs(v[a][b])));
#pragma unroll
        for (int off = T; off < 32; off <<= 1) c = smax(c, __shfl_xor_sync(full, c, off));
        if ((tid & 31) < T) buf[warp * NP + tx + T * b] = c;
    }
    __syncthreads();
    S rcb[P];
#pragma unroll
    for (int b = 0; b < P; ++b) {
        const int j = tx + T * b;
        S c = S(0);
        for (int w = 0; w < T * T / 32; ++w) c = smax(c, buf[w * NP + j]);
        rcb[b] = gjc::rcp(smax(c, S(1e-30)));
        if (ty == 0 && j < m) rc[j] = rcb[b];
    }
    __syncthreads();     // the elimination reuses buf
    // row maxima of the column-scaled block: rr_i = 1 / max(max_j |a_ij rc_j|, 1e-30)
#pragma unroll
    for (int a = 0; a < P; ++a) {
        S c = S(0);
#pragma unroll
        for (int b = 0; b < P; ++b) {
            v[a][b] = v[a][b] * rcb[b];
            c = smax(c, S(fabs(v[a][b])));
        }
#pragma unroll
        for (int off = 1; off < T; off <<= 1) c = smax(c, __shfl_xor_sync(full, c, off));
        const S q = gjc::rcp(smax(c, S(1e-30)));
        const int i = ty + T * a;
        if (tx == 0 && i < m) rr[i] = q;
#pragma unroll
        for (int b = 0; b < P; ++b) {
            const int j = tx + T * b;
            v[a][b] = (i < m && j < m) ? v[a][b] * q : S(i == j ? 1 : 0);
        }
    }
    gjc::tile_gj<S, T, P>(v, m, buf, ty, tx);
#pragma unroll
    for (int a = 0; a < P; ++a) {
        const int i = ty + T * a;
#pragma unroll
        for (int b = 0; b < P; ++b) {
            const int j = tx + T * b;
            if (i < m && j < m) Sm[i * lds + j] = v[a][b] * rc[i] * rr[j];
        }
    }
    __syncthreads();
}

// Z (op)= X * Y over M x N outputs of depth K, all operands row-major with
// their strides, spread over the block's NT threads in 4 x 4 register tiles.
// SUB: Z <- Z - X*Y in place; else Z <- X*Y and the same into G (ld ldz).
// Rows and columns past the edge are clamped in the loads and not stored.
template <typename S, int NT, bool SUB>
__device__ void gemm4x4(const S* X, int ldx, const S* Y, int ldy, int M, int N,
                        int K, S* Z, int ldz, S* G) {
    const int tiles_j = (N + 3) >> 2, tiles = ((M + 3) >> 2) * tiles_j;
    for (int idx = threadIdx.x; idx < tiles; idx += NT) {
        const int ti = idx / tiles_j, tj = idx - ti * tiles_j;   // once a tile
        const int i0 = 4 * ti, j0 = 4 * tj;
        const S* xr[4];
        int yc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xr[a] = X + min(i0 + a, M - 1) * ldx;
#pragma unroll
        for (int b = 0; b < 4; ++b) yc[b] = min(j0 + b, N - 1);
        S acc[4][4] = {};
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
            S x[4], y[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) x[a] = xr[a][k];
#pragma unroll
            for (int b = 0; b < 4; ++b) y[b] = Y[k * ldy + yc[b]];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
                for (int b = 0; b < 4; ++b) acc[a][b] += x[a] * y[b];
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            if (i0 + a >= M) break;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                if (j0 + b >= N) break;
                S* z = Z + (i0 + a) * ldz + j0 + b;
                if constexpr (SUB) {
                    *z = *z - acc[a][b];
                } else {
                    *z = acc[a][b];
                    G[(i0 + a) * ldz + j0 + b] = acc[a][b];
                }
            }
        }
    }
}

// rows x cols block at src (stride lds, shared) to dst (contiguous, device),
// a row per warp, a column per lane: coalesced, no divide
template <int NW, typename S>
__device__ __forceinline__ void copy_out(const S* src, int lds, int rows, int cols,
                                         S* dst, int lane, int warp) {
    for (int i = warp; i < rows; i += NW)
        for (int j = lane; j < cols; j += 32) dst[i * cols + j] = src[i * lds + j];
}

// float on the default mesh (T = 8) asks for 8 blocks an SM
template <typename S, int T>
__host__ __device__ constexpr int min_blocks() {
    return T > 8 ? 1 : (sizeof(S) == 4 ? 8 : 4);
}

// shared elements before the core: the pivot buffers of the inverses and the
// AinvB panel, which are never in use at the same time
template <int T, int P>
__host__ __device__ constexpr int front_elems(int panel) {
    return gjc::smem_elems<T, P>() > panel ? gjc::smem_elems<T, P>() : panel;
}

template <typename S, int T, int P>
__global__ void __launch_bounds__(threads<T>(), min_blocks<S, T>())
dchain_kernel(const S* __restrict__ D, Outputs<S> out, Plan plan) {
    constexpr int NT = threads<T>(), NW = NT / 32;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n = plan.n;
    S* buf = reinterpret_cast<S*>(smem_raw);      // pivot buffers, or
    S* panel = buf;                               // AinvB of the current level
    S* Dm = buf + front_elems<T, P>(plan.panel);  // n x n, row stride n
    S* rc = Dm + n * n;                           // scalings, n each at most
    S* rr = rc + n;
    const long long b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // the core, 80 loads in flight a thread (one round at n = 71): every
    // cell loads at once, so the copy is as fast as the loads in flight
    const S* d = D + b * n * n;
    for (int i0 = tid; i0 < n * n; i0 += 80 * NT) {
        S t[80];
#pragma unroll
        for (int u = 0; u < 80; ++u) t[u] = i0 + u * NT < n * n ? d[i0 + u * NT] : S(0);
#pragma unroll
        for (int u = 0; u < 80; ++u)
            if (i0 + u * NT < n * n) Dm[i0 + u * NT] = t[u];
    }
    __syncthreads();

    int o = 0, m = n;
    for (int L = 0; L < plan.n_levels; ++L) {
        const int nk = plan.sizes[L], r = m - nk;
        S* Sc = Dm + o * n + o;                   // current core, row stride n
        S* invA_out = out.p[3 * L] + b * nk * nk;
        S* AinvB_out = out.p[3 * L + 1] + b * nk * r;
        S* C_out = out.p[3 * L + 2] + b * r * nk;
        copy_out<NW>(Sc + nk * n, n, r, nk, C_out, lane, warp);
        equil_inverse<S, T, P>(Sc, n, nk, rc, rr, buf);
        gemm4x4<S, NT, false>(Sc, n, Sc + nk, n, nk, r, nk, panel, r, AinvB_out);
        copy_out<NW>(Sc, n, nk, nk, invA_out, lane, warp);
        __syncthreads();
        gemm4x4<S, NT, true>(Sc + nk * n, n, panel, r, r, r, nk, Sc + nk * n + nk, n,
                             nullptr);
        __syncthreads();
        o += nk;
        m = r;
    }
    S* Sc = Dm + o * n + o;
    equil_inverse<S, T, P>(Sc, n, m, rc, rr, buf);
    copy_out<NW>(Sc, n, m, m, out.p[3 * plan.n_levels] + b * m * m, lane, warp);
}

template <typename S, int T, int P>
int launch_plan(const S* D, const Outputs<S>& o, const Plan& plan, int batch,
                cudaStream_t stream) {
    const size_t elems = front_elems<T, P>(plan.panel)
        + static_cast<size_t>(plan.n) * plan.n + 2 * plan.n;
    const size_t smem = elems * sizeof(S);
    auto kernel = dchain_kernel<S, T, P>;
    // as much of the SM's 256 KB as shared memory, so 8 cells fit an SM
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<batch, threads<T>(), smem, stream>>>(D, o, plan);
    return static_cast<int>(cudaGetLastError());
}

// largest inverse each element type takes (ops/dchain.py MAX_M)
template <typename S>
constexpr int max_m() { return sizeof(S) == 4 ? 144 : 112; }

template <typename S>
int launch(const S* D, S* const* outs, const int* sizes, int n_levels,
           int batch, int n, void* stream_) {
    // launches on the caller's current device (the wrapper makes it D's)
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    if (n_levels < 0 || n_levels > kMaxLevels || n < 1 || batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Plan plan{};
    plan.n = n;
    plan.n_levels = n_levels;
    int m = n, m_max = 0, panel = 1;
    for (int L = 0; L < n_levels; ++L) {
        const int nk = sizes[L];
        if (nk < 1 || nk >= m) return static_cast<int>(cudaErrorInvalidValue);
        plan.sizes[L] = nk;
        m_max = nk > m_max ? nk : m_max;
        panel = nk * (m - nk) > panel ? nk * (m - nk) : panel;
        m -= nk;
    }
    m_max = m > m_max ? m : m_max;
    if (m_max > max_m<S>()) return static_cast<int>(cudaErrorInvalidValue);
    plan.panel = panel;
    Outputs<S> o{};
    for (int i = 0; i < 3 * n_levels + 1; ++i) o.p[i] = outs[i];
    if (m_max <= 32) return launch_plan<S, 8, 4>(D, o, plan, batch, stream);
    if (m_max <= 64) return launch_plan<S, 16, 4>(D, o, plan, batch, stream);
    if (m_max <= 112) return launch_plan<S, 16, 7>(D, o, plan, batch, stream);
    if constexpr (max_m<S>() > 112)
        return launch_plan<S, 16, 9>(D, o, plan, batch, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// outs: 3 * n_levels + 1 device pointers (host array); sizes: n_levels ints
int dchain_f32(const float* D, float* const* outs, const int* sizes,
               int n_levels, int batch, int n, void* stream) {
    return launch<float>(D, outs, sizes, n_levels, batch, n, stream);
}

int dchain_f64(const double* D, double* const* outs, const int* sizes,
               int n_levels, int batch, int n, void* stream) {
    return launch<double>(D, outs, sizes, n_levels, batch, n, stream);
}

const char* dchain_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
