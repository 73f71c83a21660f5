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
// JAX package's _inv_equil: col_j = max_i |A_ij| (clamped at 1e-30), then
// row_i = max_j |A_ij / col_j| (clamped), As = A / col / row, and
// inv_ij = inv(As)_ij / col_i / row_j.
//
// What bounds it on an H100: device memory sees one read of D and one write
// of the outputs (71^2 in, 20*20 + 20*51 + 51*20 + 20*20 + 20*31 + 31*20 +
// 31*31 = 5,041 out per cell: 41.3 MB at B = 1024 in f32, 12.3 us at
// 3.35 TB/s) against ~0.3 GFLOP (4.6 us at 67 TFLOP/s), so bytes bound it.
// The chain itself is sequential: three Gauss-Jordan eliminations of 20, 20
// and 31 dependent pivot steps, each step two block-wide barriers.
//
// Design: the whole core stays in dynamic shared memory through both levels
// and the final inverse (20 KB in f32, 40 KB in f64, plus an augmented
// [As | I] and the AinvB panel), and the Schur update is applied in place on
// the trailing block. Each output is written straight from shared memory,
// coalesced. The level sizes are a launch argument (the permutation and the
// sizes come from the plan), not compiled in. The TPU kernel's batch tile of
// 16 cells and its two-stack Gauss-Jordan were Mosaic workarounds; here a
// cell is a block and the augmented matrix is one array. In each
// Gauss-Jordan step only the m+1 columns k..m+k can change (the columns left
// of k are unit vectors, the identity columns right of m+k are untouched), so
// the others are skipped exactly, as in K1. Simple first: no wgmma, no TMA.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

template <typename T>
struct Outputs {
    T* p[3 * kMaxLevels + 1];   // per level invA, AinvB, C; then the core inverse
};

struct Plan {
    int n;                      // core size
    int n_levels;
    int sizes[kMaxLevels];
    int m_max;                  // largest matrix inverted (a level or the rest)
    int panel;                  // largest nk * (m - nk) over the levels
};

template <typename T>
__device__ inline T tmax(T a, T b) { return a > b ? a : b; }

// Folded equilibrated inverse of the m x m matrix S (row stride lds) in
// shared memory. The result is left in the right half of `aug` (m x 2m,
// row stride 2m) and written to dst (m x m, contiguous, device memory).
template <typename T>
__device__ void equil_inverse(const T* S, int lds, int m, T* aug, T* colA,
                              T* rowA, T* colk, T* rowk, T* dst) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int ld = 2 * m;
    for (int j = tid; j < m; j += nt) {
        T c = T(0);
        for (int i = 0; i < m; ++i) c = tmax(c, T(fabs(S[i * lds + j])));
        colA[j] = tmax(c, T(1e-30));
    }
    __syncthreads();
    for (int idx = tid; idx < m * m; idx += nt) {
        const int i = idx / m, j = idx - i * m;
        aug[i * ld + j] = S[i * lds + j] / colA[j];
        aug[i * ld + m + j] = (i == j) ? T(1) : T(0);
    }
    __syncthreads();
    for (int i = tid; i < m; i += nt) {
        T r = T(0);
        for (int j = 0; j < m; ++j) r = tmax(r, T(fabs(aug[i * ld + j])));
        rowA[i] = tmax(r, T(1e-30));
    }
    __syncthreads();
    for (int idx = tid; idx < m * m; idx += nt) {
        const int i = idx / m, j = idx - i * m;
        aug[i * ld + j] = aug[i * ld + j] / rowA[i];
    }
    __syncthreads();

    const int w = m + 1;        // active columns k .. m+k
    for (int k = 0; k < m; ++k) {
        const T piv = aug[k * ld + k];
        for (int idx = tid; idx < m + w; idx += nt) {
            if (idx < m) {
                colk[idx] = aug[idx * ld + k];
            } else {
                const int jj = idx - m;
                rowk[jj] = aug[k * ld + k + jj] / piv;
            }
        }
        __syncthreads();
        for (int idx = tid; idx < m * w; idx += nt) {
            const int i = idx / w, jj = idx - i * w;
            const T r = rowk[jj];
            T* p = &aug[i * ld + k + jj];
            *p = (i == k) ? r : *p - colk[i] * r;
        }
        __syncthreads();
    }

    for (int idx = tid; idx < m * m; idx += nt) {
        const int i = idx / m, j = idx - i * m;
        const T v = aug[i * ld + m + j] / colA[i] / rowA[j];
        aug[i * ld + m + j] = v;
        dst[idx] = v;
    }
    __syncthreads();
}

__host__ __device__ inline size_t smem_elems(const Plan& p) {
    return static_cast<size_t>(p.n) * p.n + 2 * static_cast<size_t>(p.m_max) * p.m_max
           + p.panel + 4 * p.m_max + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dchain_kernel(const T* __restrict__ D, Outputs<T> out, Plan plan) {
    extern __shared__ unsigned char smem_raw[];
    const int n = plan.n, m_max = plan.m_max;
    T* Dm = reinterpret_cast<T*>(smem_raw);       // n x n, row stride n
    T* aug = Dm + n * n;                          // m_max x 2 m_max at most
    T* panel = aug + 2 * m_max * m_max;           // AinvB of the current level
    T* colA = panel + plan.panel;
    T* rowA = colA + m_max;
    T* colk = rowA + m_max;
    T* rowk = colk + m_max;                       // m_max + 1
    const long long b = blockIdx.x;
    const int tid = threadIdx.x, nt = blockDim.x;

    const T* d = D + b * n * n;
    for (int idx = tid; idx < n * n; idx += nt) Dm[idx] = d[idx];
    __syncthreads();

    int o = 0, m = n;
    for (int L = 0; L < plan.n_levels; ++L) {
        const int nk = plan.sizes[L], r = m - nk;
        T* S = Dm + o * n + o;                    // current core, row stride n
        T* invA_out = out.p[3 * L] + b * nk * nk;
        T* AinvB_out = out.p[3 * L + 1] + b * nk * r;
        T* C_out = out.p[3 * L + 2] + b * r * nk;
        equil_inverse(S, n, nk, aug, colA, rowA, colk, rowk, invA_out);
        const int la = 2 * nk;                    // invA = aug[:, nk:2nk]
        for (int idx = tid; idx < nk * r; idx += nt) {
            const int i = idx / r, j = idx - i * r;
            T s = T(0);
            for (int k = 0; k < nk; ++k) s += aug[i * la + nk + k] * S[k * n + nk + j];
            panel[idx] = s;
            AinvB_out[idx] = s;
        }
        for (int idx = tid; idx < r * nk; idx += nt) {
            const int i = idx / nk, j = idx - i * nk;
            C_out[idx] = S[(nk + i) * n + j];
        }
        __syncthreads();
        for (int idx = tid; idx < r * r; idx += nt) {
            const int i = idx / r, j = idx - i * r;
            T s = T(0);
            for (int k = 0; k < nk; ++k) s += S[(nk + i) * n + k] * panel[k * r + j];
            S[(nk + i) * n + nk + j] = S[(nk + i) * n + nk + j] - s;
        }
        __syncthreads();
        o += nk;
        m = r;
    }
    equil_inverse(Dm + o * n + o, n, m, aug, colA, rowA, colk, rowk,
                  out.p[3 * plan.n_levels] + b * m * m);
}

template <typename T>
int launch(const T* D, T* const* outs, const int* sizes, int n_levels,
           int batch, int n, void* stream) {
    // launches on the caller's current device (the wrapper makes it D's)
    if (n_levels < 0 || n_levels > kMaxLevels || n < 1)
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
    plan.m_max = m > m_max ? m : m_max;
    plan.panel = panel;
    Outputs<T> o{};
    for (int i = 0; i < 3 * n_levels + 1; ++i) o.p[i] = outs[i];
    const size_t smem = smem_elems(plan) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(dchain_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    dchain_kernel<T><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(D, o, plan);
    return static_cast<int>(cudaGetLastError());
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
