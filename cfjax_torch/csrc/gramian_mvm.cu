// Fused kernel-matrix-vector products b = K a, K_ij = k(x_i, y_j), for
// NVIDIA Hopper (sm_90a). Plain C interface, loaded with ctypes by
// cfjax_torch/ops/gramian_mvm.py, which also holds the plain torch
// version of each kernel.
//
// K1 `k1_gramian_matvec_direct` replaces cfjax/ops/pallas_mvm.py
//    `pallas_gramian_matvec_direct` / `_mvm_kernel_direct`: isotropic
//    kernels at d <= 16, squared distance by the exact difference form.
// K2 `k2_gramian_matvec_expand` replaces `pallas_gramian_matvec` /
//    `_mvm_kernel`: isotropic kernels at any d through the expansion
//    ||x||^2 + ||y||^2 - 2 x.y, and dot-product kernels through x.y, with
//    the inner products in full fp32 FMA (the "highest" tier).
//
// Neither kernel reads or writes an O(n m) array: each (row, column) entry
// of K is recomputed from the points, passed through the profile and
// contracted against `a` in registers. K1 is bound by fp32 issue rate
// (d FMAs for the distance plus the profile program per entry); K2 by
// the fp32 FMAs of the x.y tile at large d. The profile comes from a
// ProfileSpec (cfjax_torch/kernels/profile_spec.py), a postfix program
// interpreted per entry: the Pallas kernels baked a jnp closure into the
// compiled kernel instead. Every thread runs the same program, so warps
// do not diverge on it.
//
// The TPU kernels carry the row sum over a sequential grid axis in VMEM
// scratch. Here the columns are split over gridDim.y, each block loops
// over its slice with y tiles and `a` staged in shared memory, and a
// second small kernel adds the per-split partial sums in a fixed order:
// no atomics, so the result does not change from run to run. Ragged
// edges are bounds-checked in the kernels; nothing is padded in memory.

#include "profile_spec.cuh"

// Row sums use compensated (Kahan) accumulation (kahan_add): one thread
// adds up to m / (4 * splits) terms in sequence — 32768 at n = 2^17 — and
// plain fp32 accumulation then loses about eps * sqrt(terms) relative,
// more than a CG solve at tol 1e-5 can absorb. The Pallas kernels sum
// lane-wise in a tree; compensation costs four flops per entry here.

// ---------------------------------------------------------------------------
// K1: direct (difference-form) isotropic MVM, d = D <= 16
// ---------------------------------------------------------------------------

constexpr int K1_THREADS = 256;
constexpr int K1_TM = 64;                       // rows per block
constexpr int K1_CG = K1_THREADS / K1_TM;       // column groups per block
constexpr int K1_TN = 512;                      // columns staged per tile
constexpr int K1_V = 4;                         // entries per profile decode

// Thread t owns row (t % K1_TM) of the block and every K1_CG-th group of
// K1_V columns of each staged tile. The 32 threads of a warp share their
// column group, so each y read from shared memory is a broadcast.
template <int D>
__global__ void __launch_bounds__(K1_THREADS)
k1_direct(const float* __restrict__ x, const float* __restrict__ y,
          const float* __restrict__ a, float* __restrict__ partial,
          int n, int m, int cols_per_split, const __grid_constant__ ProfileSpec spec) {
    __shared__ ProfileSpec sp;
    __shared__ float ys[K1_TN * D];
    __shared__ float as[K1_TN];
    __shared__ float red[K1_CG][K1_TM];

    load_spec(sp, spec);
    const int row = threadIdx.x % K1_TM;
    const int cg = threadIdx.x / K1_TM;
    const int i = blockIdx.x * K1_TM + row;
    float xi[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xi[k] = i < n ? x[(size_t)i * D + k] : 0.f;

    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    float acc = 0.f, comp = 0.f;
    for (int j0 = j_begin; j0 < j_end; j0 += K1_TN) {
        const int cnt = min(K1_TN, j_end - j0);
        __syncthreads();  // the previous tile is consumed (and sp is loaded)
        for (int t = threadIdx.x; t < cnt * D; t += K1_THREADS) ys[t] = y[(size_t)j0 * D + t];
        for (int t = threadIdx.x; t < cnt; t += K1_THREADS) as[t] = a[j0 + t];
        __syncthreads();
        for (int jj = cg * K1_V; jj < cnt; jj += K1_CG * K1_V) {
            float s[K1_V];
#pragma unroll
            for (int v = 0; v < K1_V; ++v) {
                float dist = 0.f;
#pragma unroll
                for (int k = 0; k < D; ++k) {
                    const float t = xi[k] - ys[(jj + v) * D + k];
                    dist += t * t;
                }
                s[v] = dist;
            }
            eval_profile<K1_V>(sp, s);
#pragma unroll
            for (int v = 0; v < K1_V; ++v) kahan_add(acc, comp, (jj + v < cnt) ? s[v] * as[jj + v] : 0.f);
        }
    }
    red[cg][row] = acc;
    __syncthreads();
    if (cg == 0 && i < n) {
        float tot = red[0][row];
#pragma unroll
        for (int c = 1; c < K1_CG; ++c) tot += red[c][row];
        partial[(size_t)blockIdx.y * n + i] = tot;
    }
}

// out_i = sum over splits of partial[s, i], in split order
__global__ void reduce_splits(const float* __restrict__ partial, float* __restrict__ out,
                              int n, int splits) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float t = partial[i];
    for (int s = 1; s < splits; ++s) t += partial[(size_t)s * n + i];
    out[i] = t;
}

static void launch_reduce(const float* partial, float* out, int n, int splits, cudaStream_t st) {
    if (splits > 1) reduce_splits<<<(n + 255) / 256, 256, 0, st>>>(partial, out, n, splits);
}

extern "C" int k1_gramian_matvec_direct(const float* x, const float* y, const float* a,
                                        float* partial, float* out, int n, int m, int d,
                                        int splits, int cols_per_split, ProfileSpec spec,
                                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((n + K1_TM - 1) / K1_TM, splits);
    switch (d) {
#define K1_CASE(D)                                                                         \
    case D:                                                                                \
        k1_direct<D><<<grid, K1_THREADS, 0, st>>>(x, y, a, partial, n, m, cols_per_split, spec); \
        break;
        K1_CASE(1) K1_CASE(2) K1_CASE(3) K1_CASE(4) K1_CASE(5) K1_CASE(6) K1_CASE(7) K1_CASE(8)
        K1_CASE(9) K1_CASE(10) K1_CASE(11) K1_CASE(12) K1_CASE(13) K1_CASE(14) K1_CASE(15) K1_CASE(16)
#undef K1_CASE
    default:
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch_reduce(partial, out, n, splits, st);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: expansion-form MVM, any d, iso or dot, fp32 FMA inner products
// ---------------------------------------------------------------------------

constexpr int K2_THREADS = 256;  // 16 x 16 threads, 4 x 4 entries each
constexpr int K2_BM = 64;        // rows per block
constexpr int K2_BN = 64;        // columns per tile
constexpr int K2_BK = 16;        // depth per shared-memory stage
constexpr int K2_PAD = 4;        // keeps float4 rows aligned

template <bool ISO>
__global__ void __launch_bounds__(K2_THREADS)
k2_expand(const float* __restrict__ x, const float* __restrict__ y,
          const float* __restrict__ x2, const float* __restrict__ y2,
          const float* __restrict__ a, float* __restrict__ partial,
          int n, int m, int d, int cols_per_split, const __grid_constant__ ProfileSpec spec) {
    __shared__ ProfileSpec sp;
    __shared__ __align__(16) float xs[K2_BK][K2_BM + K2_PAD];
    __shared__ __align__(16) float ys[K2_BK][K2_BN + K2_PAD];
    __shared__ float as[K2_BN];
    __shared__ float y2s[K2_BN];
    __shared__ float red[K2_BN / 4][K2_BM];

    load_spec(sp, spec);
    const int tx = threadIdx.x % 16;  // column quad
    const int ty = threadIdx.x / 16;  // row quad
    const int row0 = blockIdx.x * K2_BM;
    float x2r[4], acc[4], comp[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = row0 + ty * 4 + r;
        x2r[r] = (ISO && i < n) ? x2[i] : 0.f;
        acc[r] = 0.f;
        comp[r] = 0.f;
    }

    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    for (int j0 = j_begin; j0 < j_end; j0 += K2_BN) {
        const int cnt = min(K2_BN, j_end - j0);
        __syncthreads();  // the previous tile's as / y2s are consumed
        for (int t = threadIdx.x; t < K2_BN; t += K2_THREADS) {
            as[t] = t < cnt ? a[j0 + t] : 0.f;
            y2s[t] = (ISO && t < cnt) ? y2[j0 + t] : 0.f;
        }
        float S[4][4] = {};
        for (int k0 = 0; k0 < d; k0 += K2_BK) {
            __syncthreads();
            for (int t = threadIdx.x; t < K2_BK * K2_BM; t += K2_THREADS) {
                const int r = t / K2_BK, kk = t % K2_BK;
                const int i = row0 + r, k = k0 + kk;
                xs[kk][r] = (i < n && k < d) ? x[(size_t)i * d + k] : 0.f;
                const int j = j0 + r;
                ys[kk][r] = (r < cnt && k < d) ? y[(size_t)j * d + k] : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < K2_BK; ++kk) {
                const float4 xv = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
                const float4 yv = *reinterpret_cast<const float4*>(&ys[kk][tx * 4]);
                const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
                const float yc[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) S[r][c] = fmaf(xr[r], yc[c], S[r][c]);
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            float s[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
                s[c] = ISO ? fmaxf((x2r[r] + y2s[tx * 4 + c]) - 2.f * S[r][c], 0.f) : S[r][c];
            eval_profile<4>(sp, s);
#pragma unroll
            for (int c = 0; c < 4; ++c)
                kahan_add(acc[r], comp[r], (tx * 4 + c < cnt) ? s[c] * as[tx * 4 + c] : 0.f);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) red[tx][ty * 4 + r] = acc[r];
    __syncthreads();
    if (threadIdx.x < K2_BM) {
        const int i = row0 + threadIdx.x;
        if (i < n) {
            float tot = red[0][threadIdx.x];
#pragma unroll
            for (int c = 1; c < K2_BN / 4; ++c) tot += red[c][threadIdx.x];
            partial[(size_t)blockIdx.y * n + i] = tot;
        }
    }
}

extern "C" int k2_gramian_matvec_expand(const float* x, const float* y, const float* x2,
                                        const float* y2, const float* a, float* partial,
                                        float* out, int n, int m, int d, int iso, int splits,
                                        int cols_per_split, ProfileSpec spec, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((n + K2_BM - 1) / K2_BM, splits);
    if (iso)
        k2_expand<true><<<grid, K2_THREADS, 0, st>>>(x, y, x2, y2, a, partial, n, m, d, cols_per_split, spec);
    else
        k2_expand<false><<<grid, K2_THREADS, 0, st>>>(x, y, x2, y2, a, partial, n, m, d, cols_per_split, spec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch_reduce(partial, out, n, splits, st);
    return (int)cudaGetLastError();
}
