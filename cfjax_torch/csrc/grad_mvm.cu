// K3: the gradient-gramian block MVM for NVIDIA Hopper (sm_90a). Plain C
// interface, loaded with ctypes by cfjax_torch/ops/grad_mvm.py, which
// also holds its plain torch version `grad_matvec_plain`.
//
// Replaces cfjax/ops/pallas_mvm.py `pallas_grad_matvec` (body
// `_grad_mvm_kernel`, derivatives by `_tile_d2`). For x (n, d), y (m, d)
// and A (m, d) it computes out (n, d), out_i = sum_j B_ij A_j with the
// d x d block B_ij = grad_x grad_y^T k(x_i, y_j) in closed form:
//   iso (s = |r|^2, r = x_i - y_j):
//     out_i = sum_j [-2 f'(s) A_j - 4 f''(s) <r, A_j> r]
//           = sum_j alpha_ij A_j + sum_j beta_ij y_j - (sum_j beta_ij) x_i,
//     alpha = -2 f', beta = 4 f'' <r, A_j>;
//   dot (s = <x_i, y_j>):
//     out_i = sum_j [f'(s) A_j + f''(s) <x_i, A_j> y_j],
//     alpha = f', beta = f'' <x_i, A_j>.
// f' and f'' come from the second-order jet of a derivative spec
// (profile_spec.cuh `eval_jet`), compiled from `k.profile` as the Pallas
// kernel differentiates `k.profile` by nested jvp.
//
// Nothing O(n m) touches device memory. A block owns K3_TM rows and a
// slice of the columns (gridDim.y splits them, as K1 and K2 do). For each
// tile of K3_TN columns:
//   A. s_ij and <r_ij, A_j> (iso) or <x_i, A_j> (dot), reduced over d in
//      slabs of K3_BK staged in shared memory, register-blocked 2 x 4 per
//      thread. The slab sums are added with Kahan compensation, so one
//      thread's d-long sum at d = 1024 keeps full precision;
//   B. the jet of the profile on the tile -> alpha, beta in shared memory;
//   C. out[rows, :] += alpha @ A_tile + beta @ y_tile - rowsum(beta) x_i,
//      in chunks of K3_DC output columns staged in shared memory. The
//      output row is d wide (d = 1024 at the README's configuration), so
//      it cannot stay in registers across tiles: each chunk's tile sum (64
//      terms, in registers) is added into the block's own rows of its
//      split's partial output in device memory. Only this block writes
//      those rows, so no atomics; a split covers at most 64 column tiles
//      (ops/grad_mvm.py), which bounds that sum's length.
// A second kernel adds the splits' partial outputs in a fixed order with
// Kahan compensation: the result repeats bit for bit from run to run.
// Every product above is written out as FMAs here: no library GEMM.
//
// Form of s and <r, A>, iso: the difference form at every d,
// s = sum_k (x_ik - y_jk)^2 and <r, A_j> = sum_k (x_ik - y_jk) A_jk, exact
// when x_i = y_j. The expansion ||x||^2 + ||y||^2 - 2 x.y (cfjax's form,
// and the plain version's above config.direct_sqdist_max_d) leaves
// s ~ eps ||x||^2 there instead of 0, and f'(s) then misses f'(0) by about
// eps ||x||^2 f''/f' relative. -2 f'(0) I is the whole diagonal block, and
// at the README's configuration (MaternP(2), n = d = 1024, standard normal
// points, ||x||^2 ~ 1024) the off-diagonal blocks underflow in float32, so
// that error was the whole error of the product: 1.4e-4 relative against
// the float64 plain version on an H100 in float32, where the difference
// form is exact. The price is one subtraction per (i, j, k) in phase A.
// dot: s = <x_i, y_j> and <x_i, A_j>, two FMAs per (i, j, k).
//
// Bounds on this card: per entry, 3d flops in phase A (iso) or 2d FMAs
// (dot), the jet program, and 2d FMAs in phase C: fp32 throughput at
// large d, the jet interpreter (a 384-byte local-memory stack per thread:
// 8 slots x 4 entries x 3 floats) at small d. Tensor cores, TMA and
// tuning are later work; this kernel computes the "highest" (full fp32)
// tier only.

#include "profile_spec.cuh"

constexpr int K3_THREADS = 256;
constexpr int K3_TM = 32;   // rows per block
constexpr int K3_TN = 64;   // columns per tile
constexpr int K3_BK = 16;   // depth per staged slab in phase A
constexpr int K3_DC = 32;   // output columns per pass of phase C
constexpr int K3_PAD = 4;   // keeps float4 rows aligned

struct K3StageA {
    float xs[K3_BK][K3_TM + K3_PAD];
    float ys[K3_BK][K3_TN + K3_PAD];
    float as[K3_BK][K3_TN + K3_PAD];
};
struct K3StageC {
    float Ac[K3_TN][K3_DC];
    float Yc[K3_TN][K3_DC];
};
union K3Stage {
    K3StageA a;
    K3StageC c;
};

// Phase A/B: thread (ty, tx) = (tid / 16, tid % 16) owns rows 2 ty + {0, 1}
// and columns 4 tx + {0..3} of the tile. Phase C: thread (cr, cq) =
// (tid / 8, tid % 8) owns row cr and output columns 4 cq + {0..3} of a
// chunk; the 8 threads of a row read alpha[cr][jj] as a broadcast.
template <bool ISO>
__global__ void __launch_bounds__(K3_THREADS)
k3_grad(const float* __restrict__ x, const float* __restrict__ y,
        const float* __restrict__ A, float* __restrict__ partial, int n, int m, int d,
        int cols_per_split, const __grid_constant__ ProfileSpec spec) {
    __shared__ ProfileSpec sp;
    __shared__ float alpha[K3_TM][K3_TN + 1];
    __shared__ float beta[K3_TM][K3_TN + 1];
    __shared__ __align__(16) K3Stage st;

    load_spec(sp, spec);
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int cr = tid / 8, cq = tid % 8;
    const int row0 = blockIdx.x * K3_TM;
    const int ci = row0 + cr;
    float* out = partial + (size_t)blockIdx.y * n * d;

    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    for (int j0 = j_begin; j0 < j_end; j0 += K3_TN) {
        const int cnt = min(K3_TN, j_end - j0);

        // ---- A: s and w = <r, A> (iso) / <x, A> (dot), over d ----
        float s[2][4], cs[2][4], w[2][4], cw[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = cs[r][c] = w[r][c] = cw[r][c] = 0.f;
        for (int k0 = 0; k0 < d; k0 += K3_BK) {
            __syncthreads();  // the previous slab / chunk / coefficient tile is consumed
            for (int e = tid; e < K3_BK * K3_TM; e += K3_THREADS) {
                const int r = e / K3_BK, kk = e % K3_BK, i = row0 + r, k = k0 + kk;
                st.a.xs[kk][r] = (i < n && k < d) ? x[(size_t)i * d + k] : 0.f;
            }
            for (int e = tid; e < K3_BK * K3_TN; e += K3_THREADS) {
                const int r = e / K3_BK, kk = e % K3_BK, k = k0 + kk;
                const bool ok = r < cnt && k < d;
                const size_t o = (size_t)(j0 + r) * d + k;
                st.a.ys[kk][r] = ok ? y[o] : 0.f;
                st.a.as[kk][r] = ok ? A[o] : 0.f;
            }
            __syncthreads();
            float sl[2][4] = {}, wl[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < K3_BK; ++kk) {
                const float2 xv = *reinterpret_cast<const float2*>(&st.a.xs[kk][ty * 2]);
                const float4 yv = *reinterpret_cast<const float4*>(&st.a.ys[kk][tx * 4]);
                const float4 av = *reinterpret_cast<const float4*>(&st.a.as[kk][tx * 4]);
                const float xr[2] = {xv.x, xv.y};
                const float yc[4] = {yv.x, yv.y, yv.z, yv.w};
                const float ac[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        if (ISO) {
                            const float df = xr[r] - yc[c];
                            sl[r][c] = fmaf(df, df, sl[r][c]);
                            wl[r][c] = fmaf(df, ac[c], wl[r][c]);
                        } else {
                            sl[r][c] = fmaf(xr[r], yc[c], sl[r][c]);
                            wl[r][c] = fmaf(xr[r], ac[c], wl[r][c]);
                        }
                    }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    kahan_add(s[r][c], cs[r][c], sl[r][c]);
                    kahan_add(w[r][c], cw[r][c], wl[r][c]);
                }
        }

        // ---- B: the jet of the profile -> alpha, beta ----
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float f1[4], f2[4];
            eval_jet<4>(sp, s[r], f1, f2);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const bool ok = tx * 4 + c < cnt;
                alpha[ty * 2 + r][tx * 4 + c] = ok ? (ISO ? -2.f * f1[c] : f1[c]) : 0.f;
                beta[ty * 2 + r][tx * 4 + c] = ok ? (ISO ? 4.f : 1.f) * f2[c] * w[r][c] : 0.f;
            }
        }
        __syncthreads();  // the coefficient tile is complete; stage A is consumed

        // ---- C: out += alpha @ A + beta @ y - rowsum(beta) x ----
        float gsum = 0.f;
        if (ISO)
            for (int jj = 0; jj < K3_TN; ++jj) gsum += beta[cr][jj];
        for (int k0 = 0; k0 < d; k0 += K3_DC) {
            if (k0 > 0) __syncthreads();  // the previous chunk is consumed
            for (int e = tid; e < K3_TN * K3_DC; e += K3_THREADS) {
                const int jj = e / K3_DC, cc = e % K3_DC, k = k0 + cc;
                const bool ok = jj < cnt && k < d;
                const size_t o = (size_t)(j0 + jj) * d + k;
                st.c.Ac[jj][cc] = ok ? A[o] : 0.f;
                st.c.Yc[jj][cc] = ok ? y[o] : 0.f;
            }
            __syncthreads();
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
            for (int jj = 0; jj < K3_TN; ++jj) {
                const float a = alpha[cr][jj], b = beta[cr][jj];
                const float4 av = *reinterpret_cast<const float4*>(&st.c.Ac[jj][cq * 4]);
                const float4 yv = *reinterpret_cast<const float4*>(&st.c.Yc[jj][cq * 4]);
                acc[0] = fmaf(a, av.x, fmaf(b, yv.x, acc[0]));
                acc[1] = fmaf(a, av.y, fmaf(b, yv.y, acc[1]));
                acc[2] = fmaf(a, av.z, fmaf(b, yv.z, acc[2]));
                acc[3] = fmaf(a, av.w, fmaf(b, yv.w, acc[3]));
            }
            if (ci < n) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int k = k0 + cq * 4 + c;
                    if (k < d) {
                        float v = acc[c];
                        if (ISO) v = fmaf(-gsum, x[(size_t)ci * d + k], v);
                        float* o = out + (size_t)ci * d + k;
                        *o = (j0 == j_begin) ? v : *o + v;
                    }
                }
            }
        }
    }
}

// out[e] = sum over splits of partial[s, e], in split order, compensated
__global__ void k3_reduce(const float* __restrict__ partial, float* __restrict__ out,
                          long long total, int splits) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    float sum = 0.f, comp = 0.f;
    for (int s = 0; s < splits; ++s) kahan_add(sum, comp, partial[(size_t)s * total + e]);
    out[e] = sum;
}

extern "C" int k3_grad_matvec(const float* x, const float* y, const float* A,
                              float* partial, float* out, int n, int m, int d, int iso,
                              int splits, int cols_per_split, ProfileSpec spec,
                              void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((n + K3_TM - 1) / K3_TM, splits);
    if (iso)
        k3_grad<true><<<grid, K3_THREADS, 0, st>>>(x, y, A, partial, n, m, d, cols_per_split,
                                                   spec);
    else
        k3_grad<false><<<grid, K3_THREADS, 0, st>>>(x, y, A, partial, n, m, d, cols_per_split,
                                                    spec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (splits > 1) {
        const long long total = (long long)n * d;
        k3_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(partial, out, total, splits);
    }
    return (int)cudaGetLastError();
}
