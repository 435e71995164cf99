// K1: the fused direct-form kernel-matrix-vector product b = K a,
// K_ij = k(x_i, y_j), for NVIDIA Hopper (sm_90a). Plain C interface, loaded
// with ctypes by cfjax_torch/ops/gramian_mvm.py, which also holds its plain
// torch version. K2, the expansion form, is in expand_mvm.cu.
//
// K1 `k1_gramian_matvec_family` and `k1_gramian_matvec_direct` replace
//    cfjax/ops/pallas_mvm.py `pallas_gramian_matvec_direct` /
//    `_mvm_kernel_direct`: isotropic kernels at d <= 16, squared distance
//    by the exact difference form. `_family` takes the one-leaf profiles
//    (ProfileSpec.family: EQ, Exp, MaternP(p <= 3), RQ, Cauchy, IMQ under
//    lengthscales, times a constant), `_direct` interprets any other
//    profile program. `k1_gramian_matmat_family` takes p columns at once
//    (B = K A, for the SLQ probe batches and `cg_columns`), evaluating each
//    entry's profile once for all of them; a spec that is not one leaf runs
//    `k1_gramian_matvec_direct` once per column (ops/gramian_mvm.py).
//
// K1 reads or writes no O(n m) array: each (row, column) entry of K is
// recomputed from the points, passed through the profile and contracted
// against `a` in registers. Its family instances are bound by the SFU (one
// or two MUFU operations per entry against 2d + 2..7 fp32 instructions);
// the interpreted instance by its per-entry program decode. The Pallas
// kernel baked the profile (a jnp closure) into the compiled kernel; here
// the families are template instances and the rest a postfix program.
//
// The TPU kernels carry the row sum over a sequential grid axis in VMEM
// scratch. Here the columns are split over gridDim.y, each block loops
// over its slice with y tiles and `a` staged in shared memory, and a
// second small kernel adds the per-split partial sums in a fixed order:
// no atomics, so the result does not change from run to run. Ragged
// edges are bounds-checked in the kernels; nothing is padded in memory.

#include "profile_spec.cuh"
#include "tc_tile.cuh"   // cp.async helpers

#include <type_traits>

// Row sums use compensated (Kahan) accumulation (kahan_add): one thread
// adds up to m / (4 * splits) terms in sequence — 32768 at n = 2^17 — and
// plain fp32 accumulation then loses about eps * sqrt(terms) relative,
// more than a CG solve at tol 1e-5 can absorb. The Pallas kernels sum
// lane-wise in a tree; compensation costs four flops per entry here.

// ---------------------------------------------------------------------------
// K1, interpreted: direct (difference-form) isotropic MVM, d = D <= 16, for
// profiles that are not one leaf
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
// K1, specialised: a one-leaf profile family in registers, d <= D
// ---------------------------------------------------------------------------
//
// What bounds it: the SFU and the fp32 pipe about equally. MaternP(2) at
// d = 3 costs per entry 3 FADD + 3 FFMA for the distance, FMNMX, 2 FMUL,
// 2 FFMA (Horner), FMUL and the FFMA into the row sum, 13 fp32
// instructions, plus 4 that make exp2's argument exact (ex2_split): 17,
// 0.133 cycles of an SM at 128 a cycle; and rsqrt and ex2, 2 MUFU, 0.125
// cycles at 16 a cycle. EQ costs 12 fp32 and 1 MUFU.
//
// Register tiles. A block of 8 warps owns 128 rows; thread (warp w, lane l)
// owns rows l, l + 32, l + 64, l + 96 (R = 4) with their coordinates in
// registers, and warp w the columns w * 4 + 32 q .. + 3 (V = 4) of each
// staged tile. Every lane of a warp reads the same column from shared
// memory: a broadcast, and one read (y and a of a column, packed in DP
// floats, one or more 16-byte loads) serves R rows.
//
// Staging. A tile of TN columns is copied from y and a into shared memory
// with cp.async (4 bytes each, zero-filled past the split's end), double
// buffered: tile t + 1 is in flight while tile t is consumed.
//
// Blocked compensation. Each thread sums a step's V = 4 terms per row with
// FFMA, adds 4 step sums with FADD, and adds that 16-term sum into a Kahan
// accumulator: the compensation costs 4 instructions per 16 entries, not
// per entry, and a long row (m / splits columns, 131072 at n = 2^17)
// keeps the rounding of short partial sums only. GP solves need it: the
// terms K_ij alpha_j of a row cancel to a sum far smaller than they are,
// and with one running sum of a tile's 64 terms the residual of the
// n = 2^17 solve through K1 was 2.3e-5 on an H100, 1.4e-5 with this.
//
// d <= D: coordinates past d are zero in x's registers and in the staged
// tile, and add exactly 0 to the distance, so six instances of D (1, 2,
// 3, 4, 8, 16) cover every d <= 16.

constexpr int KF_THREADS = 256;
constexpr int KF_WARPS = KF_THREADS / 32;
constexpr int KF_R = 4;                // rows per thread
constexpr int KF_V = 4;                // columns per step
constexpr int KF_BM = 32 * KF_R;       // rows per block

template <int D>
struct KfShape {
    // floats per staged column: y[0..D), a at D, zero padding to 2 or 4k
    static constexpr int DP = D + 1 <= 2 ? 2 : (D + 1 + 3) / 4 * 4;
    // columns per staged tile: 2 buffers of TN * DP floats stay <= 16 KB,
    // 20 KB at D = 16
    static constexpr int TN = DP <= 4 ? 512 : (DP <= 8 ? 256 : 128);
};

// stage columns j0 .. j0 + cnt of y (d coordinates each) and a into buf;
// the columns cnt .. TN are zero-filled
template <int D>
__device__ __forceinline__ void kf_stage(float* buf, const float* y, const float* a, int j0,
                                         int cnt, int d) {
    constexpr int DP = KfShape<D>::DP, TN = KfShape<D>::TN;
    for (int j = threadIdx.x; j < TN; j += KF_THREADS) {
        const bool live = j < cnt;
        const size_t jg = live ? (size_t)(j0 + j) : 0;
        float* dst = buf + j * DP;
#pragma unroll
        for (int k = 0; k < D; ++k)
            if (k < d) cp_async4(dst + k, y + jg * d + k, live);
        cp_async4(dst + D, a + jg, live);
    }
}

// one staged tile: (acc, comp) += sum over warp w's columns of f(s) a,
// compensated once per KF_GROUP steps
constexpr int KF_GROUP = 4;   // steps (of KF_V columns) per compensated partial sum

template <int D, int FAM, int P, bool RAGGED>
__device__ __forceinline__ void kf_tile(const float* buf, const float (&xr)[KF_R][D],
                                        float (&acc)[KF_R], float (&comp)[KF_R], int cnt,
                                        const FamilyConsts& fc) {
    constexpr int DP = KfShape<D>::DP, TN = KfShape<D>::TN;
    constexpr int STEPS = TN / (KF_WARPS * KF_V);   // a warp's steps in a tile: 4, 8 or 16
    static_assert(STEPS % KF_GROUP == 0, "a tile holds whole groups of steps");
    const int w = threadIdx.x >> 5;
    for (int g = 0; g < STEPS; g += KF_GROUP) {
        float ts[KF_R];   // this group's terms of each row
#pragma unroll
        for (int r = 0; r < KF_R; ++r) ts[r] = 0.f;
#pragma unroll 1   // a step's 16 entries are ILP enough; unrolled steps spill at D = 16
        for (int q = 0; q < KF_GROUP; ++q) {
            const int j = (g + q) * KF_WARPS * KF_V + w * KF_V;
            float st[KF_R];   // this step's KF_V terms of each row
#pragma unroll
            for (int r = 0; r < KF_R; ++r) st[r] = 0.f;
#pragma unroll
            for (int v = 0; v < KF_V; ++v) {
                const float* col = buf + (j + v) * DP;
                float yc[DP];
                if constexpr (DP == 2) {
                    const float2 t = *reinterpret_cast<const float2*>(col);
                    yc[0] = t.x;
                    yc[1] = t.y;
                } else {
#pragma unroll
                    for (int k = 0; k < DP / 4; ++k) {
                        const float4 t = reinterpret_cast<const float4*>(col)[k];
                        yc[4 * k] = t.x;
                        yc[4 * k + 1] = t.y;
                        yc[4 * k + 2] = t.z;
                        yc[4 * k + 3] = t.w;
                    }
                }
                const float av = yc[D];
#pragma unroll
                for (int r = 0; r < KF_R; ++r) {
                    float s = 0.f;
#pragma unroll
                    for (int k = 0; k < D; ++k) {
                        const float t = xr[r][k] - yc[k];
                        s = fmaf(t, t, s);
                    }
                    float f = family_value<FAM, P>(s, fc);
                    if (RAGGED && j + v >= cnt) f = 0.f;   // IMQ(c = 0) is inf at s = 0
                    st[r] = fmaf(f, av, st[r]);
                }
            }
#pragma unroll
            for (int r = 0; r < KF_R; ++r) ts[r] += st[r];
        }
#pragma unroll
        for (int r = 0; r < KF_R; ++r) kahan_add(acc[r], comp[r], ts[r]);
    }
}

// at least 2 blocks an SM: up to 128 registers a thread (ptxas otherwise
// settles at 80 for some D = 8 instances and spills)
template <int D, int FAM, int P>
__global__ void __launch_bounds__(KF_THREADS, 2)
k1_family(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ a,
          float* __restrict__ partial, int n, int m, int d, int cols_per_split,
          const __grid_constant__ FamilyConsts fc) {
    constexpr int DP = KfShape<D>::DP, TN = KfShape<D>::TN;
    __shared__ __align__(16) float ybuf[2][TN * DP];
    __shared__ float red[KF_WARPS][KF_BM];

    // the padding slots of both buffers stay zero; cp.async fills the rest
    for (int t = threadIdx.x; t < 2 * TN * DP; t += KF_THREADS) (&ybuf[0][0])[t] = 0.f;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int row0 = blockIdx.x * KF_BM;
    float xr[KF_R][D];
#pragma unroll
    for (int r = 0; r < KF_R; ++r) {
        const int i = row0 + r * 32 + lane;
#pragma unroll
        for (int k = 0; k < D; ++k) xr[r][k] = (i < n && k < d) ? x[(size_t)i * d + k] : 0.f;
    }

    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    const int tiles = j_end > j_begin ? (j_end - j_begin + TN - 1) / TN : 0;
    float acc[KF_R], comp[KF_R];
#pragma unroll
    for (int r = 0; r < KF_R; ++r) acc[r] = comp[r] = 0.f;

    if (tiles > 0) {
        kf_stage<D>(ybuf[0], y, a, j_begin, min(TN, j_end - j_begin), d);
        cp_async_commit();
    }
    for (int t = 0; t < tiles; ++t) {
        const int j0 = j_begin + t * TN;
        const int cnt = min(TN, j_end - j0);
        if (t + 1 < tiles) {
            kf_stage<D>(ybuf[(t + 1) & 1], y, a, j0 + TN, min(TN, j_end - j0 - TN), d);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();   // tile t has landed for every thread
        if (cnt == TN)
            kf_tile<D, FAM, P, false>(ybuf[t & 1], xr, acc, comp, cnt, fc);
        else
            kf_tile<D, FAM, P, true>(ybuf[t & 1], xr, acc, comp, cnt, fc);
        __syncthreads();   // tile t is consumed before tile t + 2 overwrites it
    }
#pragma unroll
    for (int r = 0; r < KF_R; ++r) red[w][r * 32 + lane] = acc[r] - comp[r];
    __syncthreads();
    if (threadIdx.x < KF_BM) {
        const int i = row0 + threadIdx.x;
        if (i < n) {
            float tot = red[0][threadIdx.x];
#pragma unroll
            for (int c = 1; c < KF_WARPS; ++c) tot += red[c][threadIdx.x];
            partial[(size_t)blockIdx.y * n + i] = fc.scale * tot;
        }
    }
}


// ---------------------------------------------------------------------------
// K1, many columns: B = K A for A of shape (m, p), a one-leaf family, d <= D
// ---------------------------------------------------------------------------
//
// `k1_gramian_matmat_family` is the counterpart, on the card, of cfjax's
// multi-RHS product (cfjax/operators/gramian.py `Gramian._matmat`, which
// stays on XLA's blocked path): the SLQ probe batches (Lanczos, then
// `cg_columns`) push p = 16 columns through every product. The profile of
// each (x_i, y_j) pair is evaluated once, in registers, and contracted into
// C columns of A.
//
// What bounds it: fp32 issue. An entry costs 2d for the distance, the
// profile (MaternP(2): 6 fp32 + 4 for exp2's split argument, 2 MUFU) and C
// FFMAs into the row sums, plus a Kahan step (4) per column and 16 entries:
// at d = 3, C = 16 about 36 fp32 instructions against 2 MUFU, so the SFU,
// K1's limit at one column, is idle half the time.
//
// Register tiles. Thread (warp w, lane l) owns rows l + 32 r (r < R = 2)
// and, for each, C = 16 sums with their compensation and their group sum:
// 96 registers. Warp w takes columns w * 4 + 16 q .. + 3 of each staged
// tile; a column's y and its C entries of A lie together in shared memory
// and every lane of a warp reads them by broadcast (16-byte loads).
//
// Occupancy. An instance holds 146-244 registers a thread (ptxas, H100),
// so the SM's 64K registers hold few threads: blocks of 4 warps let three
// blocks (12 warps) share an SM at <= 170 registers, where blocks of 8
// warps fit one. At n = 2^17, p = 16 that cut the device time by a fifth
// (PERF.md): the kernel is bound by latency more than by issue.
//
// Chunks. Columns of A past C run as further chunks over gridDim.z, each
// evaluating the profile again; a chunk's columns past p (all of them past
// the first p when p < C) are zero-filled in the staged tile and never
// written. Splits over gridDim.y and their fixed-order sum are K1's.

constexpr int KM_THREADS = 128;
constexpr int KM_WARPS = KM_THREADS / 32;
constexpr int KM_V = 4;        // columns per step of a warp
constexpr int KM_GROUP = 4;    // steps per compensated partial sum
constexpr int KM_C = 16;       // columns of A per chunk

template <int D>
struct KmShape {
    static constexpr int C = KM_C;
    static constexpr int R = 32 / C;                  // rows per thread
    static constexpr int BM = 32 * R;                 // rows per block
    static constexpr int DY = (D + 3) / 4 * 4;        // y's floats per staged column
    static constexpr int S = DY + C;                  // floats per staged column
    static constexpr int TN = S <= 20 ? 256 : 128;    // columns per staged tile: <= 40 KB
};

// stage columns j0 .. j0 + cnt of y (d coordinates) and of A's columns
// c0 .. c0 + C into buf; the rest of the tile, and A's columns past p, are
// zero-filled
template <int D>
__device__ __forceinline__ void km_stage(float* buf, const float* y, const float* A, int j0,
                                         int cnt, int d, int p, int c0) {
    using Sh = KmShape<D>;
    constexpr int C = Sh::C;
    for (int j = threadIdx.x; j < Sh::TN; j += KM_THREADS) {
        const bool live = j < cnt;
        const size_t jg = live ? (size_t)(j0 + j) : 0;
        float* dst = buf + j * Sh::S;
#pragma unroll
        for (int k = 0; k < D; ++k)
            if (k < d) cp_async4(dst + k, y + jg * d + k, live);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const bool on = live && c0 + c < p;
            cp_async4(dst + Sh::DY + c, A + (on ? jg * p + c0 + c : 0), on);
        }
    }
}

// one staged tile: (acc, comp)[r][c] += sum over warp w's columns j of
// f(s_rj) A[j][c], compensated once per KM_GROUP steps
template <int D, int FAM, int P, bool RAGGED>
__device__ __forceinline__ void km_tile(const float* buf, const float (&xr)[KmShape<D>::R][D],
                                        float (&acc)[KmShape<D>::R][KM_C],
                                        float (&comp)[KmShape<D>::R][KM_C], int cnt,
                                        const FamilyConsts& fc) {
    using Sh = KmShape<D>;
    constexpr int C = Sh::C, R = Sh::R, DY = Sh::DY, S = Sh::S;
    constexpr int STEPS = Sh::TN / (KM_WARPS * KM_V);   // a warp's steps in a tile: 8 or 16
    static_assert(STEPS % KM_GROUP == 0, "a tile holds whole groups of steps");
    const int w = threadIdx.x >> 5;
    for (int g = 0; g < STEPS; g += KM_GROUP) {
        float ts[R][C];   // this group's terms of each row and column
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c) ts[r][c] = 0.f;
#pragma unroll 1
        for (int q = 0; q < KM_GROUP; ++q) {
            const int jb = (g + q) * KM_WARPS * KM_V + w * KM_V;
#pragma unroll
            for (int v = 0; v < KM_V; ++v) {
                const float* col = buf + (jb + v) * S;
                float yc[DY];
#pragma unroll
                for (int k = 0; k < DY / 4; ++k) {
                    const float4 t = reinterpret_cast<const float4*>(col)[k];
                    yc[4 * k] = t.x;
                    yc[4 * k + 1] = t.y;
                    yc[4 * k + 2] = t.z;
                    yc[4 * k + 3] = t.w;
                }
                float f[R];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    float s = 0.f;
#pragma unroll
                    for (int k = 0; k < D; ++k) {
                        const float t = xr[r][k] - yc[k];
                        s = fmaf(t, t, s);
                    }
                    f[r] = family_value<FAM, P>(s, fc);
                    if (RAGGED && jb + v >= cnt) f[r] = 0.f;   // IMQ(c = 0) is inf at s = 0
                }
#pragma unroll
                for (int c4 = 0; c4 < C / 4; ++c4) {
                    const float4 a4 = reinterpret_cast<const float4*>(col + DY)[c4];
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        ts[r][4 * c4] = fmaf(f[r], a4.x, ts[r][4 * c4]);
                        ts[r][4 * c4 + 1] = fmaf(f[r], a4.y, ts[r][4 * c4 + 1]);
                        ts[r][4 * c4 + 2] = fmaf(f[r], a4.z, ts[r][4 * c4 + 2]);
                        ts[r][4 * c4 + 3] = fmaf(f[r], a4.w, ts[r][4 * c4 + 3]);
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c) kahan_add(acc[r][c], comp[r][c], ts[r][c]);
    }
}

// up to 255 registers a thread (the 96 of the sums, x's R d coordinates, a
// staged column and the profile): as many blocks an SM as they leave room
// for
template <int D, int FAM, int P>
__global__ void __launch_bounds__(KM_THREADS, 1)
k1_matmat_family(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ A, float* __restrict__ partial, int n, int m, int d,
                 int p, int cols_per_split, const __grid_constant__ FamilyConsts fc) {
    using Sh = KmShape<D>;
    constexpr int C = Sh::C, R = Sh::R, BM = Sh::BM, TN = Sh::TN, S = Sh::S;
    static_assert(C % 4 == 0 && R * C == 32, "C sums of R rows: 32 a thread");
    static_assert(KM_WARPS * BM * 4 <= 2 * TN * S, "the reduction reuses the staging buffers");
    __shared__ __align__(16) float buf[2][TN * S];

    for (int t = threadIdx.x; t < 2 * TN * S; t += KM_THREADS) (&buf[0][0])[t] = 0.f;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int row0 = blockIdx.x * BM;
    const int c0 = blockIdx.z * C;
    float xr[R][D];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = row0 + r * 32 + lane;
#pragma unroll
        for (int k = 0; k < D; ++k) xr[r][k] = (i < n && k < d) ? x[(size_t)i * d + k] : 0.f;
    }

    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    const int tiles = j_end > j_begin ? (j_end - j_begin + TN - 1) / TN : 0;
    float acc[R][C], comp[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = comp[r][c] = 0.f;

    if (tiles > 0) {
        km_stage<D>(buf[0], y, A, j_begin, min(TN, j_end - j_begin), d, p, c0);
        cp_async_commit();
    }
    for (int t = 0; t < tiles; ++t) {
        const int j0 = j_begin + t * TN;
        const int cnt = min(TN, j_end - j0);
        if (t + 1 < tiles) {
            km_stage<D>(buf[(t + 1) & 1], y, A, j0 + TN, min(TN, j_end - j0 - TN), d, p, c0);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();   // tile t has landed for every thread
        if (cnt == TN)
            km_tile<D, FAM, P, false>(buf[t & 1], xr, acc, comp, cnt, fc);
        else
            km_tile<D, FAM, P, true>(buf[t & 1], xr, acc, comp, cnt, fc);
        __syncthreads();   // tile t is consumed before tile t + 2 overwrites it
    }

    // the warps' sums of each (row, column), four columns a round, added in
    // warp order through the staging buffer
    float4* red = reinterpret_cast<float4*>(&buf[0][0]);
#pragma unroll
    for (int cq = 0; cq < C; cq += 4) {
        __syncthreads();   // the buffer is free: the last tile, or the last round, is read
#pragma unroll
        for (int r = 0; r < R; ++r)
            red[w * BM + r * 32 + lane] =
                make_float4(acc[r][cq] - comp[r][cq], acc[r][cq + 1] - comp[r][cq + 1],
                            acc[r][cq + 2] - comp[r][cq + 2], acc[r][cq + 3] - comp[r][cq + 3]);
        __syncthreads();
        const float* rf = &buf[0][0];
        for (int t = threadIdx.x; t < BM * 4; t += KM_THREADS) {
            const int i = row0 + t / 4, c = c0 + cq + t % 4;
            if (i < n && c < p) {
                float tot = rf[t];
#pragma unroll
                for (int u = 1; u < KM_WARPS; ++u) tot += rf[u * BM * 4 + t];
                partial[((size_t)blockIdx.y * n + i) * p + c] = fc.scale * tot;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Host entries
// ---------------------------------------------------------------------------

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<D>) for the instance of d: D = d up to 4, then 8 and 16
template <class F>
static int by_dim(int d, F&& f) {
    if (d == 1) return f(Int<1>{});
    if (d == 2) return f(Int<2>{});
    if (d == 3) return f(Int<3>{});
    if (d == 4) return f(Int<4>{});
    if (d >= 5 && d <= 8) return f(Int<8>{});
    if (d >= 9 && d <= 16) return f(Int<16>{});
    return (int)cudaErrorInvalidValue;
}

// f(Int<FAM>, Int<P>) for a one-leaf family and its p
template <class F>
static int by_family(int family, int p, F&& f) {
    switch (family) {
    case FAM_EQ:
        return f(Int<FAM_EQ>{}, Int<0>{});
    case FAM_MATERN:
        switch (p) {
        case 0: return f(Int<FAM_MATERN>{}, Int<0>{});
        case 1: return f(Int<FAM_MATERN>{}, Int<1>{});
        case 2: return f(Int<FAM_MATERN>{}, Int<2>{});
        case 3: return f(Int<FAM_MATERN>{}, Int<3>{});
        default: return (int)cudaErrorInvalidValue;
        }
    case FAM_RQ:
        return f(Int<FAM_RQ>{}, Int<0>{});
    case FAM_CAUCHY:
        return f(Int<FAM_CAUCHY>{}, Int<0>{});
    case FAM_IMQ:
        return f(Int<FAM_IMQ>{}, Int<0>{});
    default:
        return (int)cudaErrorInvalidValue;
    }
}

extern "C" int k1_gramian_matvec_family(const float* x, const float* y, const float* a,
                                        float* partial, float* out, int n, int m, int d,
                                        int splits, int cols_per_split, int family, int p,
                                        FamilyConsts fc, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((n + KF_BM - 1) / KF_BM, splits);
    float* dst = splits == 1 ? out : partial;
    const int bad = by_dim(d, [&](auto Dc) {
        return by_family(family, p, [&](auto F, auto Pc) {
            k1_family<decltype(Dc)::value, decltype(F)::value, decltype(Pc)::value>
                <<<grid, KF_THREADS, 0, st>>>(x, y, a, dst, n, m, d, cols_per_split, fc);
            return 0;
        });
    });
    if (bad) return bad;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch_reduce(partial, out, n, splits, st);
    return (int)cudaGetLastError();
}

// the rows a block, the staged tile's columns and the chunk's columns of A
// of d's many-column instance, for the host's column split
extern "C" int k1_gramian_matmat_shape(int d, int* rows, int* cols, int* chunk) {
    return by_dim(d, [&](auto Dc) {
        using Sh = KmShape<decltype(Dc)::value>;
        *rows = Sh::BM;
        *cols = Sh::TN;
        *chunk = Sh::C;
        return 0;
    });
}

// B (n, p) = K A, A (m, p) row-major, in chunks of KM_C columns
extern "C" int k1_gramian_matmat_family(const float* x, const float* y, const float* A,
                                        float* partial, float* out, int n, int m, int d, int p,
                                        int splits, int cols_per_split, int family, int fam_p,
                                        FamilyConsts fc, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* dst = splits == 1 ? out : partial;
    const int bad = by_dim(d, [&](auto Dc) {
        using Sh = KmShape<decltype(Dc)::value>;
        dim3 grid((n + Sh::BM - 1) / Sh::BM, splits, (p + KM_C - 1) / KM_C);
        return by_family(family, fam_p, [&](auto F, auto Pc) {
            k1_matmat_family<decltype(Dc)::value, decltype(F)::value, decltype(Pc)::value>
                <<<grid, KM_THREADS, 0, st>>>(x, y, A, dst, n, m, d, p, cols_per_split, fc);
            return 0;
        });
    });
    if (bad) return bad;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch_reduce(partial, out, n * p, splits, st);
    return (int)cudaGetLastError();
}
