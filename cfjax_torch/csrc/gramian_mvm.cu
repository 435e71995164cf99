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
#include "tc_tile.cuh"   // cp.async helpers, the tf32 splits and mma.sync

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
//
// The real-nu Matern family's instance copies the table of nu (16 KB) into
// shared memory at the start of each block.

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
                                        const FamilyConsts& fc, const float4* tab) {
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
                    float f = family_value<FAM, P>(s, fc, tab);
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
          const __grid_constant__ FamilyConsts fc, const float4* __restrict__ tab) {
    constexpr int DP = KfShape<D>::DP, TN = KfShape<D>::TN;
    __shared__ __align__(16) float ybuf[2][TN * DP];
    __shared__ float red[KF_WARPS][KF_BM];
    __shared__ float4 mtab[FAM == FAM_MATERN_NU ? MATERN_KNOTS : 1];

    // the padding slots of both buffers stay zero; cp.async fills the rest
    for (int t = threadIdx.x; t < 2 * TN * DP; t += KF_THREADS) (&ybuf[0][0])[t] = 0.f;
    if constexpr (FAM == FAM_MATERN_NU)
        for (int t = threadIdx.x; t < MATERN_KNOTS; t += KF_THREADS) mtab[t] = tab[t];
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
            kf_tile<D, FAM, P, false>(ybuf[t & 1], xr, acc, comp, cnt, fc, mtab);
        else
            kf_tile<D, FAM, P, true>(ybuf[t & 1], xr, acc, comp, cnt, fc, mtab);
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
// multi-RHS product (cfjax/operators/gramian.py `Gramian._matmat`, XLA's
// blocked `kernel_tile @ V` at the configured matmul precision): the SLQ
// probe batches (Lanczos, then `cg_columns`) push p = 16 columns through
// every product. Each entry's profile is evaluated once, on the CUDA cores
// and the SFU as in `k1_family`; the contraction into A's columns runs on
// the tensor cores (mma.sync.m16n8k8 tf32, tc_tile.cuh), at the tier's
// passes (PASSES: 3 for "highest" and "high", 1 for "default").
//
// What bounds it: its least work is the profile's SFU operations, as the
// single-column K1's (MaternP(2): 2 MUFU an entry against 2d + 6 fp32),
// once the product is off the CUDA cores: 2p flops an entry a pass is a
// third of the SFU's time at p = 16 and three passes, at the tensor cores'
// dense rate. On the card the mma.sync passes add to the CUDA-core work
// rather than hide under it: "default" (one pass) runs well below
// "highest" (three), PERF.md. Products with FFMAs (16 an entry) and 32
// compensated sums a thread would make it fp32-issue and latency bound.
//
// Fragments. Warp w owns MT m-tiles of 16 rows (two at d <= 3: a staged
// column's y and B fragments serve 32 rows; 128 registers a thread, two
// blocks of 8 warps an SM) and sweeps every column of its split. For a
// k-step of 8 staged columns, lane (g, t) evaluates f(s) at exactly the
// four A-operand positions it holds in each m-tile, rows g and g + 8
// against columns t and t + 4, so the kernel tile never passes through
// shared memory; f (times the Constant, so that a tier rounds the
// profile's values) is split into tf32 pieces there (split_a) and
// multiplied against the two n-tiles (16 columns of A) of the step, pass
// by pass over the m-tiles and n-tiles.
//
// Staging. A tile of TN columns: y by cp.async, double buffered; A's TN x
// 16 values loaded into registers a tile ahead, then split into tf32
// pieces once for the block and stored in B-fragment order (one 16-byte
// load a lane an n-tile and step, no conflicts). The y reads are
// broadcasts: the 8 lanes of one t read one column.
//
// Sums. The mma accumulators (MT x 2 x 4 a thread) take a tile's TN / 8
// steps; then they are added into compensated (Kahan) row sums, once a
// tile. Each output (row, column) belongs to one thread: no reduction
// across warps, no atomics. Splits over gridDim.y and their fixed-order
// sum are K1's; chunks of 16 columns of A run over gridDim.z, each
// evaluating the profile again; columns past p are zero in the staged
// fragments and never written.

constexpr int KT_THREADS = 256;
constexpr int KT_WARPS = KT_THREADS / 32;
constexpr int KT_C = 16;            // columns of A a chunk
constexpr int KT_NT = KT_C / 8;     // n-tiles a chunk

template <int D>
struct KtShape {
    static constexpr int MT = D <= 3 ? 2 : 1;            // m-tiles (16 rows) a warp
    static constexpr int BM = KT_WARPS * 16 * MT;        // rows a block
    static constexpr int DY = (D + 3) / 4 * 4;           // y's floats a staged column
    static constexpr int TN = D <= 8 ? 128 : 64;         // columns a staged tile
    static constexpr int KS = TN / 8;                    // k-steps a tile
    static constexpr int AV = TN * KT_C / KT_THREADS;    // A's values a thread stages
    static constexpr int MIN_BLOCKS = D <= 8 ? 2 : 1;   // 128 registers a thread at D <= 8
};

// one staged tile's k-steps: cf[mt][nt] += K(rows, tile) A(tile, chunk)
template <int D, int FAM, int P, int PASSES, bool RAGGED>
__device__ __forceinline__ void kt_tile(const float* ybuf, const uint32_t* bfrag,
                                        const float (&xr)[KtShape<D>::MT][2][D],
                                        float (&cf)[KtShape<D>::MT][KT_NT][4], int cnt,
                                        const FamilyConsts& fc, const float4* tab) {
    using Sh = KtShape<D>;
    constexpr int MT = Sh::MT, DY = Sh::DY, NP = tc_pieces(PASSES);
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int steps = RAGGED ? (cnt + 7) >> 3 : Sh::KS;
#pragma unroll 1
    for (int ks = 0; ks < steps; ++ks) {
        uint32_t b[KT_NT][2 * NP];
#pragma unroll
        for (int nt = 0; nt < KT_NT; ++nt) {
            const uint32_t* src = bfrag + ((ks * KT_NT + nt) * 32 + lane) * 2 * NP;
            if constexpr (NP == 2) {
                const uint4 v = *reinterpret_cast<const uint4*>(src);
                b[nt][0] = v.x; b[nt][1] = v.y; b[nt][2] = v.z; b[nt][3] = v.w;
            } else {
                const uint2 v = *reinterpret_cast<const uint2*>(src);
                b[nt][0] = v.x; b[nt][1] = v.y;
            }
        }
        // s of rows (g, g + 8) of each m-tile against columns 8 ks + t, + 4
        float s[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
            const float* col = ybuf + (8 * ks + t + 4 * ch) * DY;
#pragma unroll
            for (int k4 = 0; k4 < DY / 4; ++k4) {
                const float4 y4 = reinterpret_cast<const float4*>(col)[k4];
                const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    if (4 * k4 + kk >= D) break;
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int rh = 0; rh < 2; ++rh) {
                            const float u = xr[mt][rh][4 * k4 + kk] - yv[kk];
                            s[mt][2 * ch + rh] = fmaf(u, u, s[mt][2 * ch + rh]);
                        }
                }
            }
        }
        // A-operand order: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        uint32_t a[MT][NP * 4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                // the Constant inside f, as the profile carries it: a tier's
                // tf32 roundings are those of the profile's values
                v[e] = fc.scale * family_value<FAM, P>(s[mt][e], fc, tab);
                // past the tile's columns: IMQ(c = 0) is inf at s = 0
                if (RAGGED && 8 * ks + t + 4 * (e >> 1) >= cnt) v[e] = 0.f;
            }
            split_a<NP>(v, a[mt]);
        }
        // pass by pass over the MT x 2 accumulators, so that consecutive
        // products are independent (each pass adds into the last one's sum,
        // smallest first, as mma_passes)
#pragma unroll
        for (int u = 0; u < PASSES; ++u)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < KT_NT; ++nt)
                    mma_tf32(cf[mt][nt], a[mt] + 4 * tc_piece_a(PASSES, u),
                             b[nt] + 2 * tc_piece_b(PASSES, u));
    }
}

template <int D, int FAM, int P, int PASSES>
__global__ void __launch_bounds__(KT_THREADS, KtShape<D>::MIN_BLOCKS)
k1_matmat_family(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ A, float* __restrict__ partial, int n, int m, int d,
                 int p, int cols_per_split, const __grid_constant__ FamilyConsts fc,
                 const float4* __restrict__ tab) {
    using Sh = KtShape<D>;
    constexpr int MT = Sh::MT, DY = Sh::DY, TN = Sh::TN, AV = Sh::AV;
    constexpr int NP = tc_pieces(PASSES);
    __shared__ __align__(16) float ybuf[2][TN * DY];
    __shared__ __align__(16) uint32_t bfrag[Sh::KS * KT_NT * 32 * 2 * NP];
    __shared__ float4 mtab[FAM == FAM_MATERN_NU ? MATERN_KNOTS : 1];

    if constexpr (FAM == FAM_MATERN_NU)
        for (int t = threadIdx.x; t < MATERN_KNOTS; t += KT_THREADS) mtab[t] = tab[t];

    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
    const int row0 = blockIdx.x * Sh::BM + w * 16 * MT;
    const int c0 = blockIdx.z * KT_C;
    float xr[MT][2][D];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
            const int i = row0 + 16 * mt + 8 * rh + g;
#pragma unroll
            for (int k = 0; k < D; ++k)
                xr[mt][rh][k] = (i < n && k < d) ? x[(size_t)i * d + k] : 0.f;
        }

    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    const int tiles = j_end > j_begin ? (j_end - j_begin + TN - 1) / TN : 0;
    float acc[MT][KT_NT][4], comp[MT][KT_NT][4], cf[MT][KT_NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < KT_NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = comp[mt][nt][e] = cf[mt][nt][e] = 0.f;

    // y's columns j0 .. j0 + cnt into buf (zero past cnt and past d)
    auto stage_y = [&](float* buf, int j0, int cnt) {
        for (int e = threadIdx.x; e < TN * DY; e += KT_THREADS) {
            const int j = e / DY, k = e % DY;
            const bool live = j < cnt && k < d;
            cp_async4(buf + e, live ? y + (size_t)(j0 + j) * d + k : y, live);
        }
    };
    // A's rows j0 .. j0 + cnt, columns c0 .. c0 + KT_C, into registers
    float av[AV];
    auto load_a = [&](int j0, int cnt) {
#pragma unroll
        for (int u = 0; u < AV; ++u) {
            const int e = threadIdx.x + u * KT_THREADS, j = e / KT_C, c = e % KT_C;
            av[u] = (j < cnt && c0 + c < p) ? A[(size_t)(j0 + j) * p + c0 + c] : 0.f;
        }
    };

    if (tiles > 0) {
        stage_y(ybuf[0], j_begin, min(TN, j_end - j_begin));
        cp_async_commit();
        load_a(j_begin, min(TN, j_end - j_begin));
    }
    for (int t = 0; t < tiles; ++t) {
        const int j0 = j_begin + t * TN;
        const int cnt = min(TN, j_end - j0);
        __syncthreads();   // tile t - 1 is consumed: the fragments and ybuf[(t + 1) & 1] are free
        // A's tile t in tf32 pieces, in B-fragment order: b0 (t, g), b1 (t + 4, g)
        // of the n-tile's 8 x 8 (column j, column c) block, for lane 4 g + t
#pragma unroll
        for (int u = 0; u < AV; ++u) {
            const int e = threadIdx.x + u * KT_THREADS, j = e / KT_C, c = e % KT_C;
            const int kk = j & 7, ln = 4 * (c & 7) + (kk & 3);
            uint32_t pc[NP];
            tf32_split<NP>(av[u], pc);
            uint32_t* dst = bfrag + (((j >> 3) * KT_NT + (c >> 3)) * 32 + ln) * 2 * NP + (kk >> 2);
#pragma unroll
            for (int q = 0; q < NP; ++q) dst[2 * q] = pc[q];
        }
        if (t + 1 < tiles) {
            stage_y(ybuf[(t + 1) & 1], j0 + TN, min(TN, j_end - j0 - TN));
            cp_async_commit();
            load_a(j0 + TN, min(TN, j_end - j0 - TN));
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();   // tile t's y and fragments are in place for every thread
        if (cnt == TN)
            kt_tile<D, FAM, P, PASSES, false>(ybuf[t & 1], bfrag, xr, cf, cnt, fc, mtab);
        else
            kt_tile<D, FAM, P, PASSES, true>(ybuf[t & 1], bfrag, xr, cf, cnt, fc, mtab);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < KT_NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    kahan_add(acc[mt][nt][e], comp[mt][nt][e], cf[mt][nt][e]);
                    cf[mt][nt][e] = 0.f;
                }
    }
    // C-fragment order: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < KT_NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = row0 + 16 * mt + 8 * (e >> 1) + g;
                const int c = c0 + 8 * nt + 2 * tq + (e & 1);
                if (i < n && c < p)
                    partial[((size_t)blockIdx.y * n + i) * p + c] =
                        acc[mt][nt][e] - comp[mt][nt][e];
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
    case FAM_MATERN_NU:
        return f(Int<FAM_MATERN_NU>{}, Int<0>{});
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// f(Int<PASSES>) for a tier's tensor-core passes
template <class F>
static int by_passes(int passes, F&& f) {
    if (passes == 1) return f(Int<1>{});
    if (passes == 3) return f(Int<3>{});
    return (int)cudaErrorInvalidValue;
}

extern "C" int k1_gramian_matvec_family(const float* x, const float* y, const float* a,
                                        float* partial, float* out, int n, int m, int d,
                                        int splits, int cols_per_split, int family, int p,
                                        FamilyConsts fc, const float4* tab, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((n + KF_BM - 1) / KF_BM, splits);
    float* dst = splits == 1 ? out : partial;
    if (family == FAM_MATERN_NU && tab == nullptr) return (int)cudaErrorInvalidValue;
    const int bad = by_dim(d, [&](auto Dc) {
        return by_family(family, p, [&](auto F, auto Pc) {
            k1_family<decltype(Dc)::value, decltype(F)::value, decltype(Pc)::value>
                <<<grid, KF_THREADS, 0, st>>>(x, y, a, dst, n, m, d, cols_per_split, fc, tab);
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
        using Sh = KtShape<decltype(Dc)::value>;
        *rows = Sh::BM;
        *cols = Sh::TN;
        *chunk = KT_C;
        return 0;
    });
}

// B (n, p) = K A, A (m, p) row-major, in chunks of KT_C columns, the
// product at `passes` tf32 passes (1 or 3)
extern "C" int k1_gramian_matmat_family(const float* x, const float* y, const float* A,
                                        float* partial, float* out, int n, int m, int d, int p,
                                        int splits, int cols_per_split, int family, int fam_p,
                                        int passes, FamilyConsts fc, const float4* tab,
                                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* dst = splits == 1 ? out : partial;
    if (family == FAM_MATERN_NU && tab == nullptr) return (int)cudaErrorInvalidValue;
    const int bad = by_dim(d, [&](auto Dc) {
        using Sh = KtShape<decltype(Dc)::value>;
        dim3 grid((n + Sh::BM - 1) / Sh::BM, splits, (p + KT_C - 1) / KT_C);
        return by_family(family, fam_p, [&](auto F, auto Pc) {
            return by_passes(passes, [&](auto PS) {
                k1_matmat_family<decltype(Dc)::value, decltype(F)::value, decltype(Pc)::value,
                                 decltype(PS)::value>
                    <<<grid, KT_THREADS, 0, st>>>(x, y, A, dst, n, m, d, p, cols_per_split, fc,
                                                  tab);
                return 0;
            });
        });
    });
    if (bad) return bad;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch_reduce(partial, out, n * p, splits, st);
    return (int)cudaGetLastError();
}
