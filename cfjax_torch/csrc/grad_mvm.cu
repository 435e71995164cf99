// K3: the gradient-gramian block MVM for NVIDIA Hopper (sm_90a), on the
// tensor cores. Plain C interface, loaded with ctypes by
// cfjax_torch/ops/grad_mvm.py, which also holds its plain torch version
// `grad_matvec_plain`.
//
// Replaces cfjax/ops/pallas_mvm.py `pallas_grad_matvec` (body
// `_grad_mvm_kernel`, derivatives by `_tile_d2`). For x (n, d), y (m, d)
// and A (m, d) it computes out (n, d), out_i = sum_j B_ij A_j with the
// d x d block B_ij = grad_x grad_y^T k(x_i, y_j) in closed form:
//   iso (s = |r|^2, r = x_i - y_j, w = <r, A_j>):
//     out_i = sum_j [-2 f'(s) A_j - 4 f''(s) w r]
//           = sum_j alpha_ij A_j + sum_j beta_ij y_j - (sum_j beta_ij) x_i,
//     alpha = -2 f', beta = 4 f'' w;
//   dot (s = <x_i, y_j>, w = <x_i, A_j>):
//     out_i = sum_j [f'(s) A_j + f''(s) w y_j],  alpha = f', beta = f'' w.
// Four GEMM-shaped products per tile, as in the Pallas kernel, all on the
// tensor cores (mma.sync m16n8k8 tf32, tc_tile.cuh), at the tier's passes
// (ops/tiles.py TIER_PASSES: 1 for "default", 3 for "high" and "highest"):
//   A. S = X Y^T and Q = X A^T over d (`tc_tile`), for a block of 128 rows
//      (16 a warp) and a tile of 64 columns; iso: s = |x|^2 + |y|^2 - 2 S,
//      w = Q - <y_j, A_j> (the norms come from the wrapper). Each tile's
//      first chunk is staged during the previous tile's phases B and C;
//   B. f', f'' of s in registers: the family instances (`family_jet`,
//      one-leaf EQ, MaternP(1..3), RQ, Cauchy, IMQ, and the real-nu
//      Matern's, whose two tables are staged in shared memory once a
//      block) or the interpreter (`eval_jet`) for any other derivative
//      spec; alpha and beta go to the warp's rows in shared memory;
//   C. out[rows, :] += [alpha | beta] [A_tile; Y_tile] - rowsum(beta) x_i,
//      in chunks of 32 output columns staged in shared memory (double
//      buffered; the first chunk lands during phase B). A chunk's sum is
//      added into the block's own rows of its split's partial output in
//      device memory (one writer, no atomics).
// Near-coincident pairs. The expansion |x|^2 + |y|^2 - 2 x.y cancels where
// s << |x|^2 + |y|^2 (at s = 0 it leaves ~eps |x|^2, and -2 f'(0) I is the
// whole diagonal block: at the README's configuration, MaternP(2) with
// n = d = 1024 standard normal points, the off-diagonal blocks underflow
// and that error was the whole error, 1.4e-4 with full fp32 products), and
// so do w = Q - <y, A> and beta y - rowsum(beta) x. Every pair with
// s <= tau (|x_i|^2 + |y_j|^2), tau = 2^-6, leaves the GEMMs (alpha = beta
// = 0) and its s, w and whole contribution are recomputed in difference
// form on the CUDA cores by its warp, after the tile's phase C, in a fixed
// order. Elsewhere the relative error of s is below ~2^-11 / tau (one
// pass) or 2^-22 / tau (three), and of w below its square root.
// A second kernel adds the splits' partial outputs in a fixed order with
// Kahan compensation: the result repeats bit for bit from run to run.
//
// Bounds on this card: 8 d flops per pair in the four products, over the
// tensor cores' 495 TFLOP/s dense tf32 times the tier's passes, against
// the per-pair fp32 work (expansion, jet, alpha / beta, the tau test) over
// 33.45 T instructions/s and the jet's SFU operations over 4.18 T/s. No
// library GEMM: the products are mma.sync instructions in this file.

#include "profile_spec.cuh"
#include "tc_tile.cuh"

constexpr int K3_WARPS = 8;
constexpr int K3_THREADS = 32 * K3_WARPS;
constexpr int K3_TM = 16 * K3_WARPS;   // rows per block
constexpr int K3_TN = 64;              // columns per tile
constexpr int K3_NT = K3_TN / 8;       // their n-tiles
constexpr int K3_DC = 32;              // output columns per phase-C chunk
constexpr int K3_NC = K3_DC / 8;       // their n-tiles
constexpr int K3_SC = K3_DC + 8;       // staged row stride: lanes' words 40 t + g, 32 banks
constexpr int K3_SA = K3_TN + 4;       // coefficient row stride: words 68 g + t, 32 banks
constexpr float K3_TAU = 1.f / 64.f;   // the near-coincident threshold

struct K3Coef {   // two buffers of A and y columns for phase C
    float Ac[2][K3_TN][K3_SC];
    float Yc[2][K3_TN][K3_SC];
};
// the block's shared memory (dynamic, 153 KB): the phase-A stage and the
// phase-C buffers apart, so that each can fill while the other is read;
// each warp's alpha and beta (16 rows x 64 columns each), the A operand of
// phase C (in registers they and phase C's fragments spilled)
struct K3Shared {
    TcStage<K3_TM, K3_TN, 2> st;
    K3Coef cf;
    float coef[K3_WARPS][2][16][K3_SA];
    ProfileSpec sp;
    float x2s[K3_TM], y2s[K3_TN], yas[K3_TN];
};
// the real-nu Matern jet family's two tables (2 x MATERN_JET_KNOTS float4,
// 40 KiB) follow K3Shared in the dynamic shared memory, 16-byte aligned:
// 194 KB in all, within the SM's 227 KB
constexpr size_t K3_TAB_OFF = (sizeof(K3Shared) + 15) / 16 * 16;
constexpr size_t K3_MATERN_SMEM = K3_TAB_OFF + 2 * MATERN_JET_KNOTS * sizeof(float4);

// f', f'' of V arguments: the family in registers, or the interpreter one
// argument at a time in a loop (one inlined copy of the interpreter: wider
// or unrolled decodes took more registers than the tile left)
template <int FAM, int P, int V>
__device__ __forceinline__ void k3_jet(const ProfileSpec& sp, const JetConsts& jc,
                                       const float4* tab, const float (&s)[V], float (&f1)[V],
                                       float (&f2)[V]) {
    if constexpr (FAM == 0) {
#pragma unroll 1
        for (int h = 0; h < V; ++h) {
            const float sh[1] = {s[h]};
            float g1[1], g2[1];
            eval_jet<1>(sp, sh, g1, g2);
            f1[h] = g1[0];
            f2[h] = g2[0];
        }
    } else {
#pragma unroll
        for (int v = 0; v < V; ++v) family_jet<FAM, P>(s[v], jc, f1[v], f2[v], tab);
    }
}

// stage columns c0 .. c0 + K3_DC of the tile's A and y rows into buffer b
__device__ __forceinline__ void k3_stage_c(K3Coef& sc, int b, const float* y, const float* A,
                                           int d, int j0, int cnt, int c0, bool vec4) {
    stage_rows<K3_TN, K3_DC, K3_SC, K3_THREADS>(&sc.Ac[b][0][0], A, j0 + cnt, d, j0, c0, vec4);
    stage_rows<K3_TN, K3_DC, K3_SC, K3_THREADS>(&sc.Yc[b][0][0], y, j0 + cnt, d, j0, c0, vec4);
    cp_async_commit();
}

template <bool ISO, int FAM, int P, int PASSES>
__global__ void __launch_bounds__(K3_THREADS, 1)
k3_tc(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ A,
      const float* __restrict__ x2, const float* __restrict__ y2, const float* __restrict__ ya,
      float* __restrict__ partial, int n, int m, int d, int cols_per_split, int vec4,
      const __grid_constant__ ProfileSpec spec, const __grid_constant__ JetConsts jc,
      const float4* __restrict__ tab) {
    constexpr int NP = tc_pieces(PASSES);
    constexpr unsigned FULL = 0xffffffffu;
    extern __shared__ __align__(16) unsigned char k3_smem[];
    K3Shared& sh = *reinterpret_cast<K3Shared*>(k3_smem);
    auto& st = sh.st;
    auto& cf = sh.cf;
    auto& sp = sh.sp;
    float(*coef)[16][K3_SA] = sh.coef[threadIdx.x >> 5];   // this warp's alpha, beta
    float* x2s = sh.x2s;
    float* y2s = sh.y2s;
    float* yas = sh.yas;
    float4* mtab = reinterpret_cast<float4*>(k3_smem + K3_TAB_OFF);

    if constexpr (FAM == 0) load_spec(sp, spec);
    // the tables land before the first tile's barriers, ahead of any read
    if constexpr (FAM == FAM_MATERN_NU)
        for (int r = threadIdx.x; r < 2 * MATERN_JET_KNOTS; r += K3_THREADS) mtab[r] = tab[r];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * K3_TM;
    const int ra = 16 * w + g, rb = ra + 8;   // this thread's rows in the block
    float* out = partial + (size_t)blockIdx.y * n * d;
    if (ISO)
        for (int r = threadIdx.x; r < K3_TM; r += K3_THREADS)
            x2s[r] = row0 + r < n ? x2[row0 + r] : 0.f;

    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    int q = 0;   // the staged chunks' counter (tc_tile)
    for (int j0 = j_begin; j0 < j_end; j0 += K3_TN) {
        const int cnt = min(K3_TN, j_end - j0);
        const int next = j0 + K3_TN, next_cnt = next < j_end ? min(K3_TN, j_end - next) : 0;
        // the previous tile read these before its phase C's barriers
        if (ISO)
            for (int r = threadIdx.x; r < K3_TN; r += K3_THREADS) {
                y2s[r] = r < cnt ? y2[j0 + r] : 0.f;
                yas[r] = r < cnt ? ya[j0 + r] : 0.f;
            }

        // ---- A: S = X Y^T, Q = X A^T; the next tile's first chunk in flight ----
        float S[2][K3_NT][4];
        tc_tile<K3_TM, K3_TN, 2, K3_THREADS, PASSES>(st, q, j0 != j_begin, x, y, A, n, d, row0,
                                                     j0, cnt, next, next_cnt, vec4, S);
        k3_stage_c(cf, 0, y, A, d, j0, cnt, 0, vec4);   // phase C's first chunk

        // ---- B: alpha and beta, one n-tile at a time, in the warp's shared
        //      memory (S and Q go there first: the n-tiles' jets unrolled
        //      together took every register); near pairs flagged ----
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int nt = 0; nt < K3_NT; ++nt) {
                *reinterpret_cast<float2*>(&coef[m][g][8 * nt + 2 * t]) =
                    make_float2(S[m][nt][0], S[m][nt][1]);
                *reinterpret_cast<float2*>(&coef[m][g + 8][8 * nt + 2 * t]) =
                    make_float2(S[m][nt][2], S[m][nt][3]);
            }
        __syncwarp();
        uint32_t near = 0;
        float gsa = 0.f, gsb = 0.f;   // this thread's share of rowsum(beta), rows ra, rb
#pragma unroll 1
        for (int nt = 0; nt < K3_NT; ++nt) {
            float2* cs[2][2] = {{reinterpret_cast<float2*>(&coef[0][g][8 * nt + 2 * t]),
                                 reinterpret_cast<float2*>(&coef[0][g + 8][8 * nt + 2 * t])},
                                {reinterpret_cast<float2*>(&coef[1][g][8 * nt + 2 * t]),
                                 reinterpret_cast<float2*>(&coef[1][g + 8][8 * nt + 2 * t])}};
            const float2 sa = *cs[0][0], sb = *cs[0][1], qa = *cs[1][0], qb = *cs[1][1];
            const float sv[4] = {sa.x, sa.y, sb.x, sb.y}, qv[4] = {qa.x, qa.y, qb.x, qb.y};
            float s[4], wv[4], f1[4], f2[4], al[4], be[4];
            bool ok[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e < 2 ? ra : rb, j = 8 * nt + 2 * t + (e & 1);
                ok[e] = row0 + r < n && j < cnt;
                if (ISO) {
                    const float q = x2s[r] + y2s[j];
                    const float se = q - 2.f * sv[e];
                    if (ok[e] && se <= K3_TAU * q) {
                        near |= 1u << (4 * nt + e);
                        ok[e] = false;
                    }
                    s[e] = fmaxf(se, 0.f);
                    wv[e] = qv[e] - yas[j];
                } else {
                    s[e] = sv[e];
                    wv[e] = qv[e];
                }
            }
            k3_jet<FAM, P, 4>(sp, jc, mtab, s, f1, f2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                al[e] = ok[e] ? (ISO ? -2.f * f1[e] : f1[e]) : 0.f;
                be[e] = ok[e] ? (ISO ? 4.f : 1.f) * f2[e] * wv[e] : 0.f;
            }
            gsa += be[0] + be[1];
            gsb += be[2] + be[3];
            *cs[0][0] = make_float2(al[0], al[1]);
            *cs[0][1] = make_float2(al[2], al[3]);
            *cs[1][0] = make_float2(be[0], be[1]);
            *cs[1][1] = make_float2(be[2], be[3]);
        }
        __syncwarp();   // the warp reads back only its own rows
        if (ISO) {   // the row sums over the quad's four lanes (same rows)
            gsa += __shfl_xor_sync(FULL, gsa, 1);
            gsb += __shfl_xor_sync(FULL, gsb, 1);
            gsa += __shfl_xor_sync(FULL, gsa, 2);
            gsb += __shfl_xor_sync(FULL, gsb, 2);
        }

        // ---- C: out += alpha A + beta Y - rowsum(beta) x, 32 columns at a time,
        //      the next chunk in flight while one is consumed ----
        for (int c0 = 0, cb = 0; c0 < d; c0 += K3_DC, cb ^= 1) {
            float acc[K3_NC][4];
#pragma unroll
            for (int nc = 0; nc < K3_NC; ++nc)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = row0 + (e < 2 ? ra : rb), k = c0 + 8 * nc + 2 * t + (e & 1);
                    acc[nc][e] = (ISO && i < n && k < d)
                                     ? -(e < 2 ? gsa : gsb) * x[(size_t)i * d + k] : 0.f;
                }
            if (c0 + K3_DC < d) {
                k3_stage_c(cf, cb ^ 1, y, A, d, j0, cnt, c0 + K3_DC, vec4);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();   // the chunk has landed
#pragma unroll
            for (int ks = 0; ks < 2 * K3_NT; ++ks) {
                // columns 8 (ks % 8) .. + 7 of alpha (ks < 8) or beta, as an A fragment
                float v[4];
                load_a_rowmajor(&coef[ks / K3_NT][0][8 * (ks % K3_NT)], K3_SA, v);
                uint32_t a[NP * 4];
                split_a<NP>(v, a);
                const float(*B)[K3_SC] = ks < K3_NT ? cf.Ac[cb] : cf.Yc[cb];
                const int kb = 8 * (ks % K3_NT) + t;   // b0 (t, g) = B[kb][8 nc + g]
#pragma unroll
                for (int nc = 0; nc < K3_NC; ++nc) {
                    if (c0 + 8 * nc < d) {   // warp-uniform: n-tiles past d are skipped
                        uint32_t bf[NP * 2];
                        split_b<NP>(B[kb][8 * nc + g], B[kb + 4][8 * nc + g], bf);
                        mma_passes<PASSES>(acc[nc], a, bf);
                    }
                }
                asm volatile("" ::: "memory");   // as in tc_tile: no hoisted fragments
            }
#pragma unroll
            for (int nc = 0; nc < K3_NC; ++nc)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = row0 + (e < 2 ? ra : rb), k = c0 + 8 * nc + 2 * t + (e & 1);
                    if (i < n && k < d) {
                        float* o = out + (size_t)i * d + k;
                        *o = (j0 == j_begin) ? acc[nc][e] : *o + acc[nc][e];
                    }
                }
            __syncthreads();   // the chunk is consumed before chunk + 2 reuses its buffer
        }

        // ---- the near pairs: difference form on the CUDA cores ----
        if (ISO) {
            uint32_t mask = near;
            unsigned pending = __ballot_sync(FULL, mask != 0);
            while (pending) {   // lanes in order, each lane's pairs in order
                const int L = __ffs(pending) - 1;
                const int bit = __ffs(__shfl_sync(FULL, mask, L)) - 1;
                if (lane == L) mask &= mask - 1;
                const int e = bit & 3;
                const int i = row0 + 16 * w + (L >> 2) + (e >= 2 ? 8 : 0);
                const int j = j0 + 8 * (bit >> 2) + 2 * (L & 3) + (e & 1);
                const float* xi = x + (size_t)i * d;
                const float* yj = y + (size_t)j * d;
                const float* Aj = A + (size_t)j * d;
                float s1[1] = {0.f}, wv = 0.f;
                if (vec4) {   // 16-byte loads, all of a lane's issued together
#pragma unroll 4
                    for (int k = 4 * lane; k < d; k += 128) {
                        const float4 xv = *reinterpret_cast<const float4*>(xi + k);
                        const float4 yv = *reinterpret_cast<const float4*>(yj + k);
                        const float4 av = *reinterpret_cast<const float4*>(Aj + k);
                        const float df[4] = {xv.x - yv.x, xv.y - yv.y, xv.z - yv.z, xv.w - yv.w};
                        const float ac[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            s1[0] = fmaf(df[u], df[u], s1[0]);
                            wv = fmaf(df[u], ac[u], wv);
                        }
                    }
                } else {
#pragma unroll 4
                    for (int k = lane; k < d; k += 32) {
                        const float df = xi[k] - yj[k];
                        s1[0] = fmaf(df, df, s1[0]);
                        wv = fmaf(df, Aj[k], wv);
                    }
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    s1[0] += __shfl_xor_sync(FULL, s1[0], o);
                    wv += __shfl_xor_sync(FULL, wv, o);
                }
                float f1[1], f2[1];
                k3_jet<FAM, P, 1>(sp, jc, mtab, s1, f1, f2);
                const float al = -2.f * f1[0], be = 4.f * f2[0] * wv;
                float* o = out + (size_t)i * d;
                if (vec4) {
#pragma unroll 4
                    for (int k = 4 * lane; k < d; k += 128) {
                        const float4 xv = *reinterpret_cast<const float4*>(xi + k);
                        const float4 yv = *reinterpret_cast<const float4*>(yj + k);
                        const float4 av = *reinterpret_cast<const float4*>(Aj + k);
                        float4 ov = *reinterpret_cast<float4*>(o + k);
                        ov.x = fmaf(al, av.x, fmaf(be, yv.x - xv.x, ov.x));
                        ov.y = fmaf(al, av.y, fmaf(be, yv.y - xv.y, ov.y));
                        ov.z = fmaf(al, av.z, fmaf(be, yv.z - xv.z, ov.z));
                        ov.w = fmaf(al, av.w, fmaf(be, yv.w - xv.w, ov.w));
                        *reinterpret_cast<float4*>(o + k) = ov;
                    }
                } else {
#pragma unroll 4
                    for (int k = lane; k < d; k += 32)
                        o[k] = fmaf(al, Aj[k], fmaf(be, yj[k] - xi[k], o[k]));
                }
                pending = __ballot_sync(FULL, mask != 0);
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

struct K3Args {
    const float *x, *y, *A, *x2, *y2, *ya;
    float* partial;
    int n, m, d, cols_per_split, vec4;
    const float4* tab;
};

template <bool ISO, int FAM, int P, int PASSES>
static int k3_go(dim3 grid, cudaStream_t st, const K3Args& g, const ProfileSpec& spec,
                 const JetConsts& jc) {
    constexpr size_t smem = FAM == FAM_MATERN_NU ? K3_MATERN_SMEM : sizeof(K3Shared);
    if (FAM == FAM_MATERN_NU && g.tab == nullptr) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        k3_tc<ISO, FAM, P, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    k3_tc<ISO, FAM, P, PASSES><<<grid, K3_THREADS, smem, st>>>(
        g.x, g.y, g.A, g.x2, g.y2, g.ya, g.partial, g.n, g.m, g.d, g.cols_per_split, g.vec4, spec,
        jc, g.tab);
    return 0;
}

template <int PASSES>
static int k3_by_family(int iso, int family, int p, dim3 grid, cudaStream_t st,
                        const K3Args& g, const ProfileSpec& spec, const JetConsts& jc) {
    if (!iso)
        return family == 0 ? k3_go<false, 0, 0, PASSES>(grid, st, g, spec, jc)
                           : (int)cudaErrorInvalidValue;
    switch (family) {
    case 0: return k3_go<true, 0, 0, PASSES>(grid, st, g, spec, jc);
    case FAM_EQ: return k3_go<true, FAM_EQ, 0, PASSES>(grid, st, g, spec, jc);
    case FAM_MATERN:
        switch (p) {
        case 1: return k3_go<true, FAM_MATERN, 1, PASSES>(grid, st, g, spec, jc);
        case 2: return k3_go<true, FAM_MATERN, 2, PASSES>(grid, st, g, spec, jc);
        case 3: return k3_go<true, FAM_MATERN, 3, PASSES>(grid, st, g, spec, jc);
        default: return (int)cudaErrorInvalidValue;
        }
    case FAM_RQ: return k3_go<true, FAM_RQ, 0, PASSES>(grid, st, g, spec, jc);
    case FAM_CAUCHY: return k3_go<true, FAM_CAUCHY, 0, PASSES>(grid, st, g, spec, jc);
    case FAM_IMQ: return k3_go<true, FAM_IMQ, 0, PASSES>(grid, st, g, spec, jc);
    case FAM_MATERN_NU: return k3_go<true, FAM_MATERN_NU, 0, PASSES>(grid, st, g, spec, jc);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int k3_grad_matvec(const float* x, const float* y, const float* A, const float* x2,
                              const float* y2, const float* ya, float* partial, float* out,
                              int n, int m, int d, int iso, int splits, int cols_per_split,
                              int passes, int family, int p, int vec4, ProfileSpec spec,
                              JetConsts jc, const float4* tab, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((n + K3_TM - 1) / K3_TM, splits);
    const K3Args g{x, y, A, x2, y2, ya, partial, n, m, d, cols_per_split, vec4, tab};
    int bad;
    switch (passes) {
    case 1: bad = k3_by_family<1>(iso, family, p, grid, st, g, spec, jc); break;
    case 3: bad = k3_by_family<3>(iso, family, p, grid, st, g, spec, jc); break;
    default: bad = (int)cudaErrorInvalidValue;
    }
    if (bad) return bad;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (splits > 1) {
        const long long total = (long long)n * d;
        k3_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(partial, out, total, splits);
    }
    return (int)cudaGetLastError();
}
