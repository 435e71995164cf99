// K2: the expansion-form Gramian MVM b = K a for NVIDIA Hopper (sm_90a), on
// the tensor cores. Plain C interface, loaded with ctypes by
// cfjax_torch/ops/gramian_mvm.py, which also holds its plain torch version
// `gramian_matvec_expand_plain`.
//
// Replaces cfjax/ops/pallas_mvm.py `pallas_gramian_matvec` / `_mvm_kernel`:
// isotropic kernels at any d through s = ||x||^2 + ||y||^2 - 2 x.y (clamped
// at 0; the norms come from the wrapper), dot-product kernels through
// s = x.y. The x.y tile is K3's phase A (tc_tile.cuh `tc_tile`: mma.sync
// m16n8k8 tf32 at the tier's passes, 64 rows a block, 16 a warp, 64
// columns a tile); the profile of each entry follows in registers — a
// one-leaf profile's family form (`family_value`, the families K1 takes:
// EQ, Exp, MaternP(p <= 3), RQ, Cauchy, IMQ, and the real-nu Matern's,
// whose table is staged in shared memory once a block) or the interpreter
// (`eval_profile`) — and is contracted against `a` on the CUDA cores, as
// the Pallas kernel does on the VPU. K2 keeps the expansion (no exact
// near-pair path, unlike K3): at s << ||x||^2 its error is the tier's
// input rounding times ||x||^2.
//
// Row sums: each thread adds its 16 terms of a row in a tile with FFMA and
// that sum into a Kahan accumulator; the quad's four lanes add their
// compensated sums at the end. The columns are split over gridDim.y and a
// second small kernel adds the splits in a fixed order: no atomics, the
// result repeats bit for bit.
//
// Bounds on this card: 2 d flops per entry in x.y over 495 TFLOP/s of
// dense tf32 times the tier's passes, against the epilogue (the expansion,
// the profile, the mask and the FFMA into the row sum: ~10 fp32
// instructions and 1-2 SFU operations an entry) over 33.45 T and 4.18 T/s.

#include "profile_spec.cuh"
#include "tc_tile.cuh"

constexpr int K2_WARPS = 4;
constexpr int K2_THREADS = 32 * K2_WARPS;
constexpr int K2_TM = 16 * K2_WARPS;   // rows per block
constexpr int K2_TN = 64;              // columns per tile
constexpr int K2_NT = K2_TN / 8;
constexpr int K2_SS = K2_TN + 4;       // the S tile's row stride in shared memory

template <int FAM, int P>
__device__ __forceinline__ void k2_profile(const ProfileSpec& sp, const FamilyConsts& fc,
                                           const float4* tab, float (&s)[4]) {
    if constexpr (FAM == 0) {
        eval_profile<4>(sp, s);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = family_value<FAM, P>(s[e], fc, tab);
    }
}

// the real-nu Matern family's table (MATERN_KNOTS float4, 16 KiB) in
// dynamic shared memory: beside the static ~39 KiB it passes 48 KiB
constexpr int K2_MATERN_SMEM = MATERN_KNOTS * (int)sizeof(float4);

template <bool ISO, int FAM, int P, int PASSES>
__global__ void __launch_bounds__(K2_THREADS, 1)
k2_tc(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ x2,
      const float* __restrict__ y2, const float* __restrict__ a, float* __restrict__ partial,
      int n, int m, int d, int cols_per_split, int vec4,
      const __grid_constant__ ProfileSpec spec, const __grid_constant__ FamilyConsts fc,
      const float4* __restrict__ tab) {
    constexpr unsigned FULL = 0xffffffffu;
    extern __shared__ __align__(16) float4 k2_tab[];
    __shared__ ProfileSpec sp;
    __shared__ __align__(16) TcStage<K2_TM, K2_TN, 1> st;
    __shared__ float x2s[K2_TM], y2s[K2_TN], as[K2_TN];
    // each warp's S tile, read back one n-tile at a time: the n-tiles'
    // profiles unrolled together took every register
    __shared__ __align__(16) float sv[K2_WARPS][16][K2_SS];

    if constexpr (FAM == 0) load_spec(sp, spec);
    // the table lands before the first tile's barriers, ahead of any read
    if constexpr (FAM == FAM_MATERN_NU)
        for (int r = threadIdx.x; r < MATERN_KNOTS; r += K2_THREADS) k2_tab[r] = tab[r];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * K2_TM;
    const int ra = 16 * w + g, rb = ra + 8;
    if (ISO)
        for (int r = threadIdx.x; r < K2_TM; r += K2_THREADS)
            x2s[r] = row0 + r < n ? x2[row0 + r] : 0.f;
    float acc_a = 0.f, comp_a = 0.f, acc_b = 0.f, comp_b = 0.f;

    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    int q = 0;   // the staged chunks' counter (tc_tile)
    for (int j0 = j_begin; j0 < j_end; j0 += K2_TN) {
        const int cnt = min(K2_TN, j_end - j0);
        const int next = j0 + K2_TN, next_cnt = next < j_end ? min(K2_TN, j_end - next) : 0;
        __syncthreads();   // the previous tile's y2s / as are consumed
        for (int r = threadIdx.x; r < K2_TN; r += K2_THREADS) {
            as[r] = r < cnt ? a[j0 + r] : 0.f;
            if (ISO) y2s[r] = r < cnt ? y2[j0 + r] : 0.f;
        }
        float S[1][K2_NT][4];
        tc_tile<K2_TM, K2_TN, 1, K2_THREADS, PASSES>(st, q, j0 != j_begin, x, y, nullptr, n, d,
                                                     row0, j0, cnt, next, next_cnt, vec4, S);
        float(*sw)[K2_SS] = sv[w];
#pragma unroll
        for (int nt = 0; nt < K2_NT; ++nt) {
            *reinterpret_cast<float2*>(&sw[g][8 * nt + 2 * t]) =
                make_float2(S[0][nt][0], S[0][nt][1]);
            *reinterpret_cast<float2*>(&sw[g + 8][8 * nt + 2 * t]) =
                make_float2(S[0][nt][2], S[0][nt][3]);
        }
        __syncwarp();
        float ta = 0.f, tb = 0.f;
#pragma unroll 1
        for (int nt = 0; nt < K2_NT; ++nt) {
            const float2 pa = *reinterpret_cast<const float2*>(&sw[g][8 * nt + 2 * t]);
            const float2 pb = *reinterpret_cast<const float2*>(&sw[g + 8][8 * nt + 2 * t]);
            const float pv[4] = {pa.x, pa.y, pb.x, pb.y};
            float s[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e < 2 ? ra : rb, j = 8 * nt + 2 * t + (e & 1);
                s[e] = ISO ? fmaxf((x2s[r] + y2s[j]) - 2.f * pv[e], 0.f) : pv[e];
            }
            k2_profile<FAM, P>(sp, fc, k2_tab, s);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 8 * nt + 2 * t + (e & 1);
                // columns past the tile's end: f may be inf there (IMQ with c = 0)
                const float term = j < cnt ? s[e] * as[j] : 0.f;
                if (e < 2) ta += term; else tb += term;
            }
        }
        kahan_add(acc_a, comp_a, ta);
        kahan_add(acc_b, comp_b, tb);
    }
    float va = acc_a - comp_a, vb = acc_b - comp_b;
    va += __shfl_xor_sync(FULL, va, 1);
    vb += __shfl_xor_sync(FULL, vb, 1);
    va += __shfl_xor_sync(FULL, va, 2);
    vb += __shfl_xor_sync(FULL, vb, 2);
    const float scale = FAM == 0 ? 1.f : fc.scale;
    if (t == 0) {
        if (row0 + ra < n) partial[(size_t)blockIdx.y * n + row0 + ra] = scale * va;
        if (row0 + rb < n) partial[(size_t)blockIdx.y * n + row0 + rb] = scale * vb;
    }
}

// out_i = sum over splits of partial[s, i], in split order
__global__ void k2_reduce(const float* __restrict__ partial, float* __restrict__ out, int n,
                          int splits) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float t = partial[i];
    for (int s = 1; s < splits; ++s) t += partial[(size_t)s * n + i];
    out[i] = t;
}

struct K2Args {
    const float *x, *y, *x2, *y2, *a;
    float* partial;
    int n, m, d, cols_per_split, vec4;
    const float4* tab;
};

template <bool ISO, int FAM, int P, int PASSES>
static int k2_go(dim3 grid, cudaStream_t st, const K2Args& g, const ProfileSpec& spec,
                 const FamilyConsts& fc) {
    constexpr int dyn = FAM == FAM_MATERN_NU ? K2_MATERN_SMEM : 0;
    if constexpr (dyn > 0) {
        if (g.tab == nullptr) return (int)cudaErrorInvalidValue;
        static const cudaError_t attr = cudaFuncSetAttribute(
            k2_tc<ISO, FAM, P, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
        if (attr != cudaSuccess) return (int)attr;
    }
    k2_tc<ISO, FAM, P, PASSES><<<grid, K2_THREADS, dyn, st>>>(
        g.x, g.y, g.x2, g.y2, g.a, g.partial, g.n, g.m, g.d, g.cols_per_split, g.vec4, spec,
        fc, g.tab);
    return 0;
}

template <int PASSES>
static int k2_by_family(int iso, int family, int p, dim3 grid, cudaStream_t st,
                        const K2Args& g, const ProfileSpec& spec, const FamilyConsts& fc) {
    if (!iso)
        return family == 0 ? k2_go<false, 0, 0, PASSES>(grid, st, g, spec, fc)
                           : (int)cudaErrorInvalidValue;
    switch (family) {
    case 0: return k2_go<true, 0, 0, PASSES>(grid, st, g, spec, fc);
    case FAM_EQ: return k2_go<true, FAM_EQ, 0, PASSES>(grid, st, g, spec, fc);
    case FAM_MATERN:
        switch (p) {
        case 0: return k2_go<true, FAM_MATERN, 0, PASSES>(grid, st, g, spec, fc);
        case 1: return k2_go<true, FAM_MATERN, 1, PASSES>(grid, st, g, spec, fc);
        case 2: return k2_go<true, FAM_MATERN, 2, PASSES>(grid, st, g, spec, fc);
        case 3: return k2_go<true, FAM_MATERN, 3, PASSES>(grid, st, g, spec, fc);
        default: return (int)cudaErrorInvalidValue;
        }
    case FAM_RQ: return k2_go<true, FAM_RQ, 0, PASSES>(grid, st, g, spec, fc);
    case FAM_CAUCHY: return k2_go<true, FAM_CAUCHY, 0, PASSES>(grid, st, g, spec, fc);
    case FAM_IMQ: return k2_go<true, FAM_IMQ, 0, PASSES>(grid, st, g, spec, fc);
    case FAM_MATERN_NU: return k2_go<true, FAM_MATERN_NU, 0, PASSES>(grid, st, g, spec, fc);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int k2_gramian_matvec_expand(const float* x, const float* y, const float* x2,
                                        const float* y2, const float* a, float* partial,
                                        float* out, int n, int m, int d, int iso, int splits,
                                        int cols_per_split, int passes, int family, int p,
                                        int vec4, ProfileSpec spec, FamilyConsts fc,
                                        const float4* tab, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((n + K2_TM - 1) / K2_TM, splits);
    const K2Args g{x, y, x2, y2, a, partial, n, m, d, cols_per_split, vec4, tab};
    int bad;
    switch (passes) {
    case 1: bad = k2_by_family<1>(iso, family, p, grid, st, g, spec, fc); break;
    case 3: bad = k2_by_family<3>(iso, family, p, grid, st, g, spec, fc); break;
    default: bad = (int)cudaErrorInvalidValue;
    }
    if (bad) return bad;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (splits > 1) k2_reduce<<<(n + 255) / 256, 256, 0, st>>>(partial, out, n, splits);
    return (int)cudaGetLastError();
}
