// K2: the expansion-form Gramian MVM b = K a for NVIDIA Hopper (sm_90a), on
// the tensor cores through wgmma. Plain C interface, loaded with ctypes by
// cfjax_torch/ops/gramian_mvm.py, which also holds its plain torch version
// `gramian_matvec_expand_plain`.
//
// Replaces cfjax/ops/pallas_mvm.py `pallas_gramian_matvec` / `_mvm_kernel`:
// isotropic kernels at any d through s = ||x||^2 + ||y||^2 - 2 x.y (clamped
// at 0), dot-product kernels through s = x.y. The profile of each entry
// follows in registers — a one-leaf profile's family form (`family_value`,
// the families K1 takes: EQ, Exp, MaternP(p <= 3), RQ, Cauchy, IMQ, and the
// real-nu Matern's, whose table is staged in shared memory once a block)
// or the interpreter (`eval_profile`) — and is contracted against `a` on
// the CUDA cores, as the Pallas kernel does on the VPU. K2 keeps the
// expansion (no exact near-pair path, unlike K3): at s << ||x||^2 its
// error is the tier's input rounding times ||x||^2.
//
// What bounds it on this card. The x.y tile is 2 d tensor-core flops an
// entry times the tier's passes (tc_tile.cuh: 3 tf32 piece products at
// "high" / "highest", 1 at "default"); the epilogue (the expansion, the
// profile, the mask and the row sum: ~10 fp32 instructions and 1-2 SFU
// operations an entry) runs on the CUDA cores and the SFU. At the ARD
// cell's product (MaternP(2), d = 90 padded to 96, n = 2^16, 3 passes) the
// tensor cores bound it: 2.47 TFLOP, 4.685 ms at wgmma's 495 TFLOP/s,
// against ~1.3 ms of fp32 and ~2.1 ms of SFU work. The mma.sync design
// before this one reached 12.7% of that bound (36.7 ms a product): legacy
// m16n8k8 cannot reach the tf32 rate, it staged and split the block's x
// rows again for every column tile, every warp split the same y fragments,
// d = 90's unaligned rows fell to 4-byte copies, and the profile ran while
// the warp's tensor-core work stood still.
//
// The design:
//   * the split, a kernel of its own (k2_tc<NP>, before the product):
//     each row of y, and of x unless x is y, into its tf32 pieces once a
//     product, each rounded to nearest, laid out in 64-row tiles exactly
//     as the product's shared memory takes them, with the rows' norms and
//     each tile's a; rows need no alignment (d = 90: a warp reads a row's
//     128 bytes of a K-block at a time);
//   * the product, one block of 544 threads a 128-row block (one an SM):
//     wgmma.m64n64k8 tf32 with fp32 accumulate, both operands K-major in
//     shared memory in the 128-byte swizzled layout (rows of 32 floats of
//     depth, a "K-block", 8-row groups 1024 bytes apart), at the tier's
//     passes: x1 y0 + x0 y1 + x0 y0;
//   * one producer lane copies with the TMA's bulk copies: the block's x
//     pieces once (kept for the whole column walk), then each 64-column y
//     tile K-block by K-block into a ring of stages guarded by mbarriers
//     (full: the copies' bytes, empty: 256 consumer arrivals), a tile's a
//     and ||y||^2 into a ring of column slots;
//   * four consumer warpgroups in two pairs: in a pair each takes 64 of
//     the block's rows, and the pairs take the tiles in turn (even, odd),
//     so the tensor cores run one pair's wgmmas while the other pair's
//     profile runs from the accumulators they left (no round trip through
//     shared memory);
//   * where x's pieces and a tile of stages do not fit in the 227 KB a
//     block has (d > 128 at 3 passes; at 1 pass d > 288, or d > 256 beside
//     the real-nu Matern's 16 KB table), x's K-block comes into each stage
//     beside y's instead; a ring shorter than two tiles makes a consumer
//     wait for its own products before it reuses a stage;
//   * the grid is (row blocks, column splits), the splits chosen by the
//     wrapper from the library's tile shape (`k2_expand_shape`) to fill
//     the SMs. Row sums: each thread adds its 16 terms of a row in a tile
//     with FFMA and that sum into a Kahan accumulator; the quad's four
//     lanes add their compensated sums, the odd tiles' pair's after the
//     even tiles' pair's; a second small kernel adds the splits in a fixed
//     order. No atomics: the result repeats bit for bit.
//
// Measured on an H100 (700 W) at the ARD cell's product: 8.9 ms device a
// product at 3 passes (52.5% of the tensor-core bound; 36.9 ms before),
// 6.0 ms at 1 pass. Without the profile the products take 6.1 ms, without
// the products the profile takes 7.2 ms: the two pairs' profiles, on the
// CUDA cores and the SFU, now set the pace about as much as the tensor
// cores do.

#include <cstdint>

#include "profile_spec.cuh"
#include "hopper.cuh"    // mbarriers, TMA bulk copies, wgmma
#include "tc_tile.cuh"   // the tf32 split (to_tf32) and the tiers' piece products

constexpr int K2_BM = 128;            // rows a block: a pair of consumer warpgroups, 64 each
constexpr int K2_BN = 64;             // columns a tile (wgmma m64n64k8)
constexpr int K2_KB = 32;             // depth a K-block: one 128-byte swizzle row of tf32
constexpr int K2_ROW = 128;           // bytes a row of a K-block
constexpr int K2_CHUNK = K2_BN * K2_ROW;   // one piece of a K-block of 64 rows
constexpr int K2_THREADS = 544;       // four consumer warpgroups and the producer warp
constexpr int K2_MAX_STAGES = 16;
constexpr int K2_SMEM = 232448;       // shared memory a block may take on sm_90 (227 KB)
constexpr int K2_STATIC = 2048;       // kept for the static shared memory (spec, barriers)
constexpr int K2_ALIGN = 1024;        // the 128-byte swizzle's 8-row groups are 1024-aligned
constexpr int K2_MATERN_SMEM = MATERN_KNOTS * (int)sizeof(float4);

constexpr int K2_COLS = 2 * K2_BN * (int)sizeof(float);   // a slot: a and ||y||^2 of a tile

// The block's shared-memory plan for d at a tier: K-blocks, tf32 pieces,
// whether x's pieces stay resident, the ring's stages and their bytes, and
// the slots of the tiles' columns.
struct K2Plan {
    int nkb, np, resident, stages, stage_bytes, x_bytes, slots, smem;
};

__host__ __device__ inline K2Plan k2_plan(int d, int passes, bool table) {
    K2Plan p;
    p.nkb = (d + K2_KB - 1) / K2_KB;
    p.np = tc_pieces(passes);
    const int avail = K2_SMEM - K2_STATIC - K2_ALIGN - (table ? K2_MATERN_SMEM : 0);
    const int y_stage = p.np * K2_CHUNK;
    const int x_all = p.np * p.nkb * 2 * K2_CHUNK;
    // resident: x's pieces and a ring of at least one tile
    p.resident = x_all + p.nkb * y_stage + 3 * K2_COLS <= avail;
    p.x_bytes = p.resident ? x_all : 0;
    p.stage_bytes = y_stage + (p.resident ? 0 : p.np * 2 * K2_CHUNK);
    p.stages = (avail - p.x_bytes) / p.stage_bytes;
    if (p.stages > K2_MAX_STAGES) p.stages = K2_MAX_STAGES;
    // the columns' slots: two more than the tiles the stages span. The
    // producer fills tile t's slot once the consumers have released the
    // stage of item t nkb - stages, an item of tile t - slots + 2 or later;
    // a consumer releases those (a short ring's early release included)
    // only after its profile of tile t - slots, the slot's last user
    for (;; --p.stages) {
        p.slots = (p.stages + p.nkb - 1) / p.nkb + 2;
        if (p.x_bytes + p.stages * p.stage_bytes + p.slots * K2_COLS <= avail) break;
    }
    p.smem = K2_ALIGN + p.x_bytes + p.stages * p.stage_bytes + p.slots * K2_COLS +
             (table ? K2_MATERN_SMEM : 0);
    return p;
}

// ---------------------------------------------------------------------------
// The split, a kernel of its own before the product: rows of a row-major
// (rows, d) array into their NP tf32 pieces, laid out as the product's
// shared memory takes them, so that one bulk copy moves a stage. Tile t
// of 64 rows, K-block kb and piece p are the K2_CHUNK bytes at ((t nkb +
// kb) NP + p) K2_CHUNK: 64 rows of 128 bytes, the 16-byte groups of row r
// swizzled by r & 7. Rows past `rows` and depth past d are zero. Each
// row's ||v||^2 (fp32, a fixed order) goes to norms[row]; with `a`, tile
// t's a and ||y||^2 go to cols[128 t ..] and cols[128 t + 64 ..] (zero
// past `rows`). A warp takes a row at a time, a lane one depth of each
// K-block: 128-byte loads and stores.
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(256)
k2_tc(const float* __restrict__ src, int rows, int d, int nkb, float* __restrict__ pieces,
      float* __restrict__ norms, const float* __restrict__ a, float* __restrict__ cols) {
    constexpr unsigned FULL = 0xffffffffu;
    const int t = blockIdx.x, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = w; r < K2_BN; r += 8) {
        const int row = t * K2_BN + r;
        const bool live = row < rows;
        uint32_t* dst = reinterpret_cast<uint32_t*>(pieces) + (size_t)t * nkb * NP * K2_CHUNK / 4 +
                        r * K2_KB + ((((lane >> 2) ^ (r & 7))) << 2) + (lane & 3);
        float ss = 0.f;
        for (int kb = 0; kb < nkb; ++kb, dst += NP * K2_CHUNK / 4) {
            const int k = kb * K2_KB + lane;
            const float v = live && k < d ? __ldg(src + (size_t)row * d + k) : 0.f;
            ss = fmaf(v, v, ss);
            const uint32_t p0 = to_tf32(v);
            dst[0] = p0;
            if constexpr (NP > 1) dst[K2_CHUNK / 4] = to_tf32(v - __uint_as_float(p0));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
        if (lane == 0) {
            if (norms != nullptr && live) norms[row] = ss;
            if (cols != nullptr) {
                cols[2 * K2_BN * t + r] = live ? a[row] : 0.f;
                cols[2 * K2_BN * t + K2_BN + r] = live ? ss : 0.f;
            }
        }
    }
}

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

// Issue the wgmmas of a tile (all its K-blocks, the tier's passes) into c;
// the consumer warpgroup takes rows 64 h .. 64 h + 63 of the block. The
// tile's first item sits at stage s0, phase ph0 of the ring. Where the
// ring is shorter than the tile, the warpgroup finishes and hands back its
// own K-blocks before it reuses their stages (from stage rs on). Returns
// the first K-block not handed back.
template <int PASSES>
__device__ __forceinline__ int k2_issue(float (&c)[32], int s0, int ph0, int& rs,
                                        uint64_t* full, uint64_t* empty, const K2Plan& pl,
                                        const uint8_t* xs, const uint8_t* ring, int d, int h) {
    constexpr int NP = tc_pieces(PASSES);
    wg_fence();
    int acc = 0, rel = 0, s = s0, ph = ph0, rph = 0;
    rs = s0;
    for (int kb = 0; kb < pl.nkb; ++kb, ring_next(s, ph, pl.stages)) {
        if (kb - rel >= pl.stages) {
            wg_commit();
            wg_wait<0>();
            for (; rel < kb; ++rel, ring_next(rs, rph, pl.stages)) mbar_arrive(&empty[rs]);
        }
        mbar_wait(&full[s], ph);
        // x's pieces of this K-block and half: resident, or in the stage
        // after y's
        const uint32_t sb = smem_addr(ring + (size_t)s * pl.stage_bytes);
        const uint32_t xa = (pl.resident ? smem_addr(xs) + kb * 2 * NP * K2_CHUNK
                                         : sb + NP * K2_CHUNK) + h * NP * K2_CHUNK;
        const int steps = min(K2_KB / 8, (d - kb * K2_KB + 7) / 8);
        for (int ks = 0; ks < steps; ++ks) {
#pragma unroll
            for (int u = 0; u < PASSES; ++u) {
                const uint64_t da = sw128_desc(xa + tc_piece_a(PASSES, u) * K2_CHUNK + ks * 32);
                const uint64_t db = sw128_desc(sb + tc_piece_b(PASSES, u) * K2_CHUNK + ks * 32);
                wgmma_tf32(c, da, db, acc);
                acc = 1;
            }
        }
    }
    wg_commit();
    acc_fence(c);
    return rel;
}

// the profile of one tile from the accumulators, contracted against a into
// the two rows' Kahan sums; `cols` the tile's slot: a, then ||y||^2. MASK:
// the tile runs past the split's end
template <bool ISO, int FAM, int P, bool MASK>
__device__ __forceinline__ void k2_epilogue(const float (&c)[32], const ProfileSpec& sp,
                                            const FamilyConsts& fc, const float4* tab,
                                            const float* cols, int j0, int j_end, int t,
                                            float x2a, float x2b, float& acc_a, float& comp_a,
                                            float& acc_b, float& comp_b) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < K2_BN / 8; ++i) {
        const int j = j0 + 8 * i + 2 * t;
        const bool in0 = j < j_end, in1 = j + 1 < j_end;
        const float2 av = *reinterpret_cast<const float2*>(cols + 8 * i + 2 * t);
        float s[4] = {c[4 * i], c[4 * i + 1], c[4 * i + 2], c[4 * i + 3]};
        if constexpr (ISO) {
            const float2 yv = *reinterpret_cast<const float2*>(cols + K2_BN + 8 * i + 2 * t);
            s[0] = fmaxf(fmaf(-2.f, s[0], x2a + yv.x), 0.f);
            s[1] = fmaxf(fmaf(-2.f, s[1], x2a + yv.y), 0.f);
            s[2] = fmaxf(fmaf(-2.f, s[2], x2b + yv.x), 0.f);
            s[3] = fmaxf(fmaf(-2.f, s[3], x2b + yv.y), 0.f);
        }
        k2_profile<FAM, P>(sp, fc, tab, s);
        if constexpr (MASK) {
            // columns past the split's end: f may be inf there (IMQ with c = 0)
            ta += in0 ? s[0] * av.x : 0.f;
            ta += in1 ? s[1] * av.y : 0.f;
            tb += in0 ? s[2] * av.x : 0.f;
            tb += in1 ? s[3] * av.y : 0.f;
        } else {
            ta = fmaf(s[0], av.x, ta);
            ta = fmaf(s[1], av.y, ta);
            tb = fmaf(s[2], av.x, tb);
            tb = fmaf(s[3], av.y, tb);
        }
    }
    kahan_add(acc_a, comp_a, ta);
    kahan_add(acc_b, comp_b, tb);
}

template <bool ISO, int FAM, int P, int PASSES>
__global__ void __launch_bounds__(K2_THREADS, 1)
k2_tc(const float* __restrict__ xp, const float* __restrict__ yp, const float* __restrict__ gcols,
      const float* __restrict__ x2, float* __restrict__ partial, int n, int m, int d,
      int cols_per_split, const __grid_constant__ ProfileSpec spec,
      const __grid_constant__ FamilyConsts fc, const float4* __restrict__ tab) {
    constexpr unsigned FULL = 0xffffffffu;
    constexpr int NP = tc_pieces(PASSES);
    constexpr bool TABLE = FAM == FAM_MATERN_NU;
    extern __shared__ __align__(16) uint8_t k2_smem[];
    __shared__ ProfileSpec sp;
    __shared__ uint64_t full[K2_MAX_STAGES], empty[K2_MAX_STAGES], x_full;
    __shared__ float red[2][64];   // the odd tiles' row sums

    const K2Plan pl = k2_plan(d, PASSES, TABLE);
    uint8_t* base = k2_smem + ((K2_ALIGN - (smem_addr(k2_smem) & (K2_ALIGN - 1))) & (K2_ALIGN - 1));
    uint8_t* xs = base;
    uint8_t* ring = base + pl.x_bytes;
    float* cols = reinterpret_cast<float*>(ring + (size_t)pl.stages * pl.stage_bytes);
    float4* tabs = reinterpret_cast<float4*>(cols + pl.slots * 2 * K2_BN);

    if constexpr (FAM == 0) load_spec(sp, spec);
    if constexpr (TABLE)
        for (int r = threadIdx.x; r < MATERN_KNOTS; r += K2_THREADS) tabs[r] = tab[r];
    if (threadIdx.x == 0) {
        for (int s = 0; s < pl.stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        mbar_init(&x_full, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warp's index through a shuffle: the compiler then knows it is one
    // value a warp, and the consumers' path is not divergent (it would
    // serialize the wgmmas)
    const int warp = __shfl_sync(FULL, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
    const int row0 = blockIdx.x * K2_BM;
    const int j_begin = blockIdx.y * cols_per_split;
    const int j_end = min(m, j_begin + cols_per_split);
    const int ntiles = j_end > j_begin ? (j_end - j_begin + K2_BN - 1) / K2_BN : 0;
    // the split's pieces by 64-row tile (k2_tc<NP> above): x's of the
    // block's two halves, y's of the split's tiles
    const uint8_t* xg = reinterpret_cast<const uint8_t*>(xp) +
                        (size_t)2 * blockIdx.x * pl.nkb * NP * K2_CHUNK;
    const int tile0 = j_begin / K2_BN;

    if (warp == 16) {
        // ---- the producer warp: one lane issues every copy ----
        if (lane != 0) return;
        if (pl.resident) {
            mbar_expect(&x_full, pl.x_bytes);
            for (int kb = 0; kb < pl.nkb; ++kb)
                for (int h = 0; h < 2; ++h)
                    bulk_copy(xs + (kb * 2 + h) * NP * K2_CHUNK,
                              xg + ((size_t)h * pl.nkb + kb) * NP * K2_CHUNK, NP * K2_CHUNK,
                              &x_full);
        }
        int s = 0, ph = 0, cs = 0;
        for (int t = 0; t < ntiles; ++t, cs = cs + 1 == pl.slots ? 0 : cs + 1)
            for (int kb = 0; kb < pl.nkb; ++kb) {
                mbar_wait(&empty[s], ph ^ 1);
                uint8_t* stage = ring + (size_t)s * pl.stage_bytes;
                mbar_expect(&full[s], NP * K2_CHUNK + (kb == 0 ? K2_COLS : 0) +
                                          (pl.resident ? 0 : 2 * NP * K2_CHUNK));
                bulk_copy(stage,
                          reinterpret_cast<const uint8_t*>(yp) +
                              ((size_t)(tile0 + t) * pl.nkb + kb) * NP * K2_CHUNK,
                          NP * K2_CHUNK, &full[s]);
                if (kb == 0)
                    bulk_copy(cols + cs * 2 * K2_BN, gcols + (size_t)(tile0 + t) * 2 * K2_BN,
                              K2_COLS, &full[s]);
                if (!pl.resident)
                    for (int h = 0; h < 2; ++h)
                        bulk_copy(stage + (1 + h) * NP * K2_CHUNK,
                                  xg + ((size_t)h * pl.nkb + kb) * NP * K2_CHUNK, NP * K2_CHUNK,
                                  &full[s]);
                ring_next(s, ph, pl.stages);
            }
        return;
    }

    // ---- the consumer warpgroups: warpgroup c takes rows 64 h .. 64 h +
    // 63 (h = c & 1) of the tiles of parity q = c >> 1. The two pairs
    // take turns: pair q issues tile t only after pair 1 - q has issued
    // tile t - 1 (named barrier 1 + q), so the tensor cores run one pair's
    // products while the other pair's profile runs on the CUDA cores, and
    // every item of the ring before a warpgroup's next one has been waited
    // for when it waits (the barriers' phase parities stay unambiguous) ----
    const int c = warp >> 2, h = c & 1, q = c >> 1, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int ra = row0 + 64 * h + 16 * w + g, rb = ra + 8;
    const float x2a = ISO && ra < n ? x2[ra] : 0.f, x2b = ISO && rb < n ? x2[rb] : 0.f;
    float acc_a = 0.f, comp_a = 0.f, acc_b = 0.f, comp_b = 0.f;
    if (pl.resident) mbar_wait(&x_full, 0);

    float acc[32];   // the first wgmma of a tile overwrites it
    // the ring position of this pair's next tile, and its column slot
    int s0 = 0, ph0 = 0, cs = q;
    ring_skip(s0, ph0, q * pl.nkb, pl.stages);
    for (int tile = q; tile < ntiles; tile += 2) {
        if (tile > 0) bar_sync(1 + q, 512);
        int rs, rph = 0;
        int rel = k2_issue<PASSES>(acc, s0, ph0, rs, full, empty, pl, xs, ring, d, h);
        if (tile + 1 < ntiles) bar_arrive(2 - q, 512);
        wg_wait<0>();
        acc_fence(acc);
        for (; rel < pl.nkb; ++rel, ring_next(rs, rph, pl.stages)) mbar_arrive(&empty[rs]);
        ring_skip(s0, ph0, 2 * pl.nkb, pl.stages);
        const int j0 = j_begin + tile * K2_BN;
        const float* slot = cols + cs * 2 * K2_BN;
        if ((cs += 2) >= pl.slots) cs -= pl.slots;
        if (j0 + K2_BN <= j_end)
            k2_epilogue<ISO, FAM, P, false>(acc, sp, fc, tabs, slot, j0, j_end, t, x2a, x2b,
                                            acc_a, comp_a, acc_b, comp_b);
        else
            k2_epilogue<ISO, FAM, P, true>(acc, sp, fc, tabs, slot, j0, j_end, t, x2a, x2b,
                                           acc_a, comp_a, acc_b, comp_b);
    }

    float va = acc_a - comp_a, vb = acc_b - comp_b;
    va += __shfl_xor_sync(FULL, va, 1);
    vb += __shfl_xor_sync(FULL, vb, 1);
    va += __shfl_xor_sync(FULL, va, 2);
    vb += __shfl_xor_sync(FULL, vb, 2);
    // the odd tiles' sums join the even tiles' in a fixed order
    const int rr = 16 * w + g;
    if (q == 1 && t == 0) {
        red[h][rr] = va;
        red[h][rr + 8] = vb;
    }
    bar_sync(3, 512);
    const float scale = FAM == 0 ? 1.f : fc.scale;
    if (q == 0 && t == 0) {
        if (ra < n) partial[(size_t)blockIdx.y * n + ra] = scale * (va + red[h][rr]);
        if (rb < n) partial[(size_t)blockIdx.y * n + rb] = scale * (vb + red[h][rr + 8]);
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
    const float *xp, *yp, *cols, *x2;
    float* partial;
    int n, m, d, cols_per_split;
    const float4* tab;
};

template <bool ISO, int FAM, int P, int PASSES>
static int k2_go(dim3 grid, cudaStream_t st, const K2Args& g, const ProfileSpec& spec,
                 const FamilyConsts& fc) {
    constexpr bool TABLE = FAM == FAM_MATERN_NU;
    if (TABLE && g.tab == nullptr) return (int)cudaErrorInvalidValue;
    const K2Plan pl = k2_plan(g.d, PASSES, TABLE);
    if (pl.stages < 2) return (int)cudaErrorInvalidValue;
    // once an instance: the most any plan takes beside the static memory
    static const cudaError_t attr =
        cudaFuncSetAttribute(k2_tc<ISO, FAM, P, PASSES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, K2_SMEM - K2_STATIC);
    if (attr != cudaSuccess) return (int)attr;
    k2_tc<ISO, FAM, P, PASSES><<<grid, K2_THREADS, pl.smem, st>>>(
        g.xp, g.yp, g.cols, g.x2, g.partial, g.n, g.m, g.d, g.cols_per_split, spec, fc, g.tab);
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

// The shape the wrapper plans with: rows a block and columns a tile for d
// at `passes` (the real-nu Matern's table beside them when `table`).
extern "C" int k2_expand_shape(int d, int passes, int table, int* rows, int* cols) {
    if (d < 1 || (passes != 1 && passes != 3)) return (int)cudaErrorInvalidValue;
    *rows = K2_BM;
    *cols = K2_BN;
    return k2_plan(d, passes, table != 0).stages < 2 ? (int)cudaErrorInvalidValue : 0;
}

// The split's 64-row tiles: y's ceil(m / 64) and x's 2 ceil(n / 128) (the
// product reads x by 128-row block); `same` (x is y): one split of the
// larger count, x's none.
static void k2_tiles(int n, int m, int same, int& ytiles, int& xtiles) {
    ytiles = (m + K2_BN - 1) / K2_BN;
    xtiles = 2 * ((n + K2_BM - 1) / K2_BM);
    if (same) {
        ytiles = ytiles > xtiles ? ytiles : xtiles;
        xtiles = 0;
    }
}

// The floats of scratch k2_gramian_matvec_expand takes from the wrapper:
// the pieces of y's tiles (yp) and of x's (xp; 0 when x is y), and the
// tiles' a and ||y||^2 (cols).
extern "C" int k2_expand_scratch(int n, int m, int d, int passes, int same, long long* yp,
                                 long long* xp, long long* cols) {
    if (d < 1 || (passes != 1 && passes != 3)) return (int)cudaErrorInvalidValue;
    int ytiles, xtiles;
    k2_tiles(n, m, same, ytiles, xtiles);
    const long long tile = (long long)((d + K2_KB - 1) / K2_KB) * tc_pieces(passes) * K2_CHUNK / 4;
    *yp = ytiles * tile;
    *xp = xtiles * tile;
    *cols = (long long)ytiles * 2 * K2_BN;
    return 0;
}

template <int NP>
static void k2_split(cudaStream_t st, const float* src, int rows, int tiles, int d, int nkb,
                     float* pieces, float* norms, const float* a, float* cols) {
    k2_tc<NP><<<tiles, 256, 0, st>>>(src, rows, d, nkb, pieces, norms, a, cols);
}

// b = K a for x (n, d), y (m, d), a (m,). Scratch from the wrapper, of the
// sizes k2_expand_scratch gives: yp the pieces of y's tiles and cols their
// a and ||y||^2; xp those of x's tiles and x2 its norms. `same` (x is y):
// one split, into yp, xp unused. With splits > 1, partial (splits, n)
// holds the column splits' sums and k2_reduce adds them into out.
extern "C" int k2_gramian_matvec_expand(const float* x, const float* y, const float* a,
                                        float* xp, float* yp, float* cols, float* x2,
                                        float* partial, float* out, int n, int m, int d, int iso,
                                        int same, int splits, int cols_per_split, int passes,
                                        int family, int p, ProfileSpec spec, FamilyConsts fc,
                                        const float4* tab, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cols_per_split % K2_BN != 0 || (passes != 1 && passes != 3))
        return (int)cudaErrorInvalidValue;
    const int nkb = (d + K2_KB - 1) / K2_KB;
    int ytiles, xtiles;
    k2_tiles(n, m, same, ytiles, xtiles);
    const auto split = passes == 1 ? k2_split<1> : k2_split<2>;
    split(st, y, m, ytiles, d, nkb, yp, same ? x2 : nullptr, a, cols);
    if (!same) split(st, x, n, xtiles, d, nkb, xp, x2, nullptr, nullptr);
    dim3 grid((n + K2_BM - 1) / K2_BM, splits);
    const K2Args g{same ? yp : xp, yp, cols, x2, partial, n, m, d, cols_per_split, tab};
    const int bad = passes == 1 ? k2_by_family<1>(iso, family, p, grid, st, g, spec, fc)
                                : k2_by_family<3>(iso, family, p, grid, st, g, spec, fc);
    if (bad) return bad;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (splits > 1) k2_reduce<<<(n + 255) / 256, 256, 0, st>>>(partial, out, n, splits);
    return (int)cudaGetLastError();
}
