// K3: the gradient-gramian block MVM for NVIDIA Hopper (sm_90a), on the
// tensor cores through wgmma. Plain C interface, loaded with ctypes by
// cfjax_torch/ops/grad_mvm.py, which also holds its plain torch version
// `grad_matvec_plain` and plans the grid (`expand_plan`, K2's).
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
// Four GEMM-shaped products, as in the Pallas kernel: phase A, S = X Y^T
// and Q = X A^T over d (iso: s = |x|^2 + |y|^2 - 2 S, w = Q - <y_j, A_j>);
// phase B, f' and f'' of s and alpha, beta in registers; phase C,
// out += [alpha | beta] [A; Y] over the columns. Each product runs at the
// tier's tf32 passes (tc_tile.cuh: 3 piece products at "high" / "highest",
// 1 at "default").
//
// What bounds it on this card: 8 d tensor-core flops a pair times the
// passes, against ~20 fp32 instructions a pair (the expansion, the jet,
// alpha and beta, the tau test, the tf32 split of alpha and beta) and the
// jet's SFU operations. At config 4's product (EQ, n = m = 4096, d = 16, 3
// passes): 6.4 GFLOP, 13.0 us at 495 TFLOP/s, against ~7.5 us of fp32 and
// ~4 us of SFU work. The mma.sync design before this one took ~0.21 ms a
// call (6% of that bound): legacy m16n8k8 cannot reach the tf32 rate, its
// 512 blocks of 4 tiles each paid their whole prologue, phase C ran 32
// output columns at d = 16, the three phases ran one after another in each
// warp, and the norms took three torch reductions a call.
//
// The design:
//   * the split, a kernel of its own (k3_tc<NP>, before the product): x, y
//     and A into their tf32 pieces (cvt.rna, nearest) once a call, laid
//     out in 64-row tiles exactly as the product's shared memory takes
//     them (the 128-byte swizzle, rows of 32 floats of depth, a "K-block"),
//     so that one bulk copy moves an item: phase A's operand as each
//     K-block of a tile's y rows followed by the same of its A rows, so
//     that one wgmma m64n128k8 gives S and Q; phase C's operand [A; y] of
//     each tile transposed, the columns of each group of 8 in the order
//     0 2 4 6 1 3 5 7, which turns the products' accumulator fragments
//     into phase C's register A fragments as they stand; x in K-blocks;
//     and the norms |x_i|^2, |y_j|^2, <y_j, A_j> (fp32, a fixed order). A
//     large d's K-blocks and chunks go to several blocks a tile;
//   * the product, one block of 384 threads a 128-row block: a producer
//     warpgroup (its registers handed to the consumers by setmaxnreg),
//     one lane of which issues the TMA's bulk copies into a ring of stages
//     guarded by mbarriers (x's pieces once where they fit, "x resident",
//     else each K-block beside y's, "x streamed"; then each tile's phase-A
//     items, one a K-block, and its phase-C items, one a chunk of up to 64
//     output columns with the tile's norms); two consumer warpgroups take
//     64 rows each of every tile, the second starting one K-block's
//     products behind the first. Phase A is wgmma m64n128k8 from shared
//     memory. Phase C is wgmma m64nNk8 with alpha and beta, split into
//     their pieces, as register A operands, N = d rounded up to 8, 16, 32
//     or 64 (chunks of 64 above that), a group of 8 columns at a time, the
//     group's jet beside the other warpgroup's products, the passes into
//     accumulators of their own where they fit, which hold one tile's
//     sums: each tile's are added in fp32 into the block's rows of its
//     split's partial output (one long chain of tensor-core accumulations
//     across the tiles doubled cell 2's CG residual);
//   * the grid is (row blocks, column splits), the splits chosen by the
//     wrapper (`expand_plan`) from n, m and the SMs so that the waves are
//     full and a block walks many tiles. A second kernel adds the splits'
//     partial outputs in a fixed order with Kahan compensation; nothing
//     is atomic, and the result repeats bit for bit.
// What paces it (measured on an H100 at config 4's product, clock64 spans
// in one block): phase C's register-A wgmmas, about 70% of the block's
// time, at a small fraction of the tensor cores' rate; then phase A (13%),
// the expansion and the jet on the CUDA cores.
// Near-coincident pairs. The expansion |x|^2 + |y|^2 - 2 x.y cancels where
// s << |x|^2 + |y|^2 (at s = 0 it leaves ~eps |x|^2, and -2 f'(0) I is the
// whole diagonal block: at the README's configuration, MaternP(2) with
// n = d = 1024 standard normal points, the off-diagonal blocks underflow
// and that error was the whole error, 1.4e-4 with full fp32 products), and
// so does w = Q - <y, A>. Every pair with s <= tau (|x_i|^2 + |y_j|^2),
// tau = 2^-6, has its s and w recomputed in difference form on the CUDA
// cores from x, y and A in fp32 (the warp's lanes splitting d, pairs in a
// fixed order; a point against itself, x being y, is s = w = 0 at once),
// before the jet; its alpha and beta then enter phase C like any other
// pair's (there beta (y_j - x_i) is small with r: w is). Elsewhere the
// relative error of s is below ~2^-11 / tau (one pass) or 2^-22 / tau
// (three), and of w below its square root.

#include <cstdint>

#include "profile_spec.cuh"
#include "hopper.cuh"    // mbarriers, TMA bulk copies, wgmma from shared memory
#include "tc_tile.cuh"   // the tf32 split and the tiers' piece products

constexpr int K3_BM = 128;               // rows a block: two consumer warpgroups, 64 each
constexpr int K3_BN = 64;                // columns a tile
constexpr int K3_ROW = 128;              // bytes a K-block row: 32 floats of depth
constexpr int K3_CHUNK = K3_BN * K3_ROW; // one piece of a K-block of 64 rows
constexpr int K3_NCMAX = 64;             // output columns a phase-C chunk
constexpr int K3_THREADS = 384;          // two consumer warpgroups and the producer's
constexpr int K3_MAX_STAGES = 16;
constexpr int K3_SMEM = 232448;          // shared memory a block may take on sm_90 (227 KB)
constexpr int K3_STATIC = 2048;          // kept for the static shared memory (spec, barriers)
constexpr int K3_ALIGN = 1024;           // the 128-byte swizzle's 8-row groups are 1024-aligned
constexpr int K3_COLS = 2 * K3_BN * (int)sizeof(float);   // a tile's |y|^2 and <y, A>
constexpr int K3_TAB = 2 * MATERN_JET_KNOTS * (int)sizeof(float4);   // the jet family's tables
constexpr float K3_TAU = 1.f / 64.f;   // the near-coincident threshold

// phase C's wgmma width for f output columns
__host__ __device__ constexpr int k3_width(int f) {
    return f <= 8 ? 8 : f <= 16 ? 16 : f <= 32 ? 32 : 64;
}
// a stage: the larger of the two items, then the tile's columns, aligned
__host__ __device__ constexpr int k3_stage(int a, int c) {
    return ((a > c ? a : c) + K3_COLS + K3_ALIGN - 1) / K3_ALIGN * K3_ALIGN;
}

// The shapes for d at a tier: tf32 pieces; a tile's phase-A items (its
// 32-depth K-blocks); phase C's chunks, the columns of a full one and of the
// last, and the padded output columns; the items' bytes; whether x's pieces
// stay resident; the ring.
struct K3Plan {
    int np, nkb, nch, nc, nc_last, dc;
    int b_item, c_item, resident, x_bytes, stage_bytes, stages, smem;
};

__host__ __device__ inline K3Plan k3_plan(int d, int passes, bool table) {
    K3Plan p;
    p.np = tc_pieces(passes);
    p.nkb = (d + 31) / 32;
    p.nch = (d + K3_NCMAX - 1) / K3_NCMAX;
    p.nc = p.nch > 1 ? K3_NCMAX : k3_width(d);
    p.nc_last = k3_width(d - K3_NCMAX * (p.nch - 1));
    p.dc = K3_NCMAX * (p.nch - 1) + p.nc_last;
    p.b_item = 2 * p.np * K3_CHUNK;   // a K-block of the tile's y and A
    p.c_item = 4 * p.np * p.nc * K3_ROW;
    const int x_item = 2 * p.np * K3_CHUNK;   // a K-block of x, the block's two halves
    const int avail = K3_SMEM - K3_STATIC - K3_ALIGN - (table ? K3_TAB : 0);
    const int x_all = p.nkb * x_item;
    p.resident = x_all + 2 * k3_stage(p.b_item, p.c_item) <= avail;
    p.x_bytes = p.resident ? x_all : 0;
    p.stage_bytes = k3_stage(p.b_item + (p.resident ? 0 : x_item), p.c_item);
    p.stages = (avail - p.x_bytes) / p.stage_bytes;
    if (p.stages > K3_MAX_STAGES) p.stages = K3_MAX_STAGES;
    p.smem = K3_ALIGN + p.x_bytes + p.stages * p.stage_bytes + (table ? K3_TAB : 0);
    return p;
}

// Where the split puts each operand in the wrapper's scratch (floats):
//   ypa  y's tile t, K-block kb, piece p: ((t nkb + kb) NP + p) 4096, 64
//        rows of y then the same of A;
//   ct   y's tile t, chunk c, part (0 A, 1 y), K-block jb (columns 32 jb ..
//        32 jb + 31), piece p: t 4 NP dc 32 + c 4 NP 64 32
//        + ((part 2 + jb) NP + p) ncc 32, a row a column of out;
//   cols y's tile t: |y_j|^2 then <y_j, A_j>, 64 each;
//   xp   x's 64-row tile rt, K-block kb, piece p: ((rt nkb + kb) NP + p) 2048;
//   x2   |x_i|^2.
struct K3Scratch {
    long long ypa, ct, cols, xp, x2, total;
};

static K3Scratch k3_scratch_of(int n, int m, int d, int passes) {
    const K3Plan p = k3_plan(d, passes, false);
    const long long ytiles = (m + K3_BN - 1) / K3_BN, xtiles = 2 * ((n + K3_BM - 1) / K3_BM);
    K3Scratch s;
    s.ypa = 0;
    s.ct = s.ypa + ytiles * p.nkb * p.np * (K3_CHUNK / 2);
    s.cols = s.ct + ytiles * 4 * p.np * p.dc * (K3_ROW / 4);
    s.xp = s.cols + ytiles * 2 * K3_BN;
    s.x2 = s.xp + xtiles * p.nkb * p.np * (K3_CHUNK / 4);
    s.total = s.x2 + xtiles * K3_BN;
    return s;
}

// the column of a group of 8 at K position s of phase C (the accumulator
// fragments hold columns 2 t, 2 t + 1 where the A fragments take t, t + 4)
__host__ __device__ constexpr int k3_perm(int s) { return ((s & 3) << 1) | (s >> 2); }

template <int NP>
__device__ __forceinline__ void k3_pieces(float v, uint32_t* dst, int stride) {
    const uint32_t p0 = to_tf32(v);
    dst[0] = p0;
    if constexpr (NP > 1) dst[stride] = to_tf32(v - __uint_as_float(p0));
}

// word p of 128-byte row r: its 16-byte group swizzled by r & 7
__device__ __forceinline__ int k3_swz(int r, int p) {
    return r * 32 + (((p >> 2) ^ (r & 7)) << 2) + (p & 3);
}

// ---------------------------------------------------------------------------
// The split: blocks (tile, slice) of 256, y's 64-row tiles first, then x's
// (rows past n or m are zero); slice s of gridDim.y takes the K-blocks kb
// and chunks c = s mod gridDim.y of its tile (a large d in several blocks),
// slice 0 also the tile's norms. A warp takes a row at a time.
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(256)
k3_tc(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ A,
      int n, int m, int d, int ytiles, const K3Plan pl, float* __restrict__ scratch,
      const K3Scratch so) {
    constexpr unsigned FULL = 0xffffffffu;
    constexpr int PIECE = K3_CHUNK / 4;
    __shared__ float tr[2][K3_BN][K3_BN + 1];   // a tile's A and y, 64 columns of d
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int sl = blockIdx.y, slices = gridDim.y;
    uint32_t* sc = reinterpret_cast<uint32_t*>(scratch);

    if ((int)blockIdx.x >= ytiles) {   // x: 32 depths a lane-row, and |x_i|^2
        const int rt = blockIdx.x - ytiles;
        for (int r = w; r < K3_BN; r += 8) {
            const int row = K3_BN * rt + r;
            const bool live = row < n;
            const float* src = x + (size_t)(live ? row : 0) * d;
            uint32_t* dst = sc + so.xp + (size_t)rt * pl.nkb * NP * PIECE + k3_swz(r, lane);
            for (int kb = sl; kb < pl.nkb; kb += slices) {
                const int k = 32 * kb + lane;
                k3_pieces<NP>(live && k < d ? __ldg(src + k) : 0.f, dst + kb * NP * PIECE, PIECE);
            }
            if (sl == 0) {
                float ss = 0.f;
                for (int k = lane; live && k < d; k += 32) ss = fmaf(src[k], src[k], ss);
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
                if (lane == 0) scratch[so.x2 + row] = ss;
            }
        }
        return;
    }

    const int t = blockIdx.x, rows = min(K3_BN, m - K3_BN * t);
    // phase A's operand, y's K-block then A's, and the columns' norms
    for (int r = w; r < K3_BN; r += 8) {
        const bool live = r < rows;
        const size_t at = (size_t)(live ? K3_BN * t + r : 0) * d;
        uint32_t* dst = sc + so.ypa + (size_t)t * pl.nkb * NP * 2 * PIECE + k3_swz(r, lane);
        for (int kb = sl; kb < pl.nkb; kb += slices) {
            const int k = 32 * kb + lane;
            const bool in = live && k < d;
            k3_pieces<NP>(in ? __ldg(y + at + k) : 0.f, dst + kb * NP * 2 * PIECE, 2 * PIECE);
            k3_pieces<NP>(in ? __ldg(A + at + k) : 0.f, dst + kb * NP * 2 * PIECE + PIECE,
                          2 * PIECE);
        }
        if (sl == 0) {
            float yy = 0.f, ya = 0.f;
            for (int k = lane; live && k < d; k += 32) {
                const float v = y[at + k];
                yy = fmaf(v, v, yy);
                ya = fmaf(v, A[at + k], ya);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                yy += __shfl_xor_sync(FULL, yy, o);
                ya += __shfl_xor_sync(FULL, ya, o);
            }
            if (lane == 0) {
                scratch[so.cols + 2 * K3_BN * t + r] = yy;
                scratch[so.cols + 2 * K3_BN * t + K3_BN + r] = ya;
            }
        }
    }
    // phase C's operand: each chunk of 64 columns of d through shared memory,
    // a warp a row (a column of d) of a (part, K-block) at a time
    uint32_t* ctile = sc + so.ct + (size_t)t * 4 * NP * pl.dc * 32;
    for (int c = sl; c < pl.nch; c += slices) {
        const int f0 = K3_NCMAX * c, ncc = c + 1 < pl.nch ? K3_NCMAX : pl.nc_last;
        __syncthreads();   // the previous chunk is read
        for (int e = threadIdx.x; e < K3_BN * K3_BN; e += 256) {
            const int j = e >> 6, f = e & 63, k = f0 + f;
            const bool live = j < rows && k < d;
            const size_t at = (size_t)(K3_BN * t + j) * d + k;
            tr[0][j][f] = live ? __ldg(A + at) : 0.f;
            tr[1][j][f] = live ? __ldg(y + at) : 0.f;
        }
        __syncthreads();
        uint32_t* base = ctile + (size_t)c * 4 * NP * K3_NCMAX * 32;
        for (int R = w; R < 4 * ncc; R += 8) {
            const int blk = R / ncc, f = R % ncc;
            const int jp = 32 * (blk & 1) + 8 * (lane >> 3) + k3_perm(lane & 7);
            k3_pieces<NP>(tr[blk >> 1][jp][f], base + (size_t)blk * NP * ncc * 32 + k3_swz(f, lane),
                          ncc * 32);
        }
    }
}

// ---------------------------------------------------------------------------
// The product's pieces
// ---------------------------------------------------------------------------

// f', f'' of V arguments: the family in registers, or the interpreter one
// argument at a time in a loop (one inlined copy of the interpreter)
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

// c (+)= A B for a 64 x 128 x 8 tf32 tile, A and B from shared memory (B:
// y's 64 rows then A's, so c[0 .. 32) is S and c[32 .. 64) is Q, in the
// fragment order of wgmma_tf32); `acc` 0 overwrites c
__device__ __forceinline__ void k3_wgmma_sq(float (&c)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]),
          "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]),
          "+f"(c[13]), "+f"(c[14]), "+f"(c[15]), "+f"(c[16]), "+f"(c[17]), "+f"(c[18]),
          "+f"(c[19]), "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]), "+f"(c[24]),
          "+f"(c[25]), "+f"(c[26]), "+f"(c[27]), "+f"(c[28]), "+f"(c[29]), "+f"(c[30]),
          "+f"(c[31]), "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]), "+f"(c[36]),
          "+f"(c[37]), "+f"(c[38]), "+f"(c[39]), "+f"(c[40]), "+f"(c[41]), "+f"(c[42]),
          "+f"(c[43]), "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]), "+f"(c[48]),
          "+f"(c[49]), "+f"(c[50]), "+f"(c[51]), "+f"(c[52]), "+f"(c[53]), "+f"(c[54]),
          "+f"(c[55]), "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]), "+f"(c[60]),
          "+f"(c[61]), "+f"(c[62]), "+f"(c[63])
        : "l"(da), "l"(db), "r"(acc));
}

#define K3_RA(NN, ACC, ...)                                                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #NN ", 0;\n"                            \
                 "wgmma.mma_async.sync.aligned.m64n" ACC ".f32.tf32.tf32 " __VA_ARGS__)

// c[O ..] += A B for a 64 x N x 8 tf32 tile, A (64 x 8) in registers (the
// fragments of mma.m16n8k8 in each warp: a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4)), B from shared memory; c[O .. O + N / 2)
// in the fragment order of wgmma_tf32; `acc` 0 overwrites them
template <int O, int N>
__device__ __forceinline__ void k3_wgmma_ra(float (&c)[64], const uint32_t* a, uint64_t db,
                                            int acc) {
    static_assert(O + N / 2 <= 64, "accumulator past the array");
    if constexpr (N == 8) {
        K3_RA(9, "8k8", "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
              : "+f"(c[O]), "+f"(c[O + 1]), "+f"(c[O + 2]), "+f"(c[O + 3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    } else if constexpr (N == 16) {
        K3_RA(13, "16k8", "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
              : "+f"(c[O]), "+f"(c[O + 1]), "+f"(c[O + 2]), "+f"(c[O + 3]), "+f"(c[O + 4]),
                "+f"(c[O + 5]), "+f"(c[O + 6]), "+f"(c[O + 7])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    } else if constexpr (N == 32) {
        K3_RA(21, "32k8",
              "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
              "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
              : "+f"(c[O]), "+f"(c[O + 1]), "+f"(c[O + 2]), "+f"(c[O + 3]), "+f"(c[O + 4]),
                "+f"(c[O + 5]), "+f"(c[O + 6]), "+f"(c[O + 7]), "+f"(c[O + 8]), "+f"(c[O + 9]),
                "+f"(c[O + 10]), "+f"(c[O + 11]), "+f"(c[O + 12]), "+f"(c[O + 13]),
                "+f"(c[O + 14]), "+f"(c[O + 15])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    } else {
        static_assert(N == 64, "phase C's widths are 8, 16, 32 and 64");
        K3_RA(37, "64k8",
              "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
              "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
              "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
              : "+f"(c[O]), "+f"(c[O + 1]), "+f"(c[O + 2]), "+f"(c[O + 3]), "+f"(c[O + 4]),
                "+f"(c[O + 5]), "+f"(c[O + 6]), "+f"(c[O + 7]), "+f"(c[O + 8]), "+f"(c[O + 9]),
                "+f"(c[O + 10]), "+f"(c[O + 11]), "+f"(c[O + 12]), "+f"(c[O + 13]),
                "+f"(c[O + 14]), "+f"(c[O + 15]), "+f"(c[O + 16]), "+f"(c[O + 17]),
                "+f"(c[O + 18]), "+f"(c[O + 19]), "+f"(c[O + 20]), "+f"(c[O + 21]),
                "+f"(c[O + 22]), "+f"(c[O + 23]), "+f"(c[O + 24]), "+f"(c[O + 25]),
                "+f"(c[O + 26]), "+f"(c[O + 27]), "+f"(c[O + 28]), "+f"(c[O + 29]),
                "+f"(c[O + 30]), "+f"(c[O + 31])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    }
}
#undef K3_RA

// Phase C's accumulators: the products of a part and a pass go to an
// accumulator of their own where they fit (the big pieces' pass apart from
// the two small ones'), summed in a fixed order at the store (`k3_store`):
// at nc <= 16 four, 8 floats apart; at nc = 32 one a part, 16 apart; at
// nc = 64 one, acc[0 .. 32). They hold one tile's sums (the tile's first
// product into each overwrites it): the tiles are added in fp32 on the
// CUDA cores, not along one chain of tensor-core accumulations a split.
template <int PART, int V>
__device__ __forceinline__ void k3_mma_c(float (&acc)[64], const uint32_t* a, uint64_t db, int nc,
                                         bool first) {
    constexpr int SLOT = 2 * PART + (V > 0);
    // does this product find its accumulator's tile sum begun?
    const int on = !first || V == 2 || (V == 1 && nc > 16) || (V == 0 && PART == 1 && nc == 64);
    switch (nc) {
    case 8: k3_wgmma_ra<8 * SLOT, 8>(acc, a, db, on); break;
    case 16: k3_wgmma_ra<8 * SLOT, 16>(acc, a, db, on); break;
    case 32: k3_wgmma_ra<16 * PART, 32>(acc, a, db, on); break;
    default: k3_wgmma_ra<0, 64>(acc, a, db, on);
    }
}

// The thread's pairs of a tile: rows ra, ra + 8, columns 8 i + 2 t, + 1 of
// group i = 0 .. 7, pair 4 i + e in the accumulators' order (e: row ra +
// 8 (e >> 1), column + (e & 1)); S at sq[4 i + e], Q at sq[32 + 4 i + e].

// the pairs of group i inside the tile's cnt columns (bits e)
__device__ __forceinline__ unsigned k3_valid(int i, int t, int cnt) {
    const int jl = 8 * i + 2 * t;
    return (jl < cnt ? 5u : 0u) | (jl + 1 < cnt ? 10u : 0u);
}

// s and w by the expansion in place of S and Q (iso; dot takes S and Q as
// they are); returns the pairs of the product (rows below n, columns below
// cnt) with s <= tau (|x_i|^2 + |y_j|^2), bit 4 i + e. `cols` the tile's
// |y|^2 and <y, A>.
template <bool ISO>
__device__ __forceinline__ unsigned k3_expand(float (&sq)[64], const float* cols, int t,
                                              float x2a, float x2b, int ra, int n, int j0,
                                              int cnt, bool same) {
    unsigned near = 0;
    if constexpr (ISO) {
        unsigned live = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int jl = 8 * i + 2 * t;
            const float2 y2v = *reinterpret_cast<const float2*>(cols + jl);
            const float2 yav = *reinterpret_cast<const float2*>(cols + K3_BN + jl);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float q = (e < 2 ? x2a : x2b) + (e & 1 ? y2v.y : y2v.x);
                const float se = fmaf(-2.f, sq[4 * i + e], q);
                if (se <= K3_TAU * q) near |= 1u << (4 * i + e);
                sq[4 * i + e] = fmaxf(se, 0.f);
                sq[32 + 4 * i + e] -= e & 1 ? yav.y : yav.x;
            }
            live |= k3_valid(i, t, cnt) << (4 * i);
        }
        if (ra >= n) live &= 0xCCCCCCCCu;       // e = 0, 1: row ra
        if (ra + 8 >= n) live &= 0x33333333u;   // e = 2, 3: row ra + 8
        near &= live;
        // x is y: a pair of a point with itself has r = 0, so s = w = 0 exactly,
        // what the difference form gives (only tiles across the diagonal)
        if (same && j0 <= ra + 8 && ra < j0 + K3_BN)
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (ra + 8 * (e >> 1) == j0 + 8 * i + 2 * t + (e & 1)) {
                        sq[4 * i + e] = 0.f;
                        sq[32 + 4 * i + e] = 0.f;
                        near &= ~(1u << (4 * i + e));
                    }
    }
    return near;
}

// The warp's near pairs in difference form from x, y and A in fp32, one
// pair at a time over the warp's lanes (lanes in order, each lane's pairs in
// order), s and w into place. rw the warp's first row, j0 the tile's first
// column; vec4: 16-byte loads (d a multiple of 4, the arrays aligned).
__device__ __forceinline__ void k3_near(float (&sq)[64], unsigned near, int lane, int rw, int j0,
                                        int d, int vec4, const float* x, const float* y,
                                        const float* A) {
    constexpr unsigned FULL = 0xffffffffu;
    unsigned pending = __ballot_sync(FULL, near != 0);
    while (pending) {
        const int L = __ffs(pending) - 1;
        const int bit = __ffs(__shfl_sync(FULL, near, L)) - 1, e = bit & 3;
        if (lane == L) near &= near - 1;
        const float* xi = x + (size_t)(rw + (L >> 2) + 8 * (e >> 1)) * d;
        const size_t j = (size_t)(j0 + 8 * (bit >> 2) + 2 * (L & 3) + (e & 1)) * d;
        const float* yj = y + j;
        const float* Aj = A + j;
        float s1 = 0.f, w1 = 0.f;
        if (vec4) {
            for (int k = 4 * lane; k < d; k += 128) {
                const float4 xv = *reinterpret_cast<const float4*>(xi + k);
                const float4 yv = *reinterpret_cast<const float4*>(yj + k);
                const float4 av = *reinterpret_cast<const float4*>(Aj + k);
                const float df[4] = {xv.x - yv.x, xv.y - yv.y, xv.z - yv.z, xv.w - yv.w};
                const float ac[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    s1 = fmaf(df[u], df[u], s1);
                    w1 = fmaf(df[u], ac[u], w1);
                }
            }
        } else {
            for (int k = lane; k < d; k += 32) {
                const float df = xi[k] - yj[k];
                s1 = fmaf(df, df, s1);
                w1 = fmaf(df, Aj[k], w1);
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            s1 += __shfl_xor_sync(FULL, s1, o);
            w1 += __shfl_xor_sync(FULL, w1, o);
        }
        if (lane == L)
#pragma unroll
            for (int u = 0; u < 32; ++u)
                if (u == bit) {
                    sq[u] = s1;
                    sq[32 + u] = w1;
                }
        pending = __ballot_sync(FULL, near != 0);
    }
}

// alpha and beta of four pairs from s and w, in place; `valid` masks the
// columns past the product (there f may be inf: IMQ with c = 0)
template <bool ISO, int FAM, int P>
__device__ __forceinline__ void k3_ab(const ProfileSpec& sp, const JetConsts& jc,
                                      const float4* tab, float (&sv)[4], float (&wv)[4],
                                      unsigned valid) {
    float f1[4], f2[4];
    k3_jet<FAM, P, 4>(sp, jc, tab, sv, f1, f2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const bool ok = (valid >> e) & 1;
        sv[e] = ok ? (ISO ? -2.f * f1[e] : f1[e]) : 0.f;
        wv[e] = ok ? (ISO ? 4.f : 1.f) * f2[e] * wv[e] : 0.f;
    }
}

// alpha and beta of the tile's pairs in place of s and w, and the tile's
// rowsum(beta) shares ta, tb; the interpreter runs once, the groups in a
// loop, picked by selects (no local copy of the array)
template <bool ISO, int FAM, int P>
__device__ __forceinline__ void k3_ab_tile(float (&sq)[64], float& ta, float& tb,
                                           const ProfileSpec& sp, const JetConsts& jc,
                                           const float4* tab, int t, int cnt) {
    if constexpr (FAM == 0) {
#pragma unroll 1
        for (int i = 0; i < 8; ++i) {
            float sv[4], wv[4];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (u == i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        sv[e] = sq[4 * u + e];
                        wv[e] = sq[32 + 4 * u + e];
                    }
            k3_ab<ISO, FAM, P>(sp, jc, tab, sv, wv, k3_valid(i, t, cnt));
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (u == i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        sq[4 * u + e] = sv[e];
                        sq[32 + 4 * u + e] = wv[e];
                    }
        }
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float sv[4] = {sq[4 * i], sq[4 * i + 1], sq[4 * i + 2], sq[4 * i + 3]};
            float wv[4] = {sq[32 + 4 * i], sq[33 + 4 * i], sq[34 + 4 * i], sq[35 + 4 * i]};
            k3_ab<ISO, FAM, P>(sp, jc, tab, sv, wv, k3_valid(i, t, cnt));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sq[4 * i + e] = sv[e];
                sq[32 + 4 * i + e] = wv[e];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        ta += sq[32 + 4 * i] + sq[33 + 4 * i];
        tb += sq[34 + 4 * i] + sq[35 + 4 * i];
    }
}

// Phase C of group i: out += alpha A_group + beta Y_group, alpha and beta
// (accumulator order) split into the tier's pieces as register A fragments,
// the group's wgmmas waited for before the fragments' registers are reused;
// `cit` the chunk's operand in its stage, nc its columns. (Two or four
// groups a wait measured the same; A staged in shared memory instead kept
// the tile's alpha and beta live across the products and was slower.)
template <int PASSES>
__device__ __forceinline__ void k3_c_group(float (&acc)[64], const float (&al)[4],
                                           const float (&be)[4], uint32_t cit, int nc, int i) {
    constexpr int NP = tc_pieces(PASSES);
    const float va[4] = {al[0], al[2], al[1], al[3]}, vb[4] = {be[0], be[2], be[1], be[3]};
    uint32_t fr[2][NP * 4];
    split_a<NP>(va, fr[0]);
    split_a<NP>(vb, fr[1]);
    wg_fence();
    // B of part p and piece v: (p 2 + i / 4) NP + v blocks of nc rows on
    const uint32_t cb = cit + (i & 3) * 32;
    const auto b = [&](int p, int v) {
        return sw128_desc(cb + ((p * 2 + (i >> 2)) * NP + v) * nc * K3_ROW);
    };
    k3_mma_c<0, 0>(acc, &fr[0][4 * tc_piece_a(PASSES, 0)], b(0, tc_piece_b(PASSES, 0)), nc, i == 0);
    k3_mma_c<1, 0>(acc, &fr[1][4 * tc_piece_a(PASSES, 0)], b(1, tc_piece_b(PASSES, 0)), nc, i == 0);
    if constexpr (PASSES == 3) {
        k3_mma_c<0, 1>(acc, &fr[0][4 * tc_piece_a(PASSES, 1)], b(0, tc_piece_b(PASSES, 1)), nc, i == 0);
        k3_mma_c<1, 1>(acc, &fr[1][4 * tc_piece_a(PASSES, 1)], b(1, tc_piece_b(PASSES, 1)), nc, i == 0);
        k3_mma_c<0, 2>(acc, &fr[0][4 * tc_piece_a(PASSES, 2)], b(0, tc_piece_b(PASSES, 2)), nc, i == 0);
        k3_mma_c<1, 2>(acc, &fr[1][4 * tc_piece_a(PASSES, 2)], b(1, tc_piece_b(PASSES, 2)), nc, i == 0);
    }
    wg_commit();
    wg_wait<0>();
}

// The tile's sum of output column e of the thread (e < nc / 2): its
// accumulators in a fixed order (the passes' at nc <= 16, the parts' at
// nc = 32)
template <int PASSES>
__device__ __forceinline__ float k3_tile_sum(const float (&acc)[64], int e, int nc) {
    if (e < 8 && nc <= 16)
        return PASSES == 3 ? ((acc[e] + acc[8 + (e & 7)]) + acc[16 + (e & 7)]) + acc[24 + (e & 7)]
                           : acc[e] + acc[16 + (e & 7)];
    if (e < 16 && nc == 32) return acc[e] + acc[16 + (e & 15)];
    return acc[e];
}

// The rows' output columns k0 .. k0 + nc: the tile's sums added in fp32 to
// the split's tiles before it, `tot` in registers (nc <= 32) or the block's
// rows of the split's partial output (none at its first tile, `first`);
// after the split's last tile less rowsum(beta) x_i (va, vb: rows ra,
// ra + 8; iso) and written. acc is only read.
template <bool ISO, int PASSES>
__device__ __forceinline__ void k3_store(const float (&acc)[64], float (&tot)[16], float* out,
                                         float va, float vb, const float* x, int ra, int t,
                                         int k0, int nc, int n, int d, bool first, bool last) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
        const int r = e & 2 ? ra + 8 : ra, k = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (8 * (e >> 2) >= nc) continue;
        float* o = out + (size_t)r * d + k;
        float v = k3_tile_sum<PASSES>(acc, e, nc);
        if (e < 16 && nc <= 32) {
            v = tot[e & 15] = first ? v : tot[e & 15] + v;
        } else if (r < n && k < d) {
            if (!first) v = *o + v;
            if (!last) *o = v;
        }
        if (last && r < n && k < d) {
            if (ISO) v -= (e & 2 ? vb : va) * x[(size_t)r * d + k];
            *o = v;
        }
    }
}

// hand back the k oldest items the warpgroup holds
__device__ __forceinline__ void k3_release(int k, int& held, int& rs, uint64_t* empty,
                                           int stages) {
    for (; k > 0; --k, --held) {
        mbar_arrive(&empty[rs]);
        if (++rs == stages) rs = 0;
    }
}

// ---------------------------------------------------------------------------
// The product: block (row block, column split), 384 threads; warps 0-7 the
// two consumer warpgroups (rows 64 h .. 64 h + 63 of the block, 232
// registers a thread), warps 8-11 the producer's (40), warp 8 lane 0 its
// one busy thread. Each tile of 64 columns is nkb phase-A items then nch
// phase-C items in the ring.
// ---------------------------------------------------------------------------
template <bool ISO, int FAM, int P, int PASSES>
__global__ void __launch_bounds__(K3_THREADS, 1)
k3_tc(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ A,
      const float* __restrict__ scratch, const K3Scratch so, float* __restrict__ partial, int n,
      int m, int d, int tiles_per_split, int vec4, int same,
      const __grid_constant__ ProfileSpec spec,
      const __grid_constant__ JetConsts jc, const float4* __restrict__ tab) {
    constexpr unsigned FULL = 0xffffffffu;
    constexpr int NP = tc_pieces(PASSES);
    constexpr bool TABLE = FAM == FAM_MATERN_NU;
    extern __shared__ __align__(16) uint8_t k3_smem[];
    __shared__ ProfileSpec sp;
    __shared__ uint64_t full[K3_MAX_STAGES], empty[K3_MAX_STAGES], x_full;

    const K3Plan pl = k3_plan(d, PASSES, TABLE);
    uint8_t* base = k3_smem + ((K3_ALIGN - (smem_addr(k3_smem) & (K3_ALIGN - 1))) & (K3_ALIGN - 1));
    uint8_t* xs = base;
    uint8_t* ring = base + pl.x_bytes;
    float4* tabs = reinterpret_cast<float4*>(ring + (size_t)pl.stages * pl.stage_bytes);

    if constexpr (FAM == 0) load_spec(sp, spec);
    if constexpr (TABLE)
        for (int r = threadIdx.x; r < 2 * MATERN_JET_KNOTS; r += K3_THREADS) tabs[r] = tab[r];
    if (threadIdx.x == 0) {
        for (int s = 0; s < pl.stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        mbar_init(&x_full, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warp's index through a shuffle: one value a warp to the compiler,
    // so the consumers' path is not divergent (it would serialize wgmmas)
    const int warp = __shfl_sync(FULL, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
    const int row0 = blockIdx.x * K3_BM;
    const int tile0 = blockIdx.y * tiles_per_split;
    const int ntiles = min(tiles_per_split, (m + K3_BN - 1) / K3_BN - tile0);
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(scratch);
    // the block's two 64-row tiles of x's pieces
    const uint8_t* xg = sb + 4 * so.xp + (size_t)2 * blockIdx.x * pl.nkb * NP * K3_CHUNK;

    if (warp >= 8) {
        // ---- the producer warpgroup: its registers go to the consumers; one
        //      lane issues every copy ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (warp != 8 || lane != 0) return;
        if (pl.resident) {
            mbar_expect(&x_full, pl.x_bytes);
            for (int kb = 0; kb < pl.nkb; ++kb)
                for (int h = 0; h < 2; ++h)
                    bulk_copy(xs + (kb * 2 + h) * NP * K3_CHUNK,
                              xg + ((size_t)h * pl.nkb + kb) * NP * K3_CHUNK, NP * K3_CHUNK,
                              &x_full);
        }
        int s = 0, ph = 0;
        for (int tt = 0; tt < ntiles; ++tt) {
            const size_t t = tile0 + tt;
            const uint8_t* yt = sb + 4 * so.ypa + t * pl.nkb * pl.b_item;
            for (int kb = 0; kb < pl.nkb; ++kb, ring_next(s, ph, pl.stages)) {
                mbar_wait(&empty[s], ph ^ 1);
                uint8_t* stage = ring + (size_t)s * pl.stage_bytes;
                mbar_expect(&full[s], pl.b_item + (pl.resident ? 0 : 2 * NP * K3_CHUNK));
                bulk_copy(stage, yt + (size_t)kb * pl.b_item, pl.b_item, &full[s]);
                if (!pl.resident)
                    for (int h = 0; h < 2; ++h)
                        bulk_copy(stage + pl.b_item + h * NP * K3_CHUNK,
                                  xg + ((size_t)h * pl.nkb + kb) * NP * K3_CHUNK, NP * K3_CHUNK,
                                  &full[s]);
            }
            const uint8_t* ct = sb + 4 * so.ct + t * 4 * NP * pl.dc * K3_ROW;
            for (int c = 0; c < pl.nch; ++c, ring_next(s, ph, pl.stages)) {
                mbar_wait(&empty[s], ph ^ 1);
                uint8_t* stage = ring + (size_t)s * pl.stage_bytes;
                const int cb = 4 * NP * (c + 1 < pl.nch ? K3_NCMAX : pl.nc_last) * K3_ROW;
                mbar_expect(&full[s], cb + (c == 0 ? K3_COLS : 0));
                bulk_copy(stage, ct + (size_t)c * 4 * NP * K3_NCMAX * K3_ROW, cb, &full[s]);
                if (c == 0)
                    bulk_copy(stage + pl.stage_bytes - K3_COLS,
                              sb + 4 * (so.cols + 2 * K3_BN * t), K3_COLS, &full[s]);
            }
        }
        return;
    }

    // ---- the consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int h = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int rw = row0 + 64 * h + 16 * w, ra = rw + g;
    const float* x2 = scratch + so.x2;
    const float x2a = ISO ? x2[ra] : 0.f, x2b = ISO ? x2[ra + 8] : 0.f;
    float* out = partial + (size_t)blockIdx.y * n * d;
    if (pl.resident) mbar_wait(&x_full, 0);

    float sq[64];                 // S and Q; then s and w; then alpha and beta
    float acc[64];                // a tile's sums of the rows' output columns (k3_mma_c)
    float tot[16];                // the split's sums so far, where nc <= 32 (k3_store)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    float rsa = 0.f, rca = 0.f, rsb = 0.f, rcb = 0.f;   // rowsum(beta), compensated
    int s = 0, ph = 0, rs = 0, held = 0;   // the next item to wait for; to hand back
    // the second warpgroup issues its first products after the first's, so
    // that the two take turns on the tensor cores
    if (h == 1 && ntiles > 0) bar_sync(1, 256);
    for (int tt = 0; tt < ntiles; ++tt) {
        const int j0 = (tile0 + tt) * K3_BN, cnt = min(K3_BN, m - j0);
        const bool last = tt + 1 == ntiles;

        // ---- A: [S | Q] = X [Y; A]^T; a ring shorter than the tile's items
        //      is handed back early, once the products are waited for ----
        wg_fence();
        int accf = 0;
        for (int kb = 0; kb < pl.nkb; ++kb) {
            if (held == pl.stages) {
                wg_commit();
                wg_wait<0>();
                k3_release(held, held, rs, empty, pl.stages);
            }
            mbar_wait(&full[s], ph);
            const uint32_t st = smem_addr(ring + (size_t)s * pl.stage_bytes);
            const uint32_t xa = (pl.resident ? smem_addr(xs) + kb * 2 * NP * K3_CHUNK
                                             : st + pl.b_item) + h * NP * K3_CHUNK;
            const int steps = min(4, (d - 32 * kb + 7) / 8);
            for (int u = 0; u < steps; ++u) {
#pragma unroll
                for (int v = 0; v < PASSES; ++v) {
                    k3_wgmma_sq(sq, sw128_desc(xa + tc_piece_a(PASSES, v) * K3_CHUNK + u * 32),
                                sw128_desc(st + tc_piece_b(PASSES, v) * 2 * K3_CHUNK + u * 32),
                                accf);
                    accf = 1;
                }
            }
            // the second warpgroup may start once the first K-block's products
            // are issued (not the tile's: a short ring needs its releases)
            if (h == 0 && tt == 0 && kb == 0) bar_arrive(1, 256);
            ++held;
            ring_next(s, ph, pl.stages);
        }
        wg_commit();
        wg_wait<0>();
        acc_fence(sq);
        k3_release(held, held, rs, empty, pl.stages);

        // ---- B and C. Every path below ends with its wgmmas waited for, and
        //      none writes a register that a wgmma in flight accumulates into
        //      (ptxas would serialize every wgmma of the kernel) ----
        mbar_wait(&full[s], ph);
        const uint8_t* citem = ring + (size_t)s * pl.stage_bytes;
        const uint32_t cit = smem_addr(citem);
        ++held;
        ring_next(s, ph, pl.stages);
        const unsigned near = k3_expand<ISO>(
            sq, reinterpret_cast<const float*>(citem + pl.stage_bytes - K3_COLS), t, x2a, x2b, ra,
            n, j0, cnt, same);
        if constexpr (ISO) k3_near(sq, near, lane, rw, j0, d, vec4, x, y, A);
        const bool one = pl.nch == 1;
        float ta = 0.f, tb = 0.f;   // this tile's rowsum(beta), rows ra, ra + 8
        // alpha and beta in place of s and w, before any phase C: the
        // interpreter's always (its jet once, in a loop), the families' where
        // phase C takes the tile in chunks
        if (FAM == 0 || !one) k3_ab_tile<ISO, FAM, P>(sq, ta, tb, sp, jc, tabs, t, cnt);
        if (one) {
            // C group by group, each group's jet (families) beside the other
            // warpgroup's products
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float sv[4] = {sq[4 * i], sq[4 * i + 1], sq[4 * i + 2], sq[4 * i + 3]};
                float wv[4] = {sq[32 + 4 * i], sq[33 + 4 * i], sq[34 + 4 * i], sq[35 + 4 * i]};
                if constexpr (FAM != 0) {
                    k3_ab<ISO, FAM, P>(sp, jc, tabs, sv, wv, k3_valid(i, t, cnt));
                    ta += wv[0] + wv[1];
                    tb += wv[2] + wv[3];
                }
                k3_c_group<PASSES>(acc, sv, wv, cit, pl.nc, i);
            }
            acc_fence(acc);
        }
        kahan_add(rsa, rca, ta);
        kahan_add(rsb, rcb, tb);
        // rowsum(beta) of the rows, over the quad's four lanes (same rows)
        float va = rsa - rca, vb = rsb - rcb;
        va += __shfl_xor_sync(FULL, va, 1);
        vb += __shfl_xor_sync(FULL, vb, 1);
        va += __shfl_xor_sync(FULL, va, 2);
        vb += __shfl_xor_sync(FULL, vb, 2);
        if (one) {
            k3_store<ISO, PASSES>(acc, tot, out, va, vb, x, ra, t, 0, pl.nc, n, d, tt == 0, last);
            k3_release(1, held, rs, empty, pl.stages);
            continue;
        }
        // chunks of 64 columns
        for (int c = 0; c < pl.nch; ++c) {
            uint32_t cc = cit;
            if (c > 0) {
                mbar_wait(&full[s], ph);
                cc = smem_addr(ring + (size_t)s * pl.stage_bytes);
                ++held;
                ring_next(s, ph, pl.stages);
            }
            const int nc = c + 1 < pl.nch ? K3_NCMAX : pl.nc_last;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float al[4] = {sq[4 * i], sq[4 * i + 1], sq[4 * i + 2], sq[4 * i + 3]};
                const float be[4] = {sq[32 + 4 * i], sq[33 + 4 * i], sq[34 + 4 * i], sq[35 + 4 * i]};
                k3_c_group<PASSES>(acc, al, be, cc, nc, i);
            }
            acc_fence(acc);
            k3_store<ISO, PASSES>(acc, tot, out, va, vb, x, ra, t, K3_NCMAX * c, nc, n, d, tt == 0,
                                  last);
            k3_release(1, held, rs, empty, pl.stages);
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
    const float *x, *y, *A, *scratch;
    K3Scratch so;
    float* partial;
    int n, m, d, per, vec4, same;
    const float4* tab;
};

template <bool ISO, int FAM, int P, int PASSES>
static int k3_go(dim3 grid, cudaStream_t st, const K3Args& g, const ProfileSpec& spec,
                 const JetConsts& jc) {
    constexpr bool TABLE = FAM == FAM_MATERN_NU;
    if (TABLE && g.tab == nullptr) return (int)cudaErrorInvalidValue;
    const K3Plan pl = k3_plan(g.d, PASSES, TABLE);
    if (pl.stages < 2) return (int)cudaErrorInvalidValue;
    // once an instance: the most any plan takes beside the static memory
    static const cudaError_t attr =
        cudaFuncSetAttribute(k3_tc<ISO, FAM, P, PASSES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM - K3_STATIC);
    if (attr != cudaSuccess) return (int)attr;
    k3_tc<ISO, FAM, P, PASSES><<<grid, K3_THREADS, pl.smem, st>>>(
        g.x, g.y, g.A, g.scratch, g.so, g.partial, g.n, g.m, g.d, g.per, g.vec4, g.same, spec, jc,
        g.tab);
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

// The floats of scratch k3_grad_matvec takes from the wrapper (the split's
// pieces and norms), -1 for a shape it does not take.
extern "C" long long k3_scratch(int n, int m, int d, int passes) {
    if (n < 1 || m < 1 || d < 1 || (passes != 1 && passes != 3)) return -1;
    return k3_scratch_of(n, m, d, passes).total;
}

// Rows a block and columns a tile, for the wrapper's grid plan.
extern "C" void k3_shape(int* rows, int* cols) {
    *rows = K3_BM;
    *cols = K3_BN;
}

// Whether x's pieces stay in shared memory for d at `passes` (the real-nu
// Matern's tables beside them when `table`): 1 resident, 0 streamed.
extern "C" int k3_resident(int d, int passes, int table) {
    if (d < 1 || (passes != 1 && passes != 3)) return -1;
    return k3_plan(d, passes, table != 0).resident;
}

// out = K3(x, y, A), x (n, d), y and A (m, d). Scratch from the wrapper, of
// k3_scratch's size. The grid is (ceil(n / 128), splits), split s taking
// column tiles s per .. s per + per - 1; with splits > 1, partial (splits,
// n, d) holds the splits' sums and k3_reduce adds them into out.
extern "C" int k3_grad_matvec(const float* x, const float* y, const float* A, float* scratch,
                              float* partial, float* out, int n, int m, int d, int iso,
                              int splits, int tiles_per_split, int passes, int family, int p,
                              int vec4, int same, ProfileSpec spec, JetConsts jc,
                              const float4* tab, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n < 1 || m < 1 || d < 1 || (passes != 1 && passes != 3)) return (int)cudaErrorInvalidValue;
    const int ytiles = (m + K3_BN - 1) / K3_BN, row_blocks = (n + K3_BM - 1) / K3_BM;
    if (tiles_per_split < 1 || splits != (ytiles + tiles_per_split - 1) / tiles_per_split)
        return (int)cudaErrorInvalidValue;
    const K3Scratch so = k3_scratch_of(n, m, d, passes);
    const K3Plan pl = k3_plan(d, passes, false);
    // the split's blocks: a tile's K-blocks and chunks in up to 8 slices
    const int slices = pl.nkb > pl.nch ? pl.nkb : pl.nch;
    const dim3 sgrid(ytiles + 2 * row_blocks, slices < 8 ? slices : 8);
    if (passes == 1)
        k3_tc<1><<<sgrid, 256, 0, st>>>(x, y, A, n, m, d, ytiles, pl, scratch, so);
    else
        k3_tc<2><<<sgrid, 256, 0, st>>>(x, y, A, n, m, d, ytiles, pl, scratch, so);
    const dim3 grid(row_blocks, splits);
    const K3Args g{x, y, A, scratch, so, partial, n, m, d, tiles_per_split, vec4, same, tab};
    const int bad = passes == 1 ? k3_by_family<1>(iso, family, p, grid, st, g, spec, jc)
                                : k3_by_family<3>(iso, family, p, grid, st, g, spec, jc);
    if (bad) return bad;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (splits > 1) {
        const long long total = (long long)n * d;
        k3_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(partial, out, total, splits);
    }
    return (int)cudaGetLastError();
}
