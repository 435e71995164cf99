// Tensor-core building blocks shared by K2 (expand_mvm.cu) and K3
// (grad_mvm.cu): tf32 splits of fp32 operands, the warp-level
// mma.sync.m16n8k8 tf32 product, fragment loads from shared memory, and
// the staged X Y^T (and X A^T) tile both kernels start from.
//
// The matmul tiers (cfjax_torch/ops/tiles.py, cfjax's `matmul_precision`)
// map onto passes over the tensor cores. A float v is split into NP tf32
// pieces, each rounded to nearest (cvt.rna): v ~ p0 (+ p1), every piece 11
// significant bits, the rest of v below 2^-11 (2^-22) of |v|. A product
// a b is then a sum of piece products, the smallest first:
//   "default"            1 pass:   a0 b0 (tf32 inputs, as the tensor cores
//                                  take them);
//   "high", "highest"    3 passes: a1 b0 + a0 b1 + a0 b0 (3xTF32: what
//                                  ops/tiles.py emulates on the card, the
//                                  a1 b1 term dropped).
// Each piece product is exact in the tensor cores' fp32 accumulate; the
// passes add into one fp32 accumulator.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// pieces of each operand of a tier's passes (1 or 3)
__host__ __device__ constexpr int tc_pieces(int passes) { return passes == 1 ? 1 : 2; }
// the u-th product of `passes`: (piece of a, piece of b), smallest first
__host__ __device__ constexpr int tc_piece_a(int passes, int u) {
    return passes == 3 && u == 0 ? 1 : 0;
}
__host__ __device__ constexpr int tc_piece_b(int passes, int u) {
    return passes == 3 && u == 1 ? 1 : 0;
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// v -> NP tf32 pieces
template <int NP>
__device__ __forceinline__ void tf32_split(float v, uint32_t* p) {
    p[0] = to_tf32(v);
    if constexpr (NP > 1) p[1] = to_tf32(v - __uint_as_float(p[0]));
}

// D += A B for one m16n8k8 tf32 tile (fp32 accumulate). Fragments, lane =
// 4 g + t: A (16 x 8, row-major) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g); C / D
// (16 x 8) c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t), c3 (g + 8, 2 t + 1).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragments of a 16 x 8 tile of fp32 values v (in fragment order a0..a3)
// split into NP pieces: a[q * 4 + e] is piece q of element e
template <int NP>
__device__ __forceinline__ void split_a(const float (&v)[4], uint32_t (&a)[NP * 4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        uint32_t p[NP];
        tf32_split<NP>(v[e], p);
#pragma unroll
        for (int q = 0; q < NP; ++q) a[q * 4 + e] = p[q];
    }
}

template <int NP>
__device__ __forceinline__ void split_b(float v0, float v1, uint32_t (&b)[NP * 2]) {
    uint32_t p[NP], r[NP];
    tf32_split<NP>(v0, p);
    tf32_split<NP>(v1, r);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
        b[q * 2] = p[q];
        b[q * 2 + 1] = r[q];
    }
}

// c += a b over the piece products of PASSES
template <int PASSES>
__device__ __forceinline__ void mma_passes(float* c, const uint32_t* a, const uint32_t* b) {
#pragma unroll
    for (int u = 0; u < PASSES; ++u)
        mma_tf32(c, a + 4 * tc_piece_a(PASSES, u), b + 2 * tc_piece_b(PASSES, u));
}

// A fragment from a row-major (row, k) array at `base` = [row0][k0]
__device__ __forceinline__ void load_a_rowmajor(const float* base, int stride, float (&v)[4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    v[0] = base[g * stride + t];
    v[1] = base[(g + 8) * stride + t];
    v[2] = base[g * stride + t + 4];
    v[3] = base[(g + 8) * stride + t + 4];
}

// ---------------------------------------------------------------------------
// cp.async staging, zero-filled where `live` is false: 4-byte copies, or
// 16-byte ones (4 floats) where d is a multiple of 4 and the arrays are
// 16-byte aligned (the wrappers check)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool live) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(live ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows r0 .. r0 + ROWS of a row-major (rows, d) array, columns k0 .. k0 +
// COLS, into dst[r][c] (row stride SD floats); rows past `rows` and
// columns past d are zero
template <int ROWS, int COLS, int SD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int d,
                                           int r0, int k0, bool vec4) {
    // the source and d pass through an empty volatile asm, so the addresses
    // are formed here at each call: hoisted out of the callers' loops, every
    // unrolled copy's 64-bit address took registers for the whole kernel
    asm volatile("" : "+l"(src), "+r"(d));
    if (vec4) {
        for (int e = threadIdx.x; e < ROWS * COLS / 4; e += THREADS) {
            const int r = e / (COLS / 4), c = 4 * (e % (COLS / 4)), i = r0 + r, k = k0 + c;
            const bool live = i < rows && k < d;
            cp_async16(dst + r * SD + c, src + (live ? (size_t)i * d + k : 0), live);
        }
    } else {
        for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
            const int r = e / COLS, c = e % COLS, i = r0 + r, k = k0 + c;
            const bool live = i < rows && k < d;
            cp_async4(dst + r * SD + c, src + (live ? (size_t)i * d + k : 0), live);
        }
    }
}

// ---------------------------------------------------------------------------
// The staged tile: S = X Y^T (and, with NMAT = 2, Q = X A^T) for a block of
// TM = 16 * warps rows and TN columns, over d in chunks of TC_BK,
// double-buffered with cp.async. Warp w owns rows 16 w .. 16 w + 15 and all
// TN columns: its result is S[m][nt][e], n-tile nt = columns 8 nt .. 8 nt +
// 7, element e in the C-fragment order above. Chunks are stored [row][k]
// with a stride of TC_BK + 4 floats: lanes (g, t) read words 20 g + t,
// which fall in 32 distinct banks. The chunk counter q runs on across a
// block's tiles (buffer q & 1): the last chunk of a tile stages the first
// chunk of the next one, which lands while the tile's epilogue runs.
// ---------------------------------------------------------------------------

constexpr int TC_BK = 16;           // depth per staged chunk
constexpr int TC_SK = TC_BK + 4;    // the chunks' row stride

template <int TM, int TN, int NMAT>
struct TcStage {
    float x[2][TM][TC_SK];
    float y[2][NMAT][TN][TC_SK];
};

// stage chunk k0 of rows row0.. (x) and of columns j0 .. j0 + cnt (y, and
// A with NMAT = 2) into buffer b
template <int TM, int TN, int NMAT, int THREADS>
__device__ __forceinline__ void tc_stage(TcStage<TM, TN, NMAT>& st, int b, const float* x,
                                         const float* y, const float* A, int n, int d,
                                         int row0, int j0, int cnt, int k0, bool vec4) {
    stage_rows<TM, TC_BK, TC_SK, THREADS>(&st.x[b][0][0], x, n, d, row0, k0, vec4);
    stage_rows<TN, TC_BK, TC_SK, THREADS>(&st.y[b][0][0][0], y, j0 + cnt, d, j0, k0, vec4);
    if constexpr (NMAT == 2)
        stage_rows<TN, TC_BK, TC_SK, THREADS>(&st.y[b][1][0][0], A, j0 + cnt, d, j0, k0, vec4);
}

// S (and Q) of the tile at columns j0 .. j0 + cnt, in fp32 registers
// (zeroed here). `staged`: the tile's first chunk is already in flight in
// buffer q & 1 (staged by the previous tile); next_cnt > 0 stages the first
// chunk of the tile at next_j0 before this one's last chunk is consumed.
// Ends with a barrier: the buffers may be reused at once.
template <int TM, int TN, int NMAT, int THREADS, int PASSES>
__device__ __forceinline__ void tc_tile(TcStage<TM, TN, NMAT>& st, int& q, bool staged,
                                        const float* x, const float* y, const float* A, int n,
                                        int d, int row0, int j0, int cnt, int next_j0,
                                        int next_cnt, bool vec4, float (&S)[NMAT][TN / 8][4]) {
    constexpr int NP = tc_pieces(PASSES), NT = TN / 8;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) S[m][nt][e] = 0.f;
    const int chunks = (d + TC_BK - 1) / TC_BK;
    if (!staged) {
        tc_stage<TM, TN, NMAT, THREADS>(st, q & 1, x, y, A, n, d, row0, j0, cnt, 0, vec4);
        cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c, ++q) {
        if (c + 1 < chunks || next_cnt > 0) {
            if (c + 1 < chunks)
                tc_stage<TM, TN, NMAT, THREADS>(st, (q + 1) & 1, x, y, A, n, d, row0, j0, cnt,
                                                (c + 1) * TC_BK, vec4);
            else
                tc_stage<TM, TN, NMAT, THREADS>(st, (q + 1) & 1, x, y, A, n, d, row0, next_j0,
                                                next_cnt, 0, vec4);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();   // chunk c has landed for every thread
        const int b = q & 1;
#pragma unroll
        for (int ks = 0; ks < TC_BK / 8; ++ks) {
            float v[4];
            load_a_rowmajor(&st.x[b][16 * w][8 * ks], TC_SK, v);
            uint32_t a[NP * 4];
            split_a<NP>(v, a);
#pragma unroll
            for (int m = 0; m < NMAT; ++m)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    // B[k][n] = Y[n][k]: b0 (t, g) = Y[8 nt + g][8 ks + t]
                    const float* yb = &st.y[b][m][8 * nt + g][8 * ks + t];
                    uint32_t bf[NP * 2];
                    split_b<NP>(yb[0], yb[4], bf);
                    mma_passes<PASSES>(S[m][nt], a, bf);
                }
            // no shared-memory load of the next k-step moves above this one's
            // products: hoisted, the fragments and their pieces would not fit
            // in registers beside the accumulators
            asm volatile("" ::: "memory");
        }
        __syncthreads();   // chunk c is consumed before chunk c + 2 overwrites it
    }
}
