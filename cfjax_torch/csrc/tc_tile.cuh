// Tensor-core building blocks of the port's kernels: the tiers' tf32
// pieces of fp32 operands (K1's many-column kernel, K2 and K3), and the
// warp-level mma.sync.m16n8k8 tf32 product and cp.async staging of K1's
// many-column kernel (gramian_mvm.cu).
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

// c += a b over the piece products of PASSES
template <int PASSES>
__device__ __forceinline__ void mma_passes(float* c, const uint32_t* a, const uint32_t* b) {
#pragma unroll
    for (int u = 0; u < PASSES; ++u)
        mma_tf32(c, a + 4 * tc_piece_a(PASSES, u), b + 2 * tc_piece_b(PASSES, u));
}

// ---------------------------------------------------------------------------
// cp.async staging, 4-byte copies zero-filled where `live` is false
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool live) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(live ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
