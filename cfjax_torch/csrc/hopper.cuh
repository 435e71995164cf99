// Hopper (sm_90a) building blocks shared by K2 (expand_mvm.cu) and K3
// (grad_mvm.cu): shared-memory addresses, mbarriers, the TMA's 1-D bulk
// copies, named barriers, and wgmma.m64n64k8 tf32 with both operands in
// shared memory in the 128-byte swizzled K-major layout (rows of 32 floats
// of depth, a "K-block", 8-row groups 1024 bytes apart).
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers, the async-proxy fence, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}
// wait for the completion of the barrier's phase of `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "MBAR_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra MBAR_WAIT;\n}\n" ::"r"(smem_addr(b)),
        "r"(parity)
        : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators may change here: no read of them moves across
template <int N>
__device__ __forceinline__ void acc_fence(float (&c)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(c[i])::"memory");
}

// a K-major operand in the 128-byte swizzled layout: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO), the leading offset unused (1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
           ((uint64_t)1 << 62);
}

// c (+)= A B for a 64 x 64 x 8 tf32 tile, A and B from shared memory;
// `acc` 0 overwrites c. Fragments of c, thread 32 w + 4 g + t of the
// warpgroup: c[4 i + e] at row 16 w + g (+ 8 for e >= 2), column 8 i + 2 t
// (+ 1 for odd e).
__device__ __forceinline__ void wgmma_tf32(float (&c)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]),
          "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]),
          "+f"(c[13]), "+f"(c[14]), "+f"(c[15]), "+f"(c[16]), "+f"(c[17]), "+f"(c[18]),
          "+f"(c[19]), "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]), "+f"(c[24]),
          "+f"(c[25]), "+f"(c[26]), "+f"(c[27]), "+f"(c[28]), "+f"(c[29]), "+f"(c[30]),
          "+f"(c[31])
        : "l"(da), "l"(db), "r"(acc));
}

// one bulk copy (the TMA's 1-D form) of `bytes` from global to shared
// memory, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}
// the producer's arrival, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
                 "r"(bytes)
                 : "memory");
}

// a ring position (stage, phase parity) k items on (no division on the
// consumers' path: the stages are not a constant)
__device__ __forceinline__ void ring_next(int& s, int& ph, int stages) {
    if (++s == stages) {
        s = 0;
        ph ^= 1;
    }
}
__device__ __forceinline__ void ring_skip(int& s, int& ph, int k, int stages) {
    for (s += k; s >= stages; s -= stages) ph ^= 1;
}

// named barriers between warpgroups (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
