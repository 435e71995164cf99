// K4: the TileELL slab MVM for NVIDIA Hopper (sm_90a). Plain C interface,
// loaded with ctypes by cfjax_torch/ops/tile_ell_mvm.py, which also holds
// its plain torch version `slab_matvec_plain`.
//
// Replaces cfjax/operators/tile_ell.py `_slab_matvec_pallas`. For one
// group of a TileELL operator, with a2 = pad(a).reshape(nt, 128) and
// off (int32), val of shape (B, K, nt, 128), it computes
//   out[b, l] = sum_k sum_t val[b, k, t, l] * a2[t, off[b, k, t, l]],
// where lane l of row block b is one output row of the count-sorted order.
// Pad slots carry off 0 and val 0; a2 is zero past m.
//
// Mapping. Thread <-> lane: a warp reads 32 consecutive lanes of one
// (b, k, t) slot row, so every off and val load is coalesced. The (k, t)
// range of a row block, j = k * nt + t in storage order, is cut into
// `splits` chunks over gridDim.y, so that about eight blocks of 128
// threads per SM are in flight even when a group has few row blocks (16
// in some groups of the d = 32 configuration, against 132 SMs). A thread
// walks its chunk in storage order and accumulates in T, four slots per
// step: the four off/val pairs are loaded before their four gathers, so
// each thread keeps several independent loads in flight. Each chunk writes
// its own partial row; a second kernel adds the chunks' partial rows in
// chunk order. No atomics: results repeat bit for bit.
//
// The gather of a. a2 is read through the read-only data cache (__ldg):
// it is 128 KB at nt = 256 in float32, and every block of a group reads
// all of it, so it stays in L1/L2 and costs no device-memory traffic
// beyond its first touch. An off entry is taken modulo 128 (the format's
// range), so no index can leave a2.
//
// Bound on this card: device-memory bandwidth. Each slot costs 4 bytes
// of off and sizeof(T) of val, read once, for one FMA; the slabs are dense
// over column tiles, so most slots are padding (30 slots per nonzero on
// the reference's d = 32 configuration, 14 on a 2-d spatial one at
// nt = 256). Redesigning the format for Hopper is later work; this kernel
// keeps cfjax's layout so that its packed arrays compare element for
// element with cfjax's.

#include <cuda_runtime.h>

constexpr int K4_LANES = 128;
constexpr int K4_UNROLL = 4;

__device__ __forceinline__ float k4_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double k4_fma(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(K4_LANES)
k4_slab(const T* __restrict__ a2, const int* __restrict__ off, const T* __restrict__ val,
        T* __restrict__ partial, int B, int K, int nt, int per) {
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    const long long kt = (long long)K * nt;
    const long long j0 = (long long)blockIdx.y * per;
    const long long j1 = j0 + per < kt ? j0 + per : kt;
    const size_t base = (size_t)b * kt * K4_LANES + lane;
    int t = (int)(j0 % nt);
    T acc = T(0);
    long long j = j0;
    for (; j + K4_UNROLL <= j1; j += K4_UNROLL) {
        int o[K4_UNROLL];
        T v[K4_UNROLL];
#pragma unroll
        for (int u = 0; u < K4_UNROLL; ++u) {
            const size_t s = base + (size_t)(j + u) * K4_LANES;
            o[u] = __ldg(off + s);
            v[u] = __ldg(val + s);
        }
#pragma unroll
        for (int u = 0; u < K4_UNROLL; ++u) {
            const T g = __ldg(a2 + (size_t)t * K4_LANES + (o[u] & (K4_LANES - 1)));
            acc = k4_fma(v[u], g, acc);
            if (++t == nt) t = 0;
        }
    }
    for (; j < j1; ++j) {
        const size_t s = base + (size_t)j * K4_LANES;
        const T g = __ldg(a2 + (size_t)t * K4_LANES + (__ldg(off + s) & (K4_LANES - 1)));
        acc = k4_fma(__ldg(val + s), g, acc);
        if (++t == nt) t = 0;
    }
    partial[((size_t)blockIdx.y * B + b) * K4_LANES + lane] = acc;
}

// out[e] = sum over chunks of partial[s, e], in chunk order
template <typename T>
__global__ void k4_reduce(const T* __restrict__ partial, T* __restrict__ out, long long total,
                          int splits) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    T sum = T(0);
    for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * total + e];
    out[e] = sum;
}

template <typename T>
static int k4_launch(const T* a2, const int* off, const T* val, T* partial, T* out, int B,
                     int K, int nt, int splits, int per, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid(B, splits);
    k4_slab<T><<<grid, K4_LANES, 0, st>>>(a2, off, val, splits == 1 ? out : partial, B, K, nt,
                                          per);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (splits > 1) {
        const long long total = (long long)B * K4_LANES;
        k4_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(partial, out, total,
                                                                      splits);
    }
    return (int)cudaGetLastError();
}

extern "C" int k4_slab_matvec_f32(const float* a2, const int* off, const float* val,
                                  float* partial, float* out, int B, int K, int nt, int splits,
                                  int per, void* stream) {
    return k4_launch<float>(a2, off, val, partial, out, B, K, nt, splits, per, stream);
}

extern "C" int k4_slab_matvec_f64(const double* a2, const int* off, const double* val,
                                  double* partial, double* out, int B, int K, int nt,
                                  int splits, int per, void* stream) {
    return k4_launch<double>(a2, off, val, partial, out, B, K, nt, splits, per, stream);
}
