// K4: the sparse operator MVM for NVIDIA Hopper (sm_90a), over the
// operator's row slices. Plain C interface, loaded with ctypes by
// cfjax_torch/ops/tile_ell_mvm.py, which also holds its plain torch
// version `rows_matvec_plain`.
//
// Replaces cfjax/operators/tile_ell.py `_slab_matvec_pallas`, the TileELL
// slab MVM. The TPU kernel reads slabs that are dense over column tiles,
// because a TPU gathers only within 128 lanes; on this card a gather from
// a vector of a few hundred KB goes through L1 and L2, and the slabs'
// padding (13.6 to 30 slots per nonzero on the port's sparse paths) is
// what costs. So the operator keeps a second layout, built once from its
// groups (operators/tile_ell.py `row_slices`):
//   the rows in count-sorted order, cut into slices of 32; slice s holds
//   width_s = (ptr[s + 1] - ptr[s]) / 32 slots per row, its longest row's
//   count, stored slot-major: entry j of lane l at ptr[s] + 32 j + l, an
//   int32 column `col` and a value `val` (0 in a pad slot, whose column
//   is 0); row 32 s + l of the layout is output row out_row[32 s + l].
// Rows sorted by count make a slice's padding small, so one MVM reads
// about nnz * (4 + sizeof(T)) bytes of layout.
//
// Mapping. A block owns one slice: lane l of each warp walks row 32 s + l,
// so every col / val load of a warp is 32 consecutive entries (coalesced,
// streaming: read once, kept out of the caches). With `warps` > 1 the
// block's warps split the slice's slots into contiguous ranges and add
// their sums through shared memory in warp order. Each thread writes its
// row's result to out[out_row[row]] itself: one launch per MVM, no partial
// rows, no second pass, no atomics, so results repeat bit for bit.
//
// The gather of a goes through the read-only data cache (__ldg): `a` is
// 128 KB at m = 32768 in float32 and every block reads from it; with the
// rows in a spatial (Hilbert) order a row's columns lie close together.
//
// Bound on this card: device-memory bandwidth, nnz * (4 + sizeof(T))
// bytes of col and val plus a and out.

#include <cuda_runtime.h>

constexpr int K4_UNROLL = 4;
constexpr int K4_MAX_WARPS = 8;

__device__ __forceinline__ float k4_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double k4_fma(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(32 * K4_MAX_WARPS)
k4_rows(const T* __restrict__ a, const int* __restrict__ col, const T* __restrict__ val,
        const long long* __restrict__ ptr, const int* __restrict__ out_row, T* __restrict__ out,
        int n_rows) {
    __shared__ T part[K4_MAX_WARPS][32];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int s = blockIdx.x;
    const long long p0 = ptr[s];
    const int width = (int)((ptr[s + 1] - p0) >> 5);
    const int per = (width + warps - 1) / warps;
    const int j0 = min(width, w * per);
    const int j1 = min(width, j0 + per);
    const int* c = col + p0 + lane;
    const T* v = val + p0 + lane;
    T acc = T(0);
    int j = j0;
    for (; j + K4_UNROLL <= j1; j += K4_UNROLL) {
        int cc[K4_UNROLL];
        T vv[K4_UNROLL];
#pragma unroll
        for (int u = 0; u < K4_UNROLL; ++u) {
            cc[u] = __ldcs(c + (size_t)(j + u) * 32);
            vv[u] = __ldcs(v + (size_t)(j + u) * 32);
        }
#pragma unroll
        for (int u = 0; u < K4_UNROLL; ++u) acc = k4_fma(vv[u], __ldg(a + cc[u]), acc);
    }
    for (; j < j1; ++j)
        acc = k4_fma(__ldcs(v + (size_t)j * 32), __ldg(a + __ldcs(c + (size_t)j * 32)), acc);

    const int row = s * 32 + lane;
    if (warps == 1) {
        if (row < n_rows) out[out_row[row]] = acc;
        return;
    }
    part[w][lane] = acc;
    __syncthreads();
    if (w == 0 && row < n_rows) {
        T sum = part[0][lane];
        for (int q = 1; q < warps; ++q) sum += part[q][lane];
        out[out_row[row]] = sum;
    }
}

template <typename T>
static int k4_launch(const T* a, const int* col, const T* val, const long long* ptr,
                     const int* out_row, T* out, int n_rows, int n_slices, int warps,
                     void* stream) {
    if (warps < 1 || warps > K4_MAX_WARPS) return (int)cudaErrorInvalidValue;
    if (n_slices == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    k4_rows<T><<<n_slices, 32 * warps, 0, st>>>(a, col, val, ptr, out_row, out, n_rows);
    return (int)cudaGetLastError();
}

extern "C" int k4_rows_matvec_f32(const float* a, const int* col, const float* val,
                                  const long long* ptr, const int* out_row, float* out,
                                  int n_rows, int n_slices, int warps, void* stream) {
    return k4_launch<float>(a, col, val, ptr, out_row, out, n_rows, n_slices, warps, stream);
}

extern "C" int k4_rows_matvec_f64(const double* a, const int* col, const double* val,
                                  const long long* ptr, const int* out_row, double* out,
                                  int n_rows, int n_slices, int warps, void* stream) {
    return k4_launch<double>(a, col, val, ptr, out_row, out, n_rows, n_slices, warps, stream);
}
