// A float64 reference for K1 on the card: b = K a for the EQ kernel under
// a lengthscale, K_ij = exp(-c |x_i - y_j|^2), every operation in float64
// (the difference-form distance, exp, the row sum). Plain C interface,
// loaded with ctypes by cfjax_torch/benchmarks/config5_probe.py, whose
// `eq_matvec_f64` holds its plain torch version.
//
// It replaces no TPU kernel and runs on no path of the package: it is
// K1's float64 plain version made fast enough to run a whole PCG solve at
// n = 10^6 (the plain torch version writes each (rows, n) tile to device
// memory several times, ~60 bytes an entry, ~20 s a product there). One
// thread a row, the columns staged through shared memory in tiles; its
// cost is the float64 exp, ~35 float64 instructions an entry.

#include <cuda_runtime.h>

constexpr int RF_THREADS = 256;
constexpr int RF_TN = 256;
constexpr int RF_MAX_D = 4;

__global__ void __launch_bounds__(RF_THREADS)
eq_f64(const double* __restrict__ x, const double* __restrict__ y, const double* __restrict__ a,
       double* __restrict__ out, int n, int m, int d, double c) {
    __shared__ double ys[RF_TN][RF_MAX_D];
    __shared__ double as[RF_TN];
    const int i = blockIdx.x * RF_THREADS + threadIdx.x;
    double xi[RF_MAX_D];
#pragma unroll
    for (int k = 0; k < RF_MAX_D; ++k) xi[k] = (i < n && k < d) ? x[(size_t)i * d + k] : 0.0;
    double acc = 0.0;
    for (int j0 = 0; j0 < m; j0 += RF_TN) {
        const int cnt = min(RF_TN, m - j0);
        __syncthreads();   // the previous tile is consumed
        for (int t = threadIdx.x; t < RF_TN; t += RF_THREADS) {
            as[t] = t < cnt ? a[j0 + t] : 0.0;
#pragma unroll
            for (int k = 0; k < RF_MAX_D; ++k)
                ys[t][k] = (t < cnt && k < d) ? y[(size_t)(j0 + t) * d + k] : 0.0;
        }
        __syncthreads();
        for (int t = 0; t < cnt; ++t) {
            double s = 0.0;
#pragma unroll
            for (int k = 0; k < RF_MAX_D; ++k) {
                const double u = xi[k] - ys[t][k];
                s = fma(u, u, s);
            }
            acc = fma(exp(-c * s), as[t], acc);
        }
    }
    if (i < n) out[i] = acc;
}

extern "C" int eq_matvec_f64(const double* x, const double* y, const double* a, double* out,
                             int n, int m, int d, double c, void* stream) {
    if (d < 1 || d > RF_MAX_D) return (int)cudaErrorInvalidValue;
    eq_f64<<<(n + RF_THREADS - 1) / RF_THREADS, RF_THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(x, y, a, out, n, m, d, c);
    return (int)cudaGetLastError();
}
