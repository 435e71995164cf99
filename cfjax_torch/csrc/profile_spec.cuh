// The profile-program interpreters shared by the kernels of
// gramian_mvm.cu (K1, K2) and grad_mvm.cu (K3). A kernel's profile
// reaches the kernels as a ProfileSpec (cfjax_torch/kernels/profile_spec.py):
// a postfix program of opcodes, one integer argument each, and a table of
// float constants, passed by value and copied to shared memory. Every
// thread runs the same program, so warps do not diverge on it.
//
//   eval_profile<V>: the value f(s) of a value spec (compiled from
//                    `profile_value`), V entries per decode;
//   eval_jet<V>:     the second-order jet (f, f', f'') of a derivative
//                    spec (compiled from `profile`, ProfileSpec.jet), V
//                    entries per decode, three floats per stack slot;
//   family_value<FAM, P>: the value of a one-leaf spec's family form
//                    (ProfileSpec.family), with its folded constants, in
//                    registers: no stack, no opcode reads.
#pragma once

#include <cuda_runtime.h>

#define OP_PUSH_S 0
#define OP_PUSH_C 1
#define OP_ADD 2
#define OP_MUL 3
#define OP_DIV 4
#define OP_NEG 5
#define OP_EXP 6
#define OP_SQRT 7
#define OP_ROOT 8
#define OP_POWC 9
#define OP_POWI 10
#define OP_MATERNP 11
#define OP_MATERNP_JET 12

#define MAX_OPS 64
#define MAX_CONSTS 64
#define MAX_STACK 8

struct ProfileSpec {
    int n_ops;
    int op[MAX_OPS];
    int arg[MAX_OPS];
    float c[MAX_CONSTS];
};

// Families of one-leaf value specs (kernels/profile_spec.py FAMILY_*), and
// their folded constants: c[0..] as the Python side documents them, and
// the Constant factor, which multiplies the row sum.
#define FAM_EQ 1
#define FAM_MATERN 2
#define FAM_RQ 3
#define FAM_CAUCHY 4
#define FAM_IMQ 5
#define FAM_CONSTS 6

struct FamilyConsts {
    float c[FAM_CONSTS];
    float scale;
};

// the value-path sqrt: s * rsqrt(max(s, 1e-18)), as profile_value computes it
__device__ __forceinline__ float root_value(float s) {
    const float sc = fmaxf(s, 1e-18f);
    return sc * rsqrtf(sc);
}

__device__ __forceinline__ float ipow(float x, int p) {
    unsigned int e = p < 0 ? -p : p;
    float r = 1.f, b = x;
    while (e) {
        if (e & 1u) r *= b;
        b *= b;
        e >>= 1;
    }
    return p < 0 ? 1.f / r : r;
}

// Evaluate the profile program on V arguments at once (one decode per V
// entries). s holds the arguments on entry and the profile values on exit.
template <int V>
__device__ __forceinline__ void eval_profile(const ProfileSpec& sp, float (&s)[V]) {
    float st[MAX_STACK][V];
    int top = 0;
    for (int i = 0; i < sp.n_ops; ++i) {
        const int a = sp.arg[i];
        switch (sp.op[i]) {
        case OP_PUSH_S:
#pragma unroll
            for (int v = 0; v < V; ++v) st[top][v] = s[v];
            ++top;
            break;
        case OP_PUSH_C: {
            const float c = sp.c[a];
#pragma unroll
            for (int v = 0; v < V; ++v) st[top][v] = c;
            ++top;
            break;
        }
        case OP_ADD:
            --top;
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = st[top - 1][v] + st[top][v];
            break;
        case OP_MUL:
            --top;
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = st[top - 1][v] * st[top][v];
            break;
        case OP_DIV:
            --top;
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = st[top - 1][v] / st[top][v];
            break;
        case OP_NEG:
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = -st[top - 1][v];
            break;
        case OP_EXP:
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = expf(st[top - 1][v]);
            break;
        case OP_SQRT:
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = sqrtf(st[top - 1][v]);
            break;
        case OP_ROOT:
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = root_value(st[top - 1][v]);
            break;
        case OP_POWC: {
            const float c = sp.c[a];
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = powf(st[top - 1][v], c);
            break;
        }
        case OP_POWI:
#pragma unroll
            for (int v = 0; v < V; ++v) st[top - 1][v] = ipow(st[top - 1][v], a);
            break;
        case OP_MATERNP: {
            const int p = (int)sp.c[a];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float r = root_value(st[top - 1][v]);
                const float u = 2.f * r;
                float val = sp.c[a + 1 + p];
                for (int j = p - 1; j >= 0; --j) val = val * u + sp.c[a + 1 + j];
                st[top - 1][v] = val * expf(-r);
            }
            break;
        }
        default:
            break;
        }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = st[0][v];
}

// The SFU's approximate functions, flushing subnormals (a profile value
// below 2^-126 adds nothing to a float32 row sum). Relative error about
// 2^-22 each (PTX ISA); each is one MUFU instruction.
__device__ __forceinline__ float ex2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float rsqrt_approx(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// exp2(u (c0 + c1)), c0 the float nearest the constant and c1 the rest.
// Rounding u c0 to a float, and c0 itself, would shift the argument by up
// to |u c| 2^-23: a relative error of 4e-7 at |u c| = 8, the same sign for
// every entry (a slightly wrong lengthscale). The product's rounding error
// (an FMA) and u c1 enter a first-order correction instead: 4 fp32
// instructions for an argument exact to a float's rounding.
__device__ __forceinline__ float ex2_split(float u, float c0, float c1) {
    const float t = u * c0;
    const float lo = fmaf(u, c1, fmaf(u, c0, -t));
    const float e = ex2_approx(t);
    return fmaf(e, lo * 0.693147180559945f, e);
}

// The family form of a one-leaf spec at s (ProfileSpec.evaluate(s,
// family=True)), without the Constant factor. MaternP(p) with p = P
// (Exp is P = 0): r = root(s), exp2(r (c0 + c1)) sum_j c[2 + j] r^j.
template <int FAM, int P>
__device__ __forceinline__ float family_value(float s, const FamilyConsts& f) {
    if constexpr (FAM == FAM_EQ) {
        return ex2_split(s, f.c[0], f.c[1]);
    } else if constexpr (FAM == FAM_MATERN) {
        const float sc = fmaxf(s, 1e-18f);
        const float r = sc * rsqrt_approx(sc);
        const float e = ex2_split(r, f.c[0], f.c[1]);
        if constexpr (P == 0) {
            return e;
        } else {
            float poly = f.c[2 + P];
#pragma unroll
            for (int j = P - 1; j >= 0; --j) poly = fmaf(poly, r, f.c[2 + j]);
            return poly * e;
        }
    } else if constexpr (FAM == FAM_RQ) {
        return ex2_approx(f.c[1] * lg2_approx(fmaf(s, f.c[0], 1.f)));
    } else if constexpr (FAM == FAM_CAUCHY) {
        return rcp_approx(fmaf(s, f.c[0], 1.f));
    } else {
        static_assert(FAM == FAM_IMQ, "unknown profile family");
        return rsqrt_approx(fmaf(s, f.c[0], f.c[1]));
    }
}

// Horner sum_j c[j] x^j over n coefficients (n >= 1)
__device__ __forceinline__ float horner(const float* c, int n, float x) {
    float v = c[n - 1];
    for (int j = n - 2; j >= 0; --j) v = v * x + c[j];
    return v;
}

// (g, g', g'') of MaternP(p).profile at s, from the MATERNP_JET table at
// t = &consts[arg + 1] (profile_spec.py `_maternp_jet_table`): tau[p],
// q[p+1], r1[p], s2[p]. Below the Taylor bound eps^(1/p) the polynomial
// 1 + sum tau_i s^i and its derivatives, above it the closed forms
// f = e Q(rho), f' = (c/2) e R1(rho), f'' = (c/2)^2 e S2(rho) / rho, with
// rho = sqrt(c s), e = exp(-rho), c = 2p + 1. The bound is computed in
// float32 (eps = 2^-23), as MaternP.profile computes it in float32.
__device__ __forceinline__ void maternp_jet(const float* t, int p, float s, float& g0,
                                            float& g1, float& g2) {
    const float bound = exp2f(-23.f / (float)p);
    if (s < bound) {
        float v0 = t[p - 1], v1 = p * t[p - 1], v2 = p * (p - 1) * t[p - 1];
        for (int i = p - 1; i >= 1; --i) {
            v0 = v0 * s + t[i - 1];
            v1 = v1 * s + i * t[i - 1];
            if (i >= 2) v2 = v2 * s + i * (i - 1) * t[i - 1];
        }
        g0 = 1.f + v0 * s;
        g1 = v1;
        g2 = p >= 2 ? v2 : 0.f;
    } else {
        const float c = 2.f * p + 1.f;
        const float rho = sqrtf(c * s);
        const float e = expf(-rho);
        const float h = 0.5f * c;
        g0 = e * horner(t + p, p + 1, rho);
        g1 = h * e * horner(t + 2 * p + 1, p, rho);
        g2 = h * h * e * horner(t + 3 * p + 1, p, rho) / rho;
    }
}

// (g', g'') of MaternP(P).profile at s: maternp_jet with p = P known when
// compiled, so every table index is a constant (no local memory)
template <int P>
__device__ __forceinline__ void maternp_jet_fixed(const float* t, float s, float& g1,
                                                  float& g2) {
    const float bound = exp2f(-23.f / (float)P);
    if (s < bound) {
        float v1 = P * t[P - 1], v2 = P * (P - 1) * t[P - 1];
#pragma unroll
        for (int i = P - 1; i >= 1; --i) {
            v1 = v1 * s + i * t[i - 1];
            if (i >= 2) v2 = v2 * s + i * (i - 1) * t[i - 1];
        }
        g1 = v1;
        g2 = P >= 2 ? v2 : 0.f;
    } else {
        const float c = 2.f * P + 1.f;
        const float rho = sqrtf(c * s);
        const float e = expf(-rho);
        const float h = 0.5f * c;
        float r1 = t[3 * P], s2 = t[4 * P];
#pragma unroll
        for (int j = P - 2; j >= 0; --j) {
            r1 = r1 * rho + t[2 * P + 1 + j];
            s2 = s2 * rho + t[3 * P + 1 + j];
        }
        g1 = h * e * r1;
        g2 = h * h * e * s2 / rho;
    }
}

// Families of one-leaf derivative specs (ProfileSpec.family of
// to_spec(k, derivative=True)): f'(s) and f''(s) in registers, the
// lengthscales and the Constant folded into the table (kernels/
// profile_spec.py `_jet_family` documents each layout).
#define JET_CONSTS 16

struct JetConsts {
    float c[JET_CONSTS];
};

template <int FAM, int P>
__device__ __forceinline__ void family_jet(float s, const JetConsts& j, float& f1, float& f2) {
    const float* c = j.c;
    if constexpr (FAM == FAM_EQ) {
        // f = scale exp2(s (c0 + c1)); f' = c2 e, f'' = c3 e
        const float e = ex2_split(s, c[0], c[1]);
        f1 = c[2] * e;
        f2 = c[3] * e;
    } else if constexpr (FAM == FAM_MATERN) {
        // u = sigma s; f' = scale sigma g'(u), f'' = scale sigma^2 g''(u)
        static_assert(P >= 1 && P <= 3, "MaternP's derivative family takes p = 1, 2, 3");
        float g1, g2;
        maternp_jet_fixed<P>(c + 3, c[0] * s, g1, g2);
        f1 = c[1] * g1;
        f2 = c[2] * g2;
    } else if constexpr (FAM == FAM_RQ) {
        // b = 1 + c0 s, f = scale b^c1; f' = c2 b^c1 / b, f'' = c3 b^c1 / b^2
        const float b = fmaf(s, c[0], 1.f);
        const float r = 1.f / b;
        const float pw = exp2f(c[1] * log2f(b)) * r;
        f1 = c[2] * pw;
        f2 = c[3] * pw * r;
    } else if constexpr (FAM == FAM_CAUCHY) {
        // r = 1 / (1 + c0 s); f' = c1 r^2, f'' = c2 r^3
        const float r = 1.f / fmaf(s, c[0], 1.f);
        const float r2 = r * r;
        f1 = c[1] * r2;
        f2 = c[2] * r2 * r;
    } else {
        static_assert(FAM == FAM_IMQ, "unknown derivative family");
        // r = (c0 s + c1)^(-1/2); f' = c2 r^3, f'' = c3 r^5
        const float r = rsqrtf(fmaf(s, c[0], c[1]));
        const float r3 = r * r * r;
        f1 = c[2] * r3;
        f2 = c[3] * r3 * r * r;
    }
}

// jet of g(u) from the jet of u and g's derivatives at u
__device__ __forceinline__ void chain(float (&u)[3], float g0, float g1, float g2) {
    u[2] = g2 * u[1] * u[1] + g1 * u[2];
    u[1] = g1 * u[1];
    u[0] = g0;
}

// Second-order jet of a derivative spec on V arguments at once: s holds
// the arguments on entry; f1, f2 receive f'(s), f''(s). The value-path
// opcodes (ROOT, MATERNP) never occur in a derivative spec: the wrapper
// refuses a value spec. The stack holds (f, f', f'') per slot.
template <int V>
__device__ __forceinline__ void eval_jet(const ProfileSpec& sp, const float (&s)[V],
                                         float (&f1)[V], float (&f2)[V]) {
    float st[MAX_STACK][V][3];
    int top = 0;
    for (int i = 0; i < sp.n_ops; ++i) {
        const int a = sp.arg[i];
        switch (sp.op[i]) {
        case OP_PUSH_S:
#pragma unroll
            for (int v = 0; v < V; ++v) {
                st[top][v][0] = s[v];
                st[top][v][1] = 1.f;
                st[top][v][2] = 0.f;
            }
            ++top;
            break;
        case OP_PUSH_C: {
            const float c = sp.c[a];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                st[top][v][0] = c;
                st[top][v][1] = 0.f;
                st[top][v][2] = 0.f;
            }
            ++top;
            break;
        }
        case OP_ADD:
            --top;
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
                for (int o = 0; o < 3; ++o) st[top - 1][v][o] += st[top][v][o];
            break;
        case OP_MUL:
            --top;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                float* u = st[top - 1][v];
                const float* w = st[top][v];
                const float p0 = u[0] * w[0];
                const float p1 = u[1] * w[0] + u[0] * w[1];
                const float p2 = u[2] * w[0] + 2.f * u[1] * w[1] + u[0] * w[2];
                u[0] = p0;
                u[1] = p1;
                u[2] = p2;
            }
            break;
        case OP_DIV:
            --top;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                float* u = st[top - 1][v];
                const float* w = st[top][v];
                const float q0 = u[0] / w[0];
                const float q1 = (u[1] - q0 * w[1]) / w[0];
                const float q2 = (u[2] - 2.f * q1 * w[1] - q0 * w[2]) / w[0];
                u[0] = q0;
                u[1] = q1;
                u[2] = q2;
            }
            break;
        case OP_NEG:
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
                for (int o = 0; o < 3; ++o) st[top - 1][v][o] = -st[top - 1][v][o];
            break;
        case OP_EXP:
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float e = expf(st[top - 1][v][0]);
                chain(st[top - 1][v], e, e, e);
            }
            break;
        case OP_SQRT:
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float u0 = st[top - 1][v][0];
                const float r = sqrtf(u0);
                chain(st[top - 1][v], r, 0.5f / r, -0.25f / (r * u0));
            }
            break;
        case OP_POWC: {
            const float c = sp.c[a];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                // the base is positive in every derivative spec (RQ: 1 + s / 2a)
                const float u0 = st[top - 1][v][0];
                const float pc = powf(u0, c);
                const float pc1 = pc / u0;
                chain(st[top - 1][v], pc, c * pc1, c * (c - 1.f) * pc1 / u0);
            }
            break;
        }
        case OP_POWI:
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const float u0 = st[top - 1][v][0];
                const float g1 = a == 0 ? 0.f : a * ipow(u0, a - 1);
                const float g2 = (a == 0 || a == 1) ? 0.f : a * (a - 1) * ipow(u0, a - 2);
                chain(st[top - 1][v], ipow(u0, a), g1, g2);
            }
            break;
        case OP_MATERNP_JET: {
            const int p = (int)sp.c[a];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                float g0, g1, g2;
                maternp_jet(&sp.c[a + 1], p, st[top - 1][v][0], g0, g1, g2);
                chain(st[top - 1][v], g0, g1, g2);
            }
            break;
        }
        default:
            break;
        }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
        f1[v] = st[0][v][1];
        f2[v] = st[0][v][2];
    }
}

// Compensated (Kahan) accumulation of a long sum in one thread.
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
    const float y = v - comp;
    const float t = sum + y;
    comp = (t - sum) - y;
    sum = t;
}

__device__ __forceinline__ void load_spec(ProfileSpec& dst, const ProfileSpec& src) {
    const int* s = reinterpret_cast<const int*>(&src);
    int* d = reinterpret_cast<int*>(&dst);
    for (int t = threadIdx.x; t < (int)(sizeof(ProfileSpec) / sizeof(int)); t += blockDim.x) d[t] = s[t];
}
