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
//                    registers: no stack, no opcode reads (the real-nu
//                    Matern family reads its table, `matern_nu_tabled`);
//   family_jet<FAM, P>: f' and f'' of a one-leaf derivative spec's family
//                    (the real-nu Matern's from two tables,
//                    `matern_nu_jet_tabled`);
//   matern_nu<JET>:  Matern(nu).profile at real nu (and its jet), the
//                    MATERN_NU / MATERN_NU_JET opcodes, with x^nu K_nu(x)
//                    computed here by Temme's series, Steed's continued
//                    fraction and the order recurrence: no library Bessel.
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
#define OP_MATERN_NU 13
#define OP_MATERN_NU_JET 14

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
#define FAM_MATERN_NU 6
#define FAM_CONSTS 9
// intervals of the real-nu Matern family's table (utils/besselk.py
// MATERN_KNOTS: 32 octaves of 32), and of each of its jet family's two
// tables (MATERN_JET_KNOTS: 40 octaves of 32)
#define MATERN_KNOTS 1024
#define MATERN_JET_KNOTS 1280

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

// ---------------------------------------------------------------------------
// Real-nu Matern: f(s) = c x^nu K_nu(x), x = sqrt(2 nu s), c = 2^(1-nu) /
// Gamma(nu), and its jet f' = -c nu x^(nu-1) K_(nu-1)(x), f'' = c nu^2
// x^(nu-2) K_|nu-2|(x). cfjax's Pallas kernels run this profile as a jnp
// closure, a 400-node exp-sinh quadrature in log space (cfjax/utils/
// besselk.py) per entry; here K is evaluated as Numerical Recipes' `bessik`
// does (Temme 1975; Steed's CF2), in float32: about 15 terms either side of
// x = 2 against 400 nodes of exp and log, and accurate at small x, where the
// quadrature is not (cfjax_torch/utils/besselk.py). The constants t[] come
// from `matern_nu_table` (cfjax_torch/utils/besselk.py), which documents
// each index; matern_nu_reference there is this code in float64.
// ---------------------------------------------------------------------------

#define KV_EPS 1.0e-7f
#define KV_MAX_TERMS 64

// (A, B) = (x^l K_l(x), x^(l+1) K_(l+1)(x)) for |l| <= 1/2, each times
// 1 / tail: tail = exp(-x / 2) above x = 2 (the rest of exp(-x) is in A and
// B; the caller multiplies by tail last, so that x up to ~170 stays in
// range), 1 below.
__device__ __forceinline__ void kv_pair(const float* t, float x, float& A, float& B,
                                        float& tail) {
    const float l = t[7];
    if (x <= 2.f) {
        // Temme's series: K_l = sum c_k f_k, K_(l+1) = (2 / x) sum c_k (p_k - k f_k)
        const float x2 = 0.5f * x;
        const float d = -logf(x2);
        const float e = l * d;
        const float fact2 = fabsf(e) < 1e-3f ? fmaf(e * e, 1.f / 6.f, 1.f) : sinhf(e) / e;
        float ff = t[14] * (t[10] * coshf(e) + t[11] * fact2 * d);
        float sum = ff;
        const float ee = expf(e);               // (x/2)^-l
        float p = 0.5f * ee / t[12];            // (x/2)^-l Gamma(1+l) / 2
        float q = 0.5f / (ee * t[13]);          // (x/2)^l Gamma(1-l) / 2
        float c = 1.f, sum1 = p;
        const float dd = x2 * x2;
        for (int i = 1; i < KV_MAX_TERMS; ++i) {
            const float fi = (float)i;
            ff = (fi * ff + p + q) / (fi * fi - l * l);
            c *= dd / fi;
            p /= fi - l;
            q /= fi + l;
            const float del = c * ff;
            sum += del;
            sum1 += c * (p - fi * ff);
            if (fabsf(del) < fabsf(sum) * KV_EPS) break;
        }
        const float xl = exp2f(l) / ee;         // x^l
        A = xl * sum;
        B = 2.f * xl * sum1;
        tail = 1.f;
    } else {
        // Steed's CF2 for K_l and the ratio K_(l+1) / K_l
        float b = 2.f * (1.f + x), dd = 1.f / b, h = dd, delh = dd;
        float q1 = 0.f, q2 = 1.f;
        const float a1 = 0.25f - l * l;
        float q = a1, c = a1, a = -a1, sum = fmaf(a1, delh, 1.f);
        for (int i = 1; i < KV_MAX_TERMS; ++i) {
            const float fi = (float)i;
            a -= 2.f * fi;
            c = -a * c / (fi + 1.f);
            const float qn = (q1 - b * q2) / a;
            q1 = q2;
            q2 = qn;
            q += c * qn;
            b += 2.f;
            dd = 1.f / (b + a * dd);
            delh = (b * dd - 1.f) * delh;
            h += delh;
            const float dels = q * delh;
            sum += dels;
            if (fabsf(dels) < fabsf(sum) * KV_EPS) break;
        }
        h *= a1;
        tail = expf(-0.5f * x);
        // sqrt(pi / 2) x^(l - 1/2) exp(-x / 2) / sum
        A = 1.2533141373155003f * exp2f((l - 0.5f) * log2f(x)) * tail / sum;
        B = A * (l + x + 0.5f - h);
    }
}

// f (and with JET f', f'') of Matern(nu).profile at s. Below the guard's
// bound t[6] (and at s = 0, the limit 1 for every nu) the Taylor
// polynomial 1 + t1 s + t2 s^2, as Matern.profile; above it the closed
// forms, from the scaled values g_k = x^(mu+k) K_(mu+k)(x) run up from
// (g_0, g_1) = kv_pair by g_(k+1) = x^2 g_(k-1) + 2 (mu + k) g_k: every
// term positive, so no cancellation. g grows like 2^(nu-1) Gamma(nu) as
// x -> 0, past float32 near nu = 28: the three carried values are scaled
// by 2^-64 whenever the top one passes 2^64, and the count joins c's
// exponent t[3] in one ldexpf at the end. x = sqrt(s) sqrt(2 nu) is
// rounded three times (the root, the constant, the product), and exp(-x)
// turns that into a relative error of up to x 2^-23, 1e-5 at x = 100: its
// rounding error xlo (the root's residual, an FMA, and the constant's
// remainder t[15]) corrects each result to first order, by its
// logarithmic derivative in x.
template <bool JET>
__device__ __forceinline__ void matern_nu(const float* t, float s, float& f0, float& f1,
                                          float& f2) {
    if (s < t[6] || s <= 0.f) {
        f0 = fmaf(fmaf(t[5], s, t[4]), s, 1.f);
        f1 = fmaf(2.f * t[5], s, t[4]);
        f2 = 2.f * t[5];
        return;
    }
    const float sq = sqrtf(s);
    const float x = t[1] * sq;
    const float sqlo = fmaf(-sq, sq, s) / (2.f * sq);   // sqrtf's rounding error
    const float xlo = fmaf(t[1], sqlo, fmaf(sq, t[15], fmaf(sq, t[1], -x)));
    float A, B, tail;
    kv_pair(t, x, A, B, tail);
    const int n = (int)t[9];
    const float xx = x * x;
    float gm = 0.f, g0 = A, g1 = B;   // orders nu - 2, nu - 1, nu once run up
    int e = (int)t[3];
    if (JET && t[8] != 0.f) {
        // 1 < nu < 3/2: A = x^-mu K_mu, B = x^(1-mu) K_(1-mu), mu = -l
        const float mu = -t[7];
        const float x2m = exp2f(2.f * mu * log2f(x));
        gm = B * x2m / xx;
        g0 = A * x2m;
        g1 = fmaf(xx, gm, 2.f * mu * g0);
    } else {
        float al = t[7] + 1.f;
        for (int k = 1; k < n; ++k) {
            const float g2 = fmaf(xx, g0, 2.f * al * g1);
            gm = g0;
            g0 = g1;
            g1 = g2;
            al += 1.f;
            if (g1 > 18446744073709551616.f) {
                gm *= 5.42101086242752217e-20f;
                g0 *= 5.42101086242752217e-20f;
                g1 *= 5.42101086242752217e-20f;
                e += 64;
            }
        }
    }
    // d/dx x^a K_a(x) = -x x^(a-1) K_(a-1)(x), and (recurrence down)
    // x^(a-1) K_(a-1) = (g_(a+1) - 2 a g_a) / x^2
    const float ct = t[2] * tail;
    const float top = n == 0 ? g0 : g1;
    const float d0 = n == 0 ? -(B - 2.f * t[7] * A) / (x * A) : -x * g0 / g1;
    f0 = top > 0.f ? ldexpf(ct * top * fmaf(d0, xlo, 1.f), e) : 0.f;
    if (JET) {
        const float nu = t[0];
        const float d1 = -x * gm / g0;
        const float d2 = -(g0 - 2.f * (nu - 2.f) * gm) / (x * gm);
        f1 = gm > 0.f ? ldexpf(-nu * ct * g0 * fmaf(d1, xlo, 1.f), e) : 0.f;
        f2 = gm > 0.f ? ldexpf(nu * nu * ct * gm * fmaf(d2, xlo, 1.f), e) : 0.f;
    }
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
        case OP_MATERN_NU:
            // one copy of the routine, the V entries in turn
#pragma unroll 1
            for (int v = 0; v < V; ++v) {
                float f0, f1, f2;
                matern_nu<false>(&sp.c[a], st[top - 1][v], f0, f1, f2);
                st[top - 1][v] = f0;
            }
            break;
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

// x = sqrt(sc) (c0 + c1), sc = max(s, 1e-30), and its place in a table
// from octave e_lo of 32 intervals an octave (kernels/profile_spec.py
// `_table_point` its plain version): the interval is read off x's bits
// (the exponent and the top 5 mantissa bits) and returned; q, the offset
// in it over its width, is the other 18 bits. x is rounded three times
// (the root, the constant and their product); its rounding error xlo (the
// root's residual, two FMAs and the constant's remainder c1) moves q, so
// the cubic sees x to about float32's rounding. One MUFU (rsqrt).
__device__ __forceinline__ int table_point(float s, float c0, float c1, float e_lo, float& x,
                                           float& q) {
    const float sc = fmaxf(s, 1e-30f);
    const float rs = rsqrt_approx(sc);
    const float sq = sc * rs;
    const float sqlo = fmaf(-sq, sq, sc) * (0.5f * rs);   // sqrt(sc) - sq, to first order
    x = sq * c0;
    const float xlo = fmaf(c0, sqlo, fmaf(sq, c1, fmaf(sq, c0, -x)));
    const int bits = __float_as_int(x);
    // 2^(5 - e), the reciprocal of the interval's width, for x = 1.m 2^e
    const float inv_h = __int_as_float((259 - (bits >> 23)) << 23);
    q = fmaf(xlo, inv_h, (float)(bits & 0x3FFFF) * (1.f / 262144.f));
    return (bits >> 18) - ((127 + (int)e_lo) << 5);
}

// a table's row at q: f(x_k) 2^(q (a1 + q (a2 + q a3))), one MUFU (ex2)
__device__ __forceinline__ float table_value(const float4 t, float q) {
    return t.x * ex2_approx(q * fmaf(fmaf(t.w, q, t.z), q, t.y));
}

// The real-nu Matern family at s (kernels/profile_spec.py
// FAMILY_MATERN_NU, `_matern_nu_family` its plain version), from the table
// of nu in shared memory: interval k of x = sqrt(2 nu sigma s) holds
// (f(x_k), a1, a2, a3), f(x) = f(x_k) 2^(q (a1 + q (a2 + q a3))) with q the
// offset of x in the interval over its width (utils/besselk.py
// `matern_nu_knots`; `table_point`, from octave c7). 2 MUFU (rsqrt, ex2)
// and no logarithm: the offset is exact, and ln f at the knot is in
// f(x_k), so no large exponent is formed. Below the table (or the guard's
// bound c2) the Taylor polynomial 1 + c3 s + c4 s^2 (nu > 1) or 1 - c5
// x^(2 nu) (nu < 1); above it 0, where f has left float32; at s = 0 the
// limit 1.
__device__ __forceinline__ float matern_nu_tabled(float s, const FamilyConsts& f,
                                                  const float4* tab) {
    const float* c = f.c;
    float x, q;
    const int idx = table_point(s, c[0], c[1], c[7], x, q);
    float v;
    if (s < c[2] || idx < 0) {
        v = fmaf(fmaf(c[4], s, c[3]), s, 1.f);
        if (c[5] != 0.f) v -= c[5] * ex2_approx(c[6] * lg2_approx(x));
    } else if (idx >= MATERN_KNOTS) {
        v = 0.f;
    } else {
        v = table_value(tab[idx], q);
    }
    return s > 0.f ? v : 1.f;
}

// The real-nu Matern jet family at s (a derivative spec's FAMILY_MATERN_NU,
// kernels/profile_spec.py `_jet_family` its constants, `_matern_nu_jet_family`
// its plain version): f' = c5 T1(x), f'' = c6 T2(x) from the two tables
// in shared memory, tab[0 .. MATERN_JET_KNOTS) of T1 = -f' and the next
// MATERN_JET_KNOTS of T2 = f'' (utils/besselk.py `matern_nu_jet_knots`),
// one interval for both; below the table or the Taylor bound c2 (s = 0
// included) f' = c3 + c4 s, f'' = c4; above it 0. 3 MUFU (rsqrt, 2 ex2).
__device__ __forceinline__ void matern_nu_jet_tabled(float s, const float* c,
                                                     const float4* tab, float& f1,
                                                     float& f2) {
    float x, q;
    const int idx = table_point(s, c[0], c[1], c[7], x, q);
    if (s < c[2] || idx < 0) {
        f1 = fmaf(c[4], s, c[3]);
        f2 = c[4];
    } else if (idx >= MATERN_JET_KNOTS) {
        f1 = 0.f;
        f2 = 0.f;
    } else {
        f1 = c[5] * table_value(tab[idx], q);
        f2 = c[6] * table_value(tab[MATERN_JET_KNOTS + idx], q);
    }
}

// The family form of a one-leaf spec at s (ProfileSpec.evaluate(s,
// family=True)), without the Constant factor. MaternP(p) with p = P
// (Exp is P = 0): r = root(s), exp2(r (c0 + c1)) sum_j c[2 + j] r^j. The
// real-nu Matern family reads `tab`, its table in shared memory.
template <int FAM, int P>
__device__ __forceinline__ float family_value(float s, const FamilyConsts& f,
                                              const float4* tab = nullptr) {
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
    } else if constexpr (FAM == FAM_MATERN_NU) {
        return matern_nu_tabled(s, f, tab);
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
// profile_spec.py `_jet_family` documents each layout); the real-nu
// Matern's reads its two tables `tab` in shared memory.
#define JET_CONSTS 16

struct JetConsts {
    float c[JET_CONSTS];
};

template <int FAM, int P>
__device__ __forceinline__ void family_jet(float s, const JetConsts& j, float& f1, float& f2,
                                           const float4* tab = nullptr) {
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
    } else if constexpr (FAM == FAM_MATERN_NU) {
        // the two tables in shared memory (`matern_nu_jet_tabled`)
        matern_nu_jet_tabled(s, c, tab, f1, f2);
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
        case OP_MATERN_NU_JET:
#pragma unroll 1
            for (int v = 0; v < V; ++v) {
                float g0, g1, g2;
                matern_nu<true>(&sp.c[a], st[top - 1][v][0], g0, g1, g2);
                chain(st[top - 1][v], g0, g1, g2);
            }
            break;
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
