"""Modified Bessel K for real order, as x^nu K_nu(x), differentiable by
autograd (counterpart of `cfjax.utils.besselk`, which replaces the
reference's BesselK.jl `adbesselkxv`, src/stationary.jl:112).

The same double-exponential (exp-sinh) quadrature of
K_nu(x) = int_0^inf exp(-x cosh t) cosh(nu t) dt as cfjax: 400 nodes, in
log space, with the same clamps, so that the gradients in x and in nu
flow through it. This is the plain version of the real-nu Matern profile;
the CUDA kernels evaluate K_nu by Temme's series and Steed's continued
fraction instead (`csrc/profile_spec.cuh`).

The quadrature loses accuracy at small x, more so for large nu (against
scipy.special.kv: 1e-7 relative below x ~ 1e-3 at nu = 0.5, ~ 7e-3 at
nu = 2.3, ~ 0.9 at nu = 25): cfjax's, kept as it is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_N_NODES = 400
_S_MAX = 4.0


def besselkxv(nu, x):
    """x^nu K_nu(x) for x > 0 (elementwise; broadcasts nu against x)."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    # a Python number takes x's dtype, as a weakly typed scalar does in JAX
    nu = torch.as_tensor(nu, dtype=None if isinstance(nu, torch.Tensor) else x.dtype)
    dt = torch.promote_types(x.dtype, nu.dtype)
    x, nu = x.to(dt), nu.to(device=x.device, dtype=dt)

    s = torch.linspace(-_S_MAX, _S_MAX, _N_NODES, dtype=dt, device=x.device)
    h = s[1] - s[0]
    c = math.pi / 2
    sinh_s = torch.sinh(s)
    t = torch.exp(c * sinh_s)                          # exp-sinh map onto (0, inf)
    logw = math.log(c) + torch.log(torch.cosh(s)) + c * sinh_s   # log dt/ds

    x, nu = torch.broadcast_tensors(x, nu)
    xb = x[..., None]
    nub = nu[..., None]
    # the deep-underflow tail clamped so that every node's exponent stays
    # finite: the gradient of logsumexp then gives it a weight of exactly 0
    t = torch.clamp(t, max=1e8)
    cosh_t = torch.clamp(torch.cosh(t), max=1e30)
    log_cosh_nut = torch.logaddexp(nub * t, -nub * t) - math.log(2.0)
    arg = nub * torch.log(xb) - xb * cosh_t + log_cosh_nut
    return torch.exp(torch.logsumexp(arg + logw, dim=-1)) * h


def besselk(nu, x):
    """K_nu(x) for x > 0."""
    v = besselkxv(nu, x)
    return v * torch.exp(-torch.as_tensor(nu, dtype=v.dtype) * torch.log(torch.as_tensor(x)))


def matern_nu_table(nu: float, jet: bool) -> tuple:
    """The constants, in float64, of the kernels' real-nu Matern opcodes
    (`kernels/profile_spec.py` MATERN_NU for jet=False, MATERN_NU_JET for
    jet=True; `csrc/profile_spec.cuh` `matern_nu` reads them in float32):
      0 nu, 1 sqrt(2 nu) rounded to float32 and 15 the rest: x =
        sqrt(2 nu s), its rounding error carried to first order;
      2, 3 (m, e): c = 2^(1-nu) / Gamma(nu) = m 2^e, m in [1/2, 1): c
        leaves float32's range near nu = 35;
      4, 5 the guard's Taylor coefficients t1, t2 (f = 1 + t1 s + t2 s^2)
        and 6 its bound in float32: eps (1 < nu <= 2), sqrt(eps) (nu > 2),
        0 (nu <= 1);
      7 l, the order of Temme's series or Steed's fraction (|l| <= 1/2),
        8 flip, 9 n: nu = mu + n with mu = nu - floor(nu + 1/2), and
        l = mu, except for a jet at 1 < nu < 3/2, whose orders
        nu - 2 = mu - 1 and nu - 1 = mu need K_(1-mu): there l = -mu
        (flip 1);
      10-14 Temme's constants at l: gamma1 = (1/Gamma(1-l) -
        1/Gamma(1+l)) / (2l), gamma2 = (1/Gamma(1-l) + 1/Gamma(1+l)) / 2,
        1/Gamma(1+l), 1/Gamma(1-l) and pi l / sin(pi l)."""
    nu = float(nu)
    n = math.floor(nu + 0.5)
    mu = nu - n
    flip = jet and n == 1
    l = -mu if flip else mu
    gp, gm = 1.0 / math.gamma(1.0 + l), 1.0 / math.gamma(1.0 - l)
    # gamma1 -> -(Euler's gamma) as l -> 0; the difference cancels below 1e-7
    gam1 = (gm - gp) / (2.0 * l) if abs(l) > 1e-7 else -0.5772156649015329
    fact = math.pi * l / math.sin(math.pi * l) if l else 1.0
    log2c = 1.0 - nu - math.lgamma(nu) / math.log(2.0)
    e = math.floor(log2c) + 1
    eps = 2.0 ** -23
    t1 = nu / (2 * (1 - nu)) if nu > 1 else 0.0
    t2 = nu ** 2 / (8 * (2 - 3 * nu + nu ** 2)) if nu > 2 else 0.0
    bound = math.sqrt(eps) if nu > 2 else eps if nu > 1 else 0.0
    root = math.sqrt(2 * nu)
    root32 = float(np.float32(root))
    return (nu, root32, 2.0 ** (log2c - e), float(e), t1, t2, bound, l, float(flip),
            float(n), gam1, (gm + gp) / 2.0, gp, gm, fact, root - root32)


# the kernels' stopping rule: their float32 loops end once an increment
# falls below KV_EPS of the sum (csrc/profile_spec.cuh)
KV_EPS = 1e-7


def _kv_pair(t, x):
    """(x^l K_l(x), x^(l+1) K_(l+1)(x)) for the table t's order l, x > 0:
    Temme's series at x <= 2, Steed's continued fraction (CF2) above, each
    run as far as float64 needs; and the terms the kernels' loop runs at
    each x (to KV_EPS)."""
    l, gam1, gam2, gampl, gammi, fact = t[7], t[10], t[11], t[12], t[13], t[14]
    small = x <= 2
    # Temme's series
    xs = torch.where(small, x, torch.ones_like(x))
    x2 = 0.5 * xs
    d = -torch.log(x2)
    e = l * d
    fact2 = torch.where(e.abs() < 1e-4, 1 + e * e / 6, torch.sinh(e) / torch.where(
        e == 0, torch.ones_like(e), e))
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    sm = ff
    ee = torch.exp(e)
    p, q = 0.5 * ee / gampl, 0.5 / (ee * gammi)
    c, dd, sm1 = torch.ones_like(x), x2 * x2, p
    terms_t, run = torch.zeros_like(x), torch.ones_like(small)
    for i in range(1, 40):   # the terms fall below eps by i = 25 at x = 2
        ff = (i * ff + p + q) / (i * i - l * l)
        c = c * dd / i
        p, q = p / (i - l), q / (i + l)
        sm = sm + c * ff
        sm1 = sm1 + c * (p - i * ff)
        terms_t += run
        run = run & ((c * ff).abs() >= KV_EPS * sm.abs())
    xl = 2.0 ** l / ee
    a_t, b_t = xl * sm, 2 * xl * sm1
    # Steed's CF2, scaled by exp(x)
    xb = torch.where(small, torch.full_like(x, 3.0), x)
    b = 2 * (1 + xb)
    dd = 1 / b
    h = delh = dd
    q1, q2 = torch.zeros_like(x), torch.ones_like(x)
    a1 = 0.25 - l * l
    q = c = torch.full_like(x, a1)
    a = -a1
    s = 1 + q * delh
    live = torch.ones_like(x, dtype=torch.bool)
    terms_s, run = torch.zeros_like(x), torch.ones_like(small)
    for i in range(1, 100):
        # each entry stops where its increment falls below eps, as the
        # kernels' loop breaks (run on, q2 overflows and c underflows)
        a -= 2 * i
        c = torch.where(live, -a * c / (i + 1), c)
        qn = (q1 - b * q2) / a
        q1, q2 = torch.where(live, q2, q1), torch.where(live, qn, q2)
        q = torch.where(live, q + c * qn, q)
        b = b + 2
        dd = torch.where(live, 1 / (b + a * dd), dd)
        delh = torch.where(live, (b * dd - 1) * delh, delh)
        h = torch.where(live, h + delh, h)
        dels = q * delh
        s = torch.where(live, s + dels, s)
        live = live & (dels.abs() >= 1e-17 * s.abs())
        terms_s += run
        run = run & (dels.abs() >= KV_EPS * s.abs())
    h = a1 * h
    a_s = math.sqrt(math.pi / 2) * xb ** (l - 0.5) / s * torch.exp(-xb)
    b_s = a_s * (l + xb + 0.5 - h)
    return (torch.where(small, a_t, a_s), torch.where(small, b_t, b_s),
            torch.where(small, terms_t, terms_s))


def kv_terms(nu: float, x):
    """(the terms the kernels' K_nu routine runs at each x > 0, whether
    that is Temme's series): for their operation count."""
    x = torch.as_tensor(x, dtype=torch.float64)
    return _kv_pair(matern_nu_table(nu, nu > 1), x)[2], x <= 2


# fp32 instructions and SFU operations of the kernels' K_nu routine
# (csrc/profile_spec.cuh `matern_nu`, `kv_pair`), counted from the source
# with IEEE division 9 + 1 (rcp and its Newton step), sqrt 5 + 1, expf 4 +
# 1, exp2f 2 + 1, logf and log2f 20 + 0, sinhf and coshf 15 + 1: the guard,
# x and its rounding error, the correction and the scaling (value; the jet
# adds f' and f''), each recurrence step, and the fixed and per-term work of
# Temme's series and Steed's fraction
MATERN_OPS = {"value": (45, 3), "jet": (33, 2), "step": (4, 0), "temme": (103, 8),
              "temme_term": (53, 4), "steed": (54, 4), "steed_term": (43, 3)}


def matern_nu_ops(nu: float, s, jet: bool = False) -> tuple:
    """(fp32, SFU) operations of the K_nu routine per entry, averaged over
    the squared distances of a run given as a histogram s = (centres,
    counts), from the terms each entry's x needs (`kv_terms`); below the
    guard's float32 bound an entry costs the guard's polynomial (6 fp32)."""
    centres, counts = s
    t = matern_nu_table(nu, jet)
    closed = centres >= max(t[6], 1e-300)     # above the guard's float32 bound
    terms, small = kv_terms(nu, torch.sqrt(2 * nu * centres))
    w = counts.double() / counts.sum()
    n_steps = max(int(t[9]) - 1, 0)
    out = []
    for k in (0, 1):
        per = (MATERN_OPS["value"][k] + (MATERN_OPS["jet"][k] if jet else 0)
               + n_steps * MATERN_OPS["step"][k]
               + torch.where(small, MATERN_OPS["temme"][k] + terms * MATERN_OPS["temme_term"][k],
                             MATERN_OPS["steed"][k] + terms * MATERN_OPS["steed_term"][k]))
        taylor = 6 if k == 0 else 0
        out.append(float(torch.sum(w * torch.where(closed, per, torch.full_like(per, taylor)))))
    return tuple(out)


def matern_nu_reference(nu: float, s):
    """(f, f', f'') of Matern(nu).profile at s >= 0 in float64 by the
    kernels' method (`csrc/profile_spec.cuh` `matern_nu`): the guard's
    Taylor polynomial below float64's bound, above it c x^nu K_nu(x),
    -c nu x^(nu-1) K_(nu-1)(x) and c nu^2 x^(nu-2) K_|nu-2|(x) at
    x = sqrt(2 nu s), by `_kv_pair` and the recurrence on the scaled
    values g_(k+1) = x^2 g_(k-1) + 2 (mu + k) g_k. The reference the
    kernels are held to on the card: cfjax's quadrature (`besselkxv`)
    loses accuracy at small x, and its autograd jet more (PERF.md)."""
    s = torch.as_tensor(s, dtype=torch.float64)
    t = matern_nu_table(nu, jet=nu > 1)
    eps = torch.finfo(torch.float64).eps
    bound = math.sqrt(eps) if nu > 2 else eps if nu > 1 else 0.0
    taylor = (s < bound) | (s <= 0)
    x = torch.sqrt(2 * nu * torch.where(taylor, torch.ones_like(s), s))
    A, B, _ = _kv_pair(t, x)
    n = int(t[9])
    if t[8]:   # a jet at 1 < nu < 3/2: A = x^-mu K_mu, B = x^(1-mu) K_(1-mu)
        mu = -t[7]
        x2m = x ** (2 * mu)
        gm, g0 = B * x2m / (x * x), A * x2m
        g1 = x * x * gm + 2 * mu * g0
    else:
        gm, g0, g1 = torch.zeros_like(x), A, B
        for k in range(1, n):
            gm, g0, g1 = g0, g1, x * x * g0 + 2 * (t[7] + k) * g1
    c = t[2] * 2.0 ** t[3]
    closed = (c * (g0 if n == 0 else g1), -c * nu * g0, c * nu * nu * gm)
    t1 = nu / (2 * (1 - nu)) if nu > 1 else 0.0
    t2 = nu ** 2 / (8 * (2 - 3 * nu + nu ** 2)) if nu > 2 else 0.0
    poly = (1 + t1 * s + t2 * s * s, t1 + 2 * t2 * s, 2 * t2 + 0 * s)
    return tuple(torch.where(taylor, u, v) for u, v in zip(poly, closed))
