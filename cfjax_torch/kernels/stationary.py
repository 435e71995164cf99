"""Stationary / isotropic kernel zoo (counterpart of
`cfjax.kernels.stationary`, reference src/stationary.jl).

Every `profile(r2)` is a torch scalar function of a tensor, differentiable
to the order the math allows. MaternP's Taylor-at-zero derivative table
(reference src/stationary.jl:172-191) is computed exactly with
`fractions.Fraction` power-series arithmetic at construction.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from ..utils.besselk import besselkxv
from .base import (
    InputTrait,
    IsotropicKernel,
    Kernel,
    StationaryKernel,
    check,
    hp,
)

# clamp inside the value-only rsqrt profiles: keeps the x^{-3/2} VJP of
# rsqrt finite in f32 (shifts the value at s = 0 by ~1e-9)
RSQRT_CLAMP = 1e-18


def _root(s):
    """sqrt(s) as s * rsqrt(max(s, 1e-18)), the value-path form."""
    sc = torch.clamp(s, min=RSQRT_CLAMP)
    return sc * torch.rsqrt(sc)


class Constant(IsotropicKernel):
    """Constant covariance c (reference src/stationary.jl:15-34). Its
    gramian is a lazy rank-1 fill, built by the dispatcher."""

    FIELDS = (("c", 1.0),)

    def __post_init__(self):
        check(lambda v: v >= 0, self.c, "Constant must be PSD (c >= 0)")

    def profile(self, s):
        s = torch.as_tensor(s)
        return hp(self.c, s) * torch.ones_like(s)

    def forward(self, x, y):
        return hp(self.c, torch.as_tensor(x))


class EQ(IsotropicKernel):
    """Exponentiated quadratic, exp(-r^2/2) (src/stationary.jl:37-42)."""

    def profile(self, s):
        return torch.exp(-torch.as_tensor(s) / 2)


class RQ(IsotropicKernel):
    """Rational quadratic (1 + r^2/(2 alpha))^-alpha (src/stationary.jl:45-53)."""

    FIELDS = (("alpha", 1.0),)

    def __post_init__(self):
        check(lambda v: v > 0, self.alpha, "RQ alpha must be positive")

    def profile(self, s):
        s = torch.as_tensor(s)
        a = hp(self.alpha, s)
        return (1.0 + s / (2 * a)) ** (-a)


class Exp(IsotropicKernel):
    """Exponential kernel exp(-r) (src/stationary.jl:56-60)."""

    def profile(self, s):
        return torch.exp(-torch.sqrt(torch.as_tensor(s)))

    def profile_value(self, s):
        return torch.exp(-_root(torch.as_tensor(s)))


class GammaExp(IsotropicKernel):
    """gamma-exponential exp(-r^gamma / 2), 0 <= gamma <= 2
    (src/stationary.jl:63-71). gamma is static."""

    FIELDS = (("gamma", 1.0),)
    STATIC = ("gamma",)

    def __post_init__(self):
        check(lambda v: 0 <= v <= 2, self.gamma, "gamma must be in [0, 2]")

    def profile(self, s):
        return torch.exp(-(torch.as_tensor(s) ** (self.gamma / 2)) / 2)


class Delta(IsotropicKernel):
    """White-noise kernel: 1 iff x == y (src/stationary.jl:74-83)."""

    def profile(self, s):
        s = torch.as_tensor(s)
        return (s == 0).to(s.dtype if s.is_floating_point() else torch.get_default_dtype())

    def forward(self, x, y):
        x = torch.as_tensor(x)
        same = torch.all(x == torch.as_tensor(y))
        return same.to(x.dtype if x.is_floating_point() else torch.get_default_dtype())


# --------------------------------------------------------------------------
# Matern family
# --------------------------------------------------------------------------


def _maternp_tables(p: int):
    """Exact rational tables for the half-integer Matern kernel (nu = p + 1/2).

    Closed form (r = sqrt((2p+1) r^2)):
        k = exp(-r) * p!/(2p)! * sum_{i=0}^p  (p+i)!/(i!(p-i)!) * (2r)^(p-i)

    Taylor derivatives of k w.r.t. r^2 at zero: expand exp(-r) * P(2r) as a
    power series in r with exact Fractions; even coefficients a_{2i} give
    d_i = i! * a_{2i} * (2p+1)^i (reference src/stationary.jl:119-131,
    172-191).
    """
    norm = Fraction(math.factorial(p), math.factorial(2 * p))
    poly = [Fraction(0)] * (p + 1)  # poly[j] = coeff of u^j, u = 2r
    for i in range(p + 1):
        poly[p - i] = Fraction(
            math.factorial(p + i), math.factorial(i) * math.factorial(p - i)
        )
    max_ord = 2 * p
    series = [Fraction(0)] * (max_ord + 1)
    for j in range(p + 1):  # P term: poly[j] * (2r)^j
        cj = poly[j] * (2 ** j)
        for m in range(0, max_ord + 1 - j):  # exp(-r) term: (-1)^m r^m / m!
            series[j + m] += cj * Fraction((-1) ** m, math.factorial(m))
    series = [norm * a for a in series]
    derivs = [
        float(math.factorial(i) * series[2 * i] * (2 * p + 1) ** i)
        for i in range(1, p + 1)
    ]
    poly_coeffs = [float(norm * c) for c in poly]  # coeff of (2r)^j, j=0..p
    return tuple(derivs), tuple(poly_coeffs)


class MaternP(IsotropicKernel):
    """Matern kernel with half-integer smoothness nu = p + 1/2
    (reference src/stationary.jl:117-191). p is static; the rational
    Taylor/derivative tables are precomputed at construction."""

    FIELDS = (("p", 2), ("_derivs", None), ("_poly", None))
    STATIC = ("p", "_derivs", "_poly")

    def __post_init__(self):
        if self.p < 0:
            raise ValueError(f"p must be >= 0, got {self.p}")
        if self._derivs is None:
            self._derivs, self._poly = _maternp_tables(self.p)

    def profile(self, s):
        s = torch.as_tensor(s)
        p = self.p
        if p == 0:
            return torch.exp(-torch.sqrt((2 * p + 1) * s))
        eps = torch.finfo(s.dtype if s.is_floating_point() else torch.get_default_dtype()).eps
        bound = eps ** (1.0 / p)
        use_taylor = s < bound
        # Taylor branch: 1 + sum_i d_i s^i / i!   (polynomial, autograd-safe at 0)
        taylor = torch.ones_like(s)
        si = s
        for i in range(1, p + 1):
            taylor = taylor + self._derivs[i - 1] * si / math.factorial(i)
            si = si * s
        # closed-form branch with masked-safe sqrt input
        s_safe = torch.where(use_taylor, torch.ones_like(s), s)
        r = torch.sqrt((2 * p + 1) * s_safe)
        u = 2 * r
        val = torch.full_like(u, self._poly[p])
        for j in range(p - 1, -1, -1):  # Horner: sum_j poly[j] u^j
            val = val * u + self._poly[j]
        val = val * torch.exp(-r)
        return torch.where(use_taylor, taylor, val)

    def profile_value(self, s):
        """Guard-free value path: r via s*rsqrt(s), no Taylor branch.
        Values match `profile` to roundoff at every s >= 0; the derivative
        in s is clamped to 0 near 0 (Kernel.profile_value contract)."""
        r = _root(torch.as_tensor(s) * (2 * self.p + 1))
        u = 2 * r
        val = torch.full_like(u, self._poly[self.p])
        for j in range(self.p - 1, -1, -1):
            val = val * u + self._poly[j]
        return val * torch.exp(-r)


def matern_taylor(nu, s):
    """Matern(nu).profile's guard near s = 0: (the bound below which it
    holds, in s's dtype, and its value 1 + t1 s + t2 s^2). nu may be a
    float or a tensor."""
    eps = torch.finfo(s.dtype).eps
    nu = torch.as_tensor(nu, dtype=s.dtype, device=s.device)
    zero = torch.zeros_like(nu)
    bound = torch.where(nu > 2, zero + math.sqrt(eps), torch.where(nu > 1, zero + eps, zero))
    t1 = torch.where(nu > 1, nu / (2 * (1 - nu)) * s, torch.zeros_like(s))
    t2 = torch.where(nu > 2, nu ** 2 / (8 * (2 - 3 * nu + nu ** 2)) * s ** 2, torch.zeros_like(s))
    return bound, 1.0 + t1 + t2


def matern_profile(nu, s):
    """Matern(nu).profile of s: the closed form 2^(1-nu) / Gamma(nu)
    r^nu K_nu(r), r = sqrt(2 nu s), through the differentiable quadrature
    of `utils/besselk.py`, and below the guard's bound its Taylor
    polynomial (`matern_taylor`), selected with nan-safe wheres as in
    cfjax. At s = 0 it is the limit 1 for every nu: cfjax's quadrature
    takes log 0 there and returns 0 for nu <= 1, which its guard does not
    cover. nu: a float or a tensor."""
    s = torch.as_tensor(s)
    if not s.is_floating_point():
        s = s.to(torch.get_default_dtype())
    nu = torch.as_tensor(nu, dtype=s.dtype, device=s.device)
    bound, taylor = matern_taylor(nu, s)
    use_taylor = (s < bound) | (s <= 0)
    s_safe = torch.where(use_taylor, torch.ones_like(s), s)
    r = torch.sqrt(2 * nu * s_safe)
    closed = torch.exp((1 - nu) * math.log(2.0) - torch.lgamma(nu)) * besselkxv(nu, r)
    return torch.where(use_taylor, taylor, closed)


class Matern(IsotropicKernel):
    """Matern kernel with real smoothness nu (src/stationary.jl:87-114),
    profile `matern_profile`. nu is a hyperparameter (`parameters`,
    `similar`), as in cfjax."""

    FIELDS = (("nu", 1.5),)

    def __post_init__(self):
        check(lambda v: v > 0, self.nu, "nu must be positive")

    def profile(self, s):
        s = torch.as_tensor(s)
        return matern_profile(hp(self.nu, s), s)


class Cosine(StationaryKernel):
    """cos(2 pi <c, x-y>) — the one stationary non-isotropic kernel
    (src/stationary.jl:197-211). Admits negative covariances."""

    FIELDS = (("c", 1.0),)

    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY_LINEAR_FUNCTIONAL

    def profile(self, t):
        return torch.cos(2 * math.pi * torch.as_tensor(t))

    def tau_call(self, tau):
        tau = torch.as_tensor(tau)
        return self.profile(torch.sum(hp(self.c, tau) * tau))


class Cauchy(IsotropicKernel):
    """1 / (1 + r^2) (src/stationary.jl:221-224)."""

    def profile(self, s):
        return 1.0 / (1.0 + torch.as_tensor(s))


class InverseMultiQuadratic(IsotropicKernel):
    """1 / sqrt(r^2 + c^2) (src/stationary.jl:231-235)."""

    FIELDS = (("c", 1.0),)

    def profile(self, s):
        s = torch.as_tensor(s)
        c = hp(self.c, s)
        return 1.0 / torch.sqrt(s + c * c)


IMQ = InverseMultiQuadratic


def PseudoVoigt(alpha) -> Kernel:
    """alpha * EQ + (1 - alpha) * Cauchy (src/stationary.jl:227)."""
    return alpha * EQ() + (1.0 - alpha) * Cauchy()


def Spectral(w, mu, l) -> Kernel:
    """Single spectral component: w * Cosine(mu) * ARD(EQ, l)
    (src/stationary.jl:215-216)."""
    from .transforms import ARD

    return Constant(w) * Cosine(np.asarray(mu)) * ARD(EQ(), l)


def SpectralMixture(w, mu, l) -> Kernel:
    """Sum of spectral components (src/stationary.jl:217). w: (q,),
    mu/l: sequences of q center/lengthscale vectors."""
    from .algebra import Sum

    w = np.asarray(w)
    return Sum(tuple(Spectral(w[i], mu[i], l[i]) for i in range(len(w))))


SM = SpectralMixture
