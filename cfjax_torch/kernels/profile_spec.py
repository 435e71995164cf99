"""Profile specs: a kernel's value profile as data a CUDA kernel can read.

cfjax's Pallas kernels take the profile as a jnp closure that Mosaic bakes
into the compiled kernel (`cfjax/ops/pallas_mvm.py:195,278`). A CUDA
kernel built once from fixed sources cannot take a closure, so the port
turns `profile_value` of an isotropic or dot-product kernel into a short
postfix program: opcodes, one integer argument each, and a table of float
constants. The CUDA kernels (`csrc/gramian_mvm.cu`) interpret it per
element with a small register stack; every thread runs the same opcode
sequence, so warps never diverge on it.

Covered: EQ, Exp, GammaExp, MaternP(p), Matern(nu), RQ, Cauchy, IMQ,
Constant, Dot and ExponentialDot, closed under Sum, Product, Power,
Lengthscale and Constant scaling. `to_spec(k)` returns `(spec, None)` or
`(None, reason)`.
`ProfileSpec.evaluate` is the plain torch evaluator of a program; it
agrees with `k.profile_value` op for op.

Families. A value spec whose kernel is one leaf — EQ, Exp, MaternP(p <= 3),
RQ, Cauchy, InverseMultiQuadratic or real-nu Matern — under any chain of
Lengthscale scalings, times at most one Constant, is also tagged with a
family: an id, MaternP's p, the leaf's constants with every lengthscale
folded in (the divisions by constants become multiplications, exp becomes
exp2 of a prescaled argument) and the Constant as a factor of the row
sum. K1 has an instance per family, evaluated in registers, where the
program would be interpreted; `ProfileSpec.evaluate(s, family=True)` is
the plain torch evaluator of the folded form. Other specs (sums,
products, Power, GammaExp) keep the interpreter. K2 takes the same
families as K1, the real-nu Matern's table included.

The real-nu Matern family (FAMILY_MATERN_NU) reads a table of nu
(`utils/besselk.py` `matern_nu_knots`): for x = sqrt(2 nu s) in an octave
interval x_k .. x_k + h, f = f(x_k) 2^(q (a1 + q (a2 + q a3))), q = (x -
x_k) / h, the cubic Hermite interpolant of log2 f(x) / f(x_k). The
interval is the float's exponent and top 5 mantissa bits and q the rest of
its mantissa, so an entry costs a root, integer operations, a cubic and
one exp2; x's rounding error moves q before the cubic. Below the table the
guard's Taylor polynomial (nu > 1) or 1 - a x^(2 nu) (nu < 1,
`matern_nu_small`); above it 0 (the table ends where f leaves float32).

Derivative specs. The gradient-block kernel needs f, f' and f'' of the
profile. A value program cannot give them: ROOT and MATERNP clamp their
argument at 1e-18, so their derivatives vanish at s = 0, where -2 f'(0) I
is the whole diagonal block of a gradient gramian. `to_spec(k,
derivative=True)` therefore compiles `k.profile` instead: MaternP becomes
MATERNP_JET, whose rules follow `MaternP.profile` down to s = 0 (the
Taylor branch below eps^(1/p), the closed form above it), and kernels
whose profile has no finite f' or f'' at s = 0 (Exp, MaternP(0), GammaExp)
decline. `ProfileSpec.evaluate_jet(s)` propagates the
second-order jet (f, f', f'') through a program, one rule per opcode.

Real-nu Matern. MATERN_NU (value specs) and MATERN_NU_JET (derivative
specs) are one opcode each, over a table of constants that depend on nu
alone, computed on the host in float64 (`utils/besselk.py`
`matern_nu_table`): the kernels evaluate x^nu K_nu(x) by Temme's series
(x <= 2) or Steed's continued fraction (x > 2) at an order mu in
[-1/2, 1/2], then run the recurrence on the scaled values
g_k = x^(mu+k) K_(mu+k)(x) up to nu (`csrc/profile_spec.cuh` `matern_nu`).
The jet needs no second quadrature: with r = sqrt(2 nu s) and
c = 2^(1-nu) / Gamma(nu), f' = -c nu r^(nu-1) K_(nu-1)(r) and
f'' = c nu^2 r^(nu-2) K_|nu-2|(r), orders of the same recurrence. The
plain rules are `Matern.profile`'s (cfjax's quadrature), its jet by
autograd. A derivative spec declines nu <= 1, where the profile has no
finite f' at s = 0.

A derivative spec of a one-leaf iso kernel (EQ, MaternP(1..3), RQ,
Cauchy, IMQ, real-nu Matern with 1 < nu <= 64, under lengthscales, times
at most one Constant) carries a family too, with a table for f' and f''
in closed form (`_jet_family`, up to JET_CONSTS values): the tensor-core
K3 evaluates it in registers, the real-nu Matern's from two tables of nu
laid out as the value family's (`utils/besselk.py`
`matern_nu_jet_knots`: -f' and f'' as functions of x, one interval for
both), and `ProfileSpec.evaluate_jet_family(s)` is its plain torch
evaluator.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import numpy as np
import torch

from .algebra import Power, Product, Sum
from .base import InputTrait
from .mercer import Dot, ExponentialDot
from .stationary import (
    EQ,
    RQ,
    RSQRT_CLAMP,
    Cauchy,
    Constant,
    Exp,
    GammaExp,
    InverseMultiQuadratic,
    Matern,
    MaternP,
    matern_profile,
)
from ..utils.besselk import (MATERN_STEPS, MATERN_TABLE_MAX_NU, matern_nu_jet_knots,
                              matern_nu_jet_octave, matern_nu_jet_taylor, matern_nu_knots,
                              matern_nu_octave, matern_nu_small, matern_nu_table)
from .derivatives import elementwise_derivatives
from .transforms import Lengthscale

# opcodes; the same numbers are #defined in csrc/gramian_mvm.cu
PUSH_S = 0    # push the argument s (squared distance or inner product)
PUSH_C = 1    # push consts[arg]
ADD = 2       # b = pop, a = pop, push a + b
MUL = 3       # a * b
DIV = 4       # a / b
NEG = 5       # -a
EXP = 6       # exp(a)
SQRT = 7      # sqrt(a)
ROOT = 8      # sc * rsqrt(sc), sc = max(a, 1e-18): the value-path sqrt
POWC = 9      # a ** consts[arg]
POWI = 10     # a ** arg, integer exponent
MATERNP = 11  # Matern-(p+1/2) closed form of t = (2p+1) s; consts[arg] = p,
              # consts[arg+1 .. arg+1+p] = Horner coefficients of (2r)^j
MATERNP_JET = 12  # MaternP.profile of s (derivative specs only); consts[arg] = p,
                  # then the tables of `_maternp_jet_table` (4p + 1 values)
MATERN_NU = 13      # Matern(nu).profile of s; consts[arg ..] = matern_nu_table(nu, False)
MATERN_NU_JET = 14  # the same with f' and f'' (derivative specs only);
                    # consts[arg ..] = matern_nu_table(nu, True)

MAX_OPS = 64
MAX_CONSTS = 64
MAX_STACK = 8

# families of one-leaf value specs; the same numbers are #defined in
# csrc/profile_spec.cuh. Folded constants c (sigma = the product of 1/l^2);
# an exp2 argument u c is taken as u (c0 + c1), c0 the float32 nearest to
# the constant and c1 the rest, so that the kernel can form it exactly:
FAMILY_NONE = 0    # interpreted
FAMILY_EQ = 1      # exp2(s (c0 + c1)), c0 + c1 = -sigma / (2 ln 2)
FAMILY_MATERN = 2  # r = root(s), exp2(r (c0 + c1)) sum_j c[2+j] r^j,
                   # c0 + c1 = -sqrt((2p+1) sigma) / ln 2 (Exp is p = 0)
FAMILY_RQ = 3      # exp2(c1 log2(1 + s c0)), c0 = sigma / (2 alpha), c1 = -alpha
FAMILY_CAUCHY = 4  # 1 / (1 + s c0), c0 = sigma
FAMILY_IMQ = 5     # rsqrt(s c0 + c1), c0 = sigma, c1 = c^2
FAMILY_MATERN_NU = 6  # the table of nu (module docstring): c0 + c1 = sqrt(2 nu sigma)
                      # (split), c2 the guard's bound in s, c3, c4 its Taylor
                      # coefficients in s, c5 = a of 1 - a x^(2 nu), c6 = 2 nu,
                      # c7 = e_lo (the table's first octave), c8 = nu
FAMILY_MAX_P = 3
FAMILY_CONSTS = 9  # the largest folded table (the real-nu Matern's)
JET_CONSTS = 16    # the largest derivative-family table (MaternP(3): 3 + 13 values)

_POP = {PUSH_S: -1, PUSH_C: -1, ADD: 1, MUL: 1, DIV: 1, POWC: 0, POWI: 0,
        NEG: 0, EXP: 0, SQRT: 0, ROOT: 0, MATERNP: 0, MATERNP_JET: 0, MATERN_NU: 0,
        MATERN_NU_JET: 0}


def _maternp_jet_table(p: int):
    """Exact tables for MATERNP_JET (p >= 1), in rho = sqrt((2p+1) s):
      tau (p): Taylor coefficients, f = 1 + sum_i tau_i s^i below eps^(1/p);
      q (p+1): f = exp(-rho) Q(rho), Q = sum_j q_j rho^j;
      r1 (p):  f' = (c/2) exp(-rho) R1(rho), R1 = (Q' - Q) / rho;
      s2 (p):  f'' = (c/2)^2 exp(-rho) S2(rho) / rho, S2 = R1' - R1,
    with c = 2p + 1. S2(0) = 0 for p >= 2, so f'' is finite at 0; for
    p = 1 it grows like 1/rho above the Taylor bound, as the closed form's
    does. Computed with Fractions: the closed forms carry no cancellation,
    where autodiff of the closed form loses about eps / rho^3 in f''."""
    norm = Fraction(math.factorial(p), math.factorial(2 * p))
    q = [norm * Fraction(math.factorial(2 * p - j),
                         math.factorial(p - j) * math.factorial(j)) * 2 ** j
         for j in range(p + 1)]
    s1 = [(j + 1) * q[j + 1] - q[j] for j in range(p)] + [-q[p]]
    assert s1[0] == 0
    r1 = s1[1:]
    s2 = [(j + 1) * r1[j + 1] - r1[j] for j in range(p - 1)] + [-r1[p - 1]]
    # Taylor: even coefficients of exp(-rho) Q(rho), times c^i
    series = [sum(q[j] * Fraction((-1) ** (i - j), math.factorial(i - j))
                  for j in range(min(i, p) + 1)) for i in range(2 * p + 1)]
    tau = [series[2 * i] * (2 * p + 1) ** i for i in range(1, p + 1)]
    return tuple(float(v) for v in tau + q + r1 + s2)


def _horner(cs, x):
    v = torch.full_like(x, cs[-1])
    for c in cs[-2::-1]:
        v = v * x + c
    return v


def _maternp_jet(p, tab, s):
    """(g, g', g'') of MaternP(p).profile at s, from `_maternp_jet_table`."""
    tau, q = tab[:p], tab[p:2 * p + 1]
    r1, s2 = tab[2 * p + 1:3 * p + 1], tab[3 * p + 1:]
    c = 2 * p + 1
    bound = torch.finfo(s.dtype).eps ** (1.0 / p)
    taylor = s < bound
    t = torch.where(taylor, s, torch.zeros_like(s))
    t0 = 1.0 + t * _horner(tau, t)
    t1 = _horner([i * tau[i - 1] for i in range(1, p + 1)], t)
    t2 = (_horner([i * (i - 1) * tau[i - 1] for i in range(2, p + 1)], t)
          if p >= 2 else torch.zeros_like(t))
    rho = torch.sqrt(c * torch.where(taylor, torch.ones_like(s), s))
    e = torch.exp(-rho)
    c0 = e * _horner(q, rho)
    c1 = (c / 2) * e * _horner(r1, rho)
    c2 = (c / 2) ** 2 * e * _horner(s2, rho) / rho
    return (torch.where(taylor, t0, c0), torch.where(taylor, t1, c1),
            torch.where(taylor, t2, c2))


def _exp2_split(u, c0, c1):
    """exp2(u (c0 + c1)) as K1 forms it: exp2 of the rounded product
    t = u c0, times 1 + ln 2 (u (c0 + c1) - t), the product's rounding
    error and u c1 taken in float64."""
    t = u * c0
    lo = (u.double() * c0 - t.double() + u.double() * c1).to(u.dtype)
    e = torch.exp2(t)
    return e + e * (lo * math.log(2.0))


def _table_point(s, r0, r1, e_lo):
    """(the interval's index, q) of x = sqrt(2 nu sigma s) in a table that
    starts at octave e_lo, as the kernels form them (csrc/profile_spec.cuh
    `table_point`), in s's dtype: x and its rounding error (the FMA
    residuals taken in float64), the interval from x's exponent and
    mantissa, the offset q moved by the rounding error."""
    dt = s.dtype
    sc = torch.clamp(s, min=1e-30)
    sq = torch.sqrt(sc)
    sd = sq.double()
    sqlo = ((sc.double() - sd * sd) / (2 * sd)).to(dt)
    x = sq * r0
    xlo = (sd * r0 - x.double() + sd * r1 + sqlo.double() * r0).to(dt)
    m, e = torch.frexp(x)                       # x = (2m) 2^(e - 1), 2m in [1, 2)
    u = (2 * m - 1) * MATERN_STEPS
    j = torch.floor(u)
    idx = (e - 1 - int(e_lo)) * MATERN_STEPS + j.long()
    return idx, (u - j) + xlo * MATERN_STEPS * torch.exp2(-(e - 1).to(dt))


def _table_value(tab, idx, q):
    """The cubic of interval idx at q (0 past the table's end)."""
    row = tab[idx.clamp(0, tab.shape[0] - 1)]
    f = row[..., 0] * torch.exp2(q * ((row[..., 3] * q + row[..., 2]) * q + row[..., 1]))
    return torch.where(idx >= tab.shape[0], torch.zeros_like(f), f)


def _matern_nu_family(s, c):
    """The tabulated real-nu Matern family at s, as K1 and K2 compute it
    (csrc/profile_spec.cuh `matern_nu_tabled`), in s's dtype, against the
    table in s's dtype."""
    r0, r1, bound, t1, t2, a, two_nu, e_lo, nu = c
    tab = matern_nu_knots(nu).to(device=s.device, dtype=s.dtype)
    idx, q = _table_point(s, r0, r1, e_lo)
    f = _table_value(tab, idx, q)
    x = torch.sqrt(torch.clamp(s, min=1e-30)) * r0
    small = 1 + s * (t1 + s * t2) - a * torch.exp2(two_nu * torch.log2(x))
    f = torch.where((s < bound) | (idx < 0), small, f)
    return torch.where(s <= 0, torch.ones_like(f), f)


def _matern_nu_jet_family(s, c):
    """(f', f'') of the tabulated real-nu Matern jet family at s, as K3
    computes them (csrc/profile_spec.cuh `matern_nu_jet_tabled`), in s's
    dtype: one interval for both tables (`utils/besselk.py`
    `matern_nu_jet_knots`); below the table (or the Taylor bound c2, s = 0
    included) f' = c3 + c4 s, f'' = c4."""
    r0, r1, bound, c3, c4, c5, c6, e_lo, nu = c
    t1, t2 = (t.to(device=s.device, dtype=s.dtype) for t in matern_nu_jet_knots(nu))
    idx, q = _table_point(s, r0, r1, e_lo)
    f1, f2 = c5 * _table_value(t1, idx, q), c6 * _table_value(t2, idx, q)
    taylor = (s < bound) | (idx < 0)
    return (torch.where(taylor, c3 + c4 * s, f1),
            torch.where(taylor, torch.full_like(f2, c4), f2))


def _chain(u, g, g1, g2):
    """Jet of g(u) from the jet of u and g's derivatives at u."""
    return g, g1 * u[1], g2 * u[1] * u[1] + g1 * u[2]


def _jmul(u, v):
    return (u[0] * v[0], u[1] * v[0] + u[0] * v[1],
            u[2] * v[0] + 2 * u[1] * v[1] + u[0] * v[2])


def _jdiv(u, v):
    q = u[0] / v[0]
    q1 = (u[1] - q * v[1]) / v[0]
    return q, q1, (u[2] - 2 * q1 * v[1] - q * v[2]) / v[0]


def _jroot(u):
    """Jet of the value-path sqrt: derivatives 0 below the clamp."""
    live = u[0] >= RSQRT_CLAMP
    sc = torch.clamp(u[0], min=RSQRT_CLAMP)
    r = sc * torch.rsqrt(sc)
    g1 = torch.where(live, 0.5 / r, torch.zeros_like(r))
    g2 = torch.where(live, -0.25 / (r * sc), torch.zeros_like(r))
    return _chain(u, r, g1, g2)


def _ipow(u, n):
    return u ** n if n else torch.ones_like(u)


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """A postfix program over one scalar argument s."""

    mode: str          # "iso" (s = ||x - y||^2) or "dot" (s = <x, y>)
    ops: tuple
    args: tuple
    consts: tuple
    jet: bool = False  # compiled from `profile` (derivative spec), not `profile_value`
    family: int = FAMILY_NONE   # the one-leaf family, if any (see the module docstring)
    family_p: int = 0           # MaternP's p in FAMILY_MATERN
    family_consts: tuple = ()   # the folded constants c0, c1, ...
    family_scale: float = 1.0   # the Constant factor

    @property
    def depth(self) -> int:
        d = top = 0
        for op in self.ops:
            d -= _POP[op]
            top = max(top, d)
        return top

    def evaluate(self, s, family: bool = False):
        """Plain torch evaluator of the program (elementwise over s); with
        family=True, of the folded family form that K1's specialised
        instances compute."""
        s = torch.as_tensor(s)
        if family:
            return self._evaluate_family(s)
        c = self.consts
        st = []
        for op, a in zip(self.ops, self.args):
            if op == PUSH_S:
                st.append(s)
            elif op == PUSH_C:
                st.append(torch.tensor(c[a], dtype=s.dtype, device=s.device))
            elif op in (ADD, MUL, DIV):
                v = st.pop()
                u = st.pop()
                st.append(u + v if op == ADD else u * v if op == MUL else u / v)
            elif op == NEG:
                st.append(-st.pop())
            elif op == EXP:
                st.append(torch.exp(st.pop()))
            elif op == SQRT:
                st.append(torch.sqrt(st.pop()))
            elif op == ROOT:
                sc = torch.clamp(st.pop(), min=RSQRT_CLAMP)
                st.append(sc * torch.rsqrt(sc))
            elif op == POWC:
                st.append(st.pop() ** c[a])
            elif op == POWI:
                st.append(st.pop() ** a)
            elif op == MATERNP:
                p = int(c[a])
                sc = torch.clamp(st.pop(), min=RSQRT_CLAMP)
                r = sc * torch.rsqrt(sc)
                u = 2 * r
                val = torch.full_like(u, c[a + 1 + p])
                for j in range(p - 1, -1, -1):
                    val = val * u + c[a + 1 + j]
                st.append(val * torch.exp(-r))
            elif op == MATERNP_JET:
                p = int(c[a])
                st.append(_maternp_jet(p, c[a + 1:a + 4 * p + 2], st.pop())[0])
            elif op in (MATERN_NU, MATERN_NU_JET):
                st.append(matern_profile(c[a], st.pop()))
            else:
                raise ValueError(f"unknown opcode {op}")
        (out,) = st
        return out * torch.ones_like(s)

    def _evaluate_family(self, s):
        if self.family == FAMILY_NONE:
            raise ValueError("this spec has no family: it is interpreted")
        if self.jet:
            raise ValueError("a derivative spec's family gives f' and f'': "
                             "evaluate_jet_family")
        c = self.family_consts
        if self.family == FAMILY_EQ:
            f = _exp2_split(s, c[0], c[1])
        elif self.family == FAMILY_MATERN:
            sc = torch.clamp(s, min=RSQRT_CLAMP)
            r = sc * torch.rsqrt(sc)
            f = _horner(c[2:self.family_p + 3], r) * _exp2_split(r, c[0], c[1])
        elif self.family == FAMILY_RQ:
            f = torch.exp2(c[1] * torch.log2(1.0 + s * c[0]))
        elif self.family == FAMILY_CAUCHY:
            f = 1.0 / (1.0 + s * c[0])
        elif self.family == FAMILY_IMQ:
            f = torch.rsqrt(s * c[0] + c[1])
        elif self.family == FAMILY_MATERN_NU:
            f = _matern_nu_family(s, c)
        else:
            raise ValueError(f"unknown family {self.family}")
        return self.family_scale * f

    def evaluate_jet_family(self, s):
        """(f'(s), f''(s)) of a derivative spec's family form, as K3's family
        instances compute them (`_jet_family` gives each table's layout)."""
        if not self.jet or self.family == FAMILY_NONE:
            raise ValueError("this spec has no derivative family: it is interpreted")
        s = torch.as_tensor(s)
        c = self.family_consts
        if self.family == FAMILY_EQ:
            e = _exp2_split(s, c[0], c[1])
            return c[2] * e, c[3] * e
        if self.family == FAMILY_MATERN:
            p = self.family_p
            _, g1, g2 = _maternp_jet(p, c[3:3 + 4 * p + 1], c[0] * s)
            return c[1] * g1, c[2] * g2
        if self.family == FAMILY_RQ:
            b = 1.0 + s * c[0]
            pw = torch.exp2(c[1] * torch.log2(b)) / b
            return c[2] * pw, c[3] * pw / b
        if self.family == FAMILY_CAUCHY:
            r = 1.0 / (1.0 + s * c[0])
            return c[1] * r * r, c[2] * r * r * r
        if self.family == FAMILY_IMQ:
            r = torch.rsqrt(s * c[0] + c[1])
            return c[2] * r ** 3, c[3] * r ** 5
        if self.family == FAMILY_MATERN_NU:
            return _matern_nu_jet_family(s, c)
        raise ValueError(f"unknown family {self.family}")

    def evaluate_jet(self, s):
        """Plain torch second-order jet of the program: (f, f', f'') at s,
        elementwise, one propagation rule per opcode."""
        s = torch.as_tensor(s)
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        c = self.consts
        st = []
        for op, a in zip(self.ops, self.args):
            if op == PUSH_S:
                st.append((s, one, zero))
            elif op == PUSH_C:
                st.append((torch.full_like(s, c[a]), zero, zero))
            elif op in (ADD, MUL, DIV):
                v = st.pop()
                u = st.pop()
                st.append(tuple(x + y for x, y in zip(u, v)) if op == ADD
                          else _jmul(u, v) if op == MUL else _jdiv(u, v))
            elif op == NEG:
                st.append(tuple(-x for x in st.pop()))
            elif op == EXP:
                u = st.pop()
                e = torch.exp(u[0])
                st.append(_chain(u, e, e, e))
            elif op == SQRT:
                u = st.pop()
                r = torch.sqrt(u[0])
                st.append(_chain(u, r, 0.5 / r, -0.25 / (r * u[0])))
            elif op == ROOT:
                st.append(_jroot(st.pop()))
            elif op == POWC:
                u = st.pop()
                e = c[a]
                st.append(_chain(u, u[0] ** e, e * u[0] ** (e - 1),
                                 e * (e - 1) * u[0] ** (e - 2)))
            elif op == POWI:
                u = st.pop()
                g1 = a * _ipow(u[0], a - 1) if a else zero
                g2 = a * (a - 1) * _ipow(u[0], a - 2) if a not in (0, 1) else zero
                st.append(_chain(u, _ipow(u[0], a), g1, g2))
            elif op == MATERNP:
                p = int(c[a])
                r = _jroot(st.pop())
                u = tuple(2 * x for x in r)
                val = (torch.full_like(s, c[a + 1 + p]), zero, zero)
                for j in range(p - 1, -1, -1):
                    val = _jmul(val, u)
                    val = (val[0] + c[a + 1 + j], val[1], val[2])
                e = torch.exp(-r[0])
                st.append(_jmul(val, _chain(r, e, -e, e)))
            elif op == MATERNP_JET:
                p = int(c[a])
                u = st.pop()
                st.append(_chain(u, *_maternp_jet(p, c[a + 1:a + 4 * p + 2], u[0])))
            elif op == MATERN_NU_JET:
                u = st.pop()
                nu = c[a]
                with torch.enable_grad():
                    g = elementwise_derivatives(lambda t: matern_profile(nu, t),
                                                u[0].detach(), 2)
                st.append(_chain(u, *g))
            else:
                raise ValueError(f"unknown opcode {op}")
        (out,) = st
        return tuple(v * one for v in out)


class _Decline(Exception):
    pass


class _Builder:
    def __init__(self):
        self.ops, self.args, self.consts = [], [], []

    def emit(self, op, arg=0):
        self.ops.append(op)
        self.args.append(arg)

    def const(self, v) -> int:
        self.consts.append(float(v))
        return len(self.consts) - 1

    def push(self, v):
        self.emit(PUSH_C, self.const(v))


def _scalar(k, name):
    t = getattr(k, name)
    if t.numel() != 1:
        raise _Decline(f"{type(k).__name__}.{name} is not a scalar")
    return float(t.detach().reshape(()))


def _emit(k, b, push_s, jet: bool):
    if isinstance(k, Constant):
        b.push(_scalar(k, "c"))
    elif isinstance(k, EQ):                      # exp(-s / 2)
        push_s()
        b.emit(NEG)
        b.push(2.0)
        b.emit(DIV)
        b.emit(EXP)
    elif isinstance(k, Exp):                     # exp(-root(s))
        if jet:
            raise _Decline("Exp: exp(-sqrt(s)) has no finite derivative at s = 0")
        push_s()
        b.emit(ROOT)
        b.emit(NEG)
        b.emit(EXP)
    elif isinstance(k, GammaExp):                # exp(-(s ** (g/2)) / 2)
        if jet:
            # gamma < 2: f' is unbounded at 0; gamma = 2: autodiff of s ** 1.0
            # gives 0 * inf = NaN for f''(0), in cfjax's profile and in the port's
            raise _Decline(f"GammaExp({k.gamma}): s ** (gamma/2) has no finite "
                           "f'' at s = 0")
        push_s()
        b.emit(POWC, b.const(k.gamma / 2))
        b.emit(NEG)
        b.push(2.0)
        b.emit(DIV)
        b.emit(EXP)
    elif isinstance(k, Matern):
        nu = _scalar(k, "nu")
        if jet and nu <= 1:
            raise _Decline(f"Matern({nu}): nu <= 1 has no finite f' at s = 0")
        push_s()
        off = len(b.consts)
        for v in matern_nu_table(nu, jet):
            b.const(v)
        b.emit(MATERN_NU_JET if jet else MATERN_NU, off)
    elif isinstance(k, MaternP) and jet:
        if k.p == 0:
            raise _Decline("MaternP(0): exp(-sqrt(s)) has no finite derivative at s = 0")
        push_s()
        off = b.const(k.p)
        for v in _maternp_jet_table(k.p):
            b.const(v)
        b.emit(MATERNP_JET, off)
    elif isinstance(k, MaternP):
        push_s()
        b.push(2 * k.p + 1)
        b.emit(MUL)
        off = b.const(k.p)
        for cj in k._poly:
            b.const(cj)
        b.emit(MATERNP, off)
    elif isinstance(k, RQ):                      # (1 + s / (2a)) ** (-a)
        a = _scalar(k, "alpha")
        b.push(1.0)
        push_s()
        b.push(2 * a)
        b.emit(DIV)
        b.emit(ADD)
        b.emit(POWC, b.const(-a))
    elif isinstance(k, Cauchy):                  # 1 / (1 + s)
        b.push(1.0)
        b.push(1.0)
        push_s()
        b.emit(ADD)
        b.emit(DIV)
    elif isinstance(k, InverseMultiQuadratic):   # 1 / sqrt(s + c^2)
        c = _scalar(k, "c")
        b.push(1.0)
        push_s()
        b.push(c * c)
        b.emit(ADD)
        b.emit(SQRT)
        b.emit(DIV)
    elif isinstance(k, Dot):
        push_s()
    elif isinstance(k, ExponentialDot):
        push_s()
        b.emit(EXP)
    elif isinstance(k, (Sum, Product)):
        op = ADD if isinstance(k, Sum) else MUL
        for i, a in enumerate(k.args):
            _emit(a, b, push_s, jet)
            if i:
                b.emit(op)
    elif isinstance(k, Power):
        _emit(k.k, b, push_s, jet)
        b.emit(POWI, int(k.p))
    elif isinstance(k, Lengthscale):             # k(s / l^2)
        l = _scalar(k, "l")

        def push_scaled():
            push_s()
            b.push(l * l)
            b.emit(DIV)

        _emit(k.k, b, push_scaled, jet)
    elif type(k).__name__ == "_EmbeddedPeriodic":
        _emit(k.k, b, push_s, jet)
    else:
        raise _Decline(f"{type(k).__name__} has no profile spec")


def _leaf(k):
    """(leaf kernel, sigma = the product of 1/l^2, the Constant factor) of a
    one-leaf kernel under Lengthscale scalings and at most one Constant."""
    sigma, scale, constants = 1.0, 1.0, 0
    while True:
        if isinstance(k, Lengthscale):
            sigma /= _scalar(k, "l") ** 2
            k = k.k
        elif isinstance(k, Product) and len(k.args) == 2 and constants == 0 \
                and sum(isinstance(a, Constant) for a in k.args) == 1:
            c, k = k.args if isinstance(k.args[0], Constant) else k.args[::-1]
            scale *= _scalar(c, "c")
            constants = 1
        elif type(k).__name__ == "_EmbeddedPeriodic":
            k = k.k
        else:
            return k, sigma, scale


def _split(c):
    """(the float32 nearest c, the rest): an exp2 argument u c taken exactly."""
    return float(np.float32(c)), c - float(np.float32(c))


def _family(k):
    """(family, p, folded constants, scale) of a one-leaf value spec, or
    None (see the module docstring)."""
    k, sigma, scale = _leaf(k)
    ln2 = math.log(2.0)
    if isinstance(k, EQ):
        return FAMILY_EQ, 0, _split(-sigma / (2 * ln2)), scale
    if isinstance(k, (Exp, MaternP)):
        p = 0 if isinstance(k, Exp) else k.p
        if p > FAMILY_MAX_P:
            return None
        poly = (1.0,) if isinstance(k, Exp) else k._poly
        root = math.sqrt((2 * p + 1) * sigma)   # r = root * sqrt(s)
        return (FAMILY_MATERN, p,
                _split(-root / ln2) + tuple(cj * (2 * root) ** j for j, cj in enumerate(poly)),
                scale)
    if isinstance(k, RQ):
        a = _scalar(k, "alpha")
        return FAMILY_RQ, 0, (sigma / (2 * a), -a), scale
    if isinstance(k, Cauchy):
        return FAMILY_CAUCHY, 0, (sigma,), scale
    if isinstance(k, InverseMultiQuadratic):
        return FAMILY_IMQ, 0, (sigma, _scalar(k, "c") ** 2), scale
    if isinstance(k, Matern):
        nu = _scalar(k, "nu")
        if nu > MATERN_TABLE_MAX_NU:
            return None
        t = matern_nu_table(nu, False)
        return (FAMILY_MATERN_NU, 0,
                _split(math.sqrt(2 * nu * sigma)) + (t[6] / sigma, t[4] * sigma,
                                                      t[5] * sigma * sigma, matern_nu_small(nu),
                                                      2 * nu, float(matern_nu_octave(nu)), nu),
                scale)
    return None


def _jet_family(k):
    """(family, p, table, 1.0) of a one-leaf derivative spec, or None. The
    Constant and the lengthscales are folded into the table (sigma = the
    product of 1/l^2, scale = the Constant):
      EQ       c0 + c1 = -sigma / (2 ln 2) (split), c2 = -scale sigma / 2,
               c3 = scale sigma^2 / 4: e = exp2(s (c0 + c1)), f' = c2 e,
               f'' = c3 e;
      MaternP  c0 = sigma, c1 = scale sigma, c2 = scale sigma^2, then
               `_maternp_jet_table(p)` (p = 1..3): f' = c1 g'(c0 s),
               f'' = c2 g''(c0 s);
      RQ       c0 = sigma / (2 alpha), c1 = -alpha, c2 = -scale alpha c0,
               c3 = scale alpha (alpha + 1) c0^2: b = 1 + c0 s,
               f' = c2 b^c1 / b, f'' = c3 b^c1 / b^2;
      Cauchy   c0 = sigma, c1 = -scale sigma, c2 = 2 scale sigma^2:
               r = 1 / (1 + c0 s), f' = c1 r^2, f'' = c2 r^3;
      IMQ      c0 = sigma, c1 = c^2, c2 = -scale sigma / 2,
               c3 = 3 scale sigma^2 / 4: r = (c0 s + c1)^(-1/2), f' = c2 r^3,
               f'' = c3 r^5;
      Matern   real nu, 1 < nu <= MATERN_TABLE_MAX_NU: c0 + c1 = sqrt(2 nu
               sigma) (split), c2 = the Taylor bound / sigma, c3 = scale
               sigma t1, c4 = 2 scale sigma^2 t2 (`matern_nu_jet_taylor`),
               c5 = -scale sigma, c6 = scale sigma^2, c7 = e_lo
               (`matern_nu_jet_octave`), c8 = nu: with x = sqrt(2 nu sigma
               s), f' = c5 T1(x), f'' = c6 T2(x) from the two tables of
               `matern_nu_jet_knots` (T1 = -f', T2 = f'' of Matern(nu)'s
               profile in x), below the table or c2 f' = c3 + c4 s,
               f'' = c4."""
    k, sigma, scale = _leaf(k)
    if isinstance(k, EQ):
        return (FAMILY_EQ, 0, _split(-sigma / (2 * math.log(2.0)))
                + (-scale * sigma / 2, scale * sigma * sigma / 4), 1.0)
    if isinstance(k, MaternP) and 1 <= k.p <= FAMILY_MAX_P:
        return (FAMILY_MATERN, k.p, (sigma, scale * sigma, scale * sigma * sigma)
                + _maternp_jet_table(k.p), 1.0)
    if isinstance(k, RQ):
        a = _scalar(k, "alpha")
        c0 = sigma / (2 * a)
        return FAMILY_RQ, 0, (c0, -a, -scale * a * c0, scale * a * (a + 1) * c0 * c0), 1.0
    if isinstance(k, Cauchy):
        return FAMILY_CAUCHY, 0, (sigma, -scale * sigma, 2 * scale * sigma * sigma), 1.0
    if isinstance(k, InverseMultiQuadratic):
        return (FAMILY_IMQ, 0, (sigma, _scalar(k, "c") ** 2, -scale * sigma / 2,
                                0.75 * scale * sigma * sigma), 1.0)
    if isinstance(k, Matern):
        nu = _scalar(k, "nu")
        if not 1 < nu <= MATERN_TABLE_MAX_NU:
            return None
        t1, t2, bound = matern_nu_jet_taylor(nu)
        return (FAMILY_MATERN_NU, 0,
                _split(math.sqrt(2 * nu * sigma)) + (bound / sigma, scale * sigma * t1,
                                                      2 * scale * sigma * sigma * t2,
                                                      -scale * sigma, scale * sigma * sigma,
                                                      float(matern_nu_jet_octave(nu)), nu),
                1.0)
    return None


def to_spec(k, derivative: bool = False):
    """(ProfileSpec, None) for a covered iso/dot kernel, else (None, reason).
    derivative=True compiles `k.profile` for `evaluate_jet` and the
    gradient-block kernel, and declines profiles whose f' or f'' is not
    finite at s = 0."""
    trait = getattr(k, "trait", None)
    if trait not in (InputTrait.ISOTROPIC, InputTrait.DOT):
        return None, f"trait {getattr(trait, 'value', trait)!r} has no scalar profile spec"
    b = _Builder()
    try:
        _emit(k, b, lambda: b.emit(PUSH_S), derivative)
    except _Decline as e:
        return None, str(e)
    fam = None if trait != InputTrait.ISOTROPIC else (_jet_family(k) if derivative
                                                     else _family(k))
    spec = ProfileSpec("iso" if trait == InputTrait.ISOTROPIC else "dot",
                       tuple(b.ops), tuple(b.args), tuple(b.consts), derivative,
                       *(fam or ()))
    if len(spec.ops) > MAX_OPS or len(spec.consts) > MAX_CONSTS:
        return None, (f"profile program too long ({len(spec.ops)} ops, "
                      f"{len(spec.consts)} constants; limits {MAX_OPS}, {MAX_CONSTS})")
    if spec.depth > MAX_STACK:
        return None, f"profile program needs stack depth {spec.depth} > {MAX_STACK}"
    return spec, None
