"""Profile specs: a kernel's value profile as data a CUDA kernel can read.

cfjax's Pallas kernels take the profile as a jnp closure that Mosaic bakes
into the compiled kernel (`cfjax/ops/pallas_mvm.py:195,278`). A CUDA
kernel built once from fixed sources cannot take a closure, so the port
turns `profile_value` of an isotropic or dot-product kernel into a short
postfix program: opcodes, one integer argument each, and a table of float
constants. The CUDA kernels (`csrc/gramian_mvm.cu`) interpret it per
element with a small register stack; every thread runs the same opcode
sequence, so warps never diverge on it.

Covered: EQ, Exp, GammaExp, MaternP(p), RQ, Cauchy, IMQ, Constant, Dot and
ExponentialDot, closed under Sum, Product, Power, Lengthscale and Constant
scaling. `to_spec(k)` returns `(spec, None)` or `(None, reason)`.
`ProfileSpec.evaluate` is the plain torch evaluator of a program; it
agrees with `k.profile_value` op for op.
"""

from __future__ import annotations

import dataclasses

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
    MaternP,
)
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

MAX_OPS = 64
MAX_CONSTS = 64
MAX_STACK = 8

_POP = {PUSH_S: -1, PUSH_C: -1, ADD: 1, MUL: 1, DIV: 1, POWC: 0, POWI: 0,
        NEG: 0, EXP: 0, SQRT: 0, ROOT: 0, MATERNP: 0}


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """A postfix program over one scalar argument s."""

    mode: str          # "iso" (s = ||x - y||^2) or "dot" (s = <x, y>)
    ops: tuple
    args: tuple
    consts: tuple

    @property
    def depth(self) -> int:
        d = top = 0
        for op in self.ops:
            d -= _POP[op]
            top = max(top, d)
        return top

    def evaluate(self, s):
        """Plain torch evaluator of the program (elementwise over s)."""
        s = torch.as_tensor(s)
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
            else:
                raise ValueError(f"unknown opcode {op}")
        (out,) = st
        return out * torch.ones_like(s)


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


def _emit(k, b: _Builder, push_s):
    if isinstance(k, Constant):
        b.push(_scalar(k, "c"))
    elif isinstance(k, EQ):                      # exp(-s / 2)
        push_s()
        b.emit(NEG)
        b.push(2.0)
        b.emit(DIV)
        b.emit(EXP)
    elif isinstance(k, Exp):                     # exp(-root(s))
        push_s()
        b.emit(ROOT)
        b.emit(NEG)
        b.emit(EXP)
    elif isinstance(k, GammaExp):                # exp(-(s ** (g/2)) / 2)
        push_s()
        b.emit(POWC, b.const(k.gamma / 2))
        b.emit(NEG)
        b.push(2.0)
        b.emit(DIV)
        b.emit(EXP)
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
            _emit(a, b, push_s)
            if i:
                b.emit(op)
    elif isinstance(k, Power):
        _emit(k.k, b, push_s)
        b.emit(POWI, int(k.p))
    elif isinstance(k, Lengthscale):             # k(s / l^2)
        l = _scalar(k, "l")

        def push_scaled():
            push_s()
            b.push(l * l)
            b.emit(DIV)

        _emit(k.k, b, push_scaled)
    elif type(k).__name__ == "_EmbeddedPeriodic":
        _emit(k.k, b, push_s)
    else:
        raise _Decline(f"{type(k).__name__} has no profile spec")


def to_spec(k):
    """(ProfileSpec, None) for a covered iso/dot kernel, else (None, reason)."""
    trait = getattr(k, "trait", None)
    if trait not in (InputTrait.ISOTROPIC, InputTrait.DOT):
        return None, f"trait {getattr(trait, 'value', trait)!r} has no scalar profile spec"
    b = _Builder()
    try:
        _emit(k, b, lambda: b.emit(PUSH_S))
    except _Decline as e:
        return None, str(e)
    spec = ProfileSpec("iso" if trait == InputTrait.ISOTROPIC else "dot",
                       tuple(b.ops), tuple(b.args), tuple(b.consts))
    if len(spec.ops) > MAX_OPS or len(spec.consts) > MAX_CONSTS:
        return None, (f"profile program too long ({len(spec.ops)} ops, "
                      f"{len(spec.consts)} constants; limits {MAX_OPS}, {MAX_CONSTS})")
    if spec.depth > MAX_STACK:
        return None, f"profile program needs stack depth {spec.depth} > {MAX_STACK}"
    return spec, None
